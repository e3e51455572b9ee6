"""The port's training steps on a mesh (parallel/train_mesh.py) against
the JAX package's single-device gradients, on the CPU at TINY_TEST.

One spawn of 4 gloo processes (tests/torch_sp_workers.py) runs, on a
(2, 1, 2) mesh (batch on data, tokens on sp) and on a (1, 2, 2) one
(parameters on fsdp, every one with a divisible dimension sharded by
FSDP2: min_size 1), one step each of distill, APT D and G, f-distill and
omni, fp32 parameters and compute. The latents give 9 tokens (27 packed
omni tokens), so sp 2 pads them to 10 (28), where the single-device
runs use 9 (27). Held, for each step: the loss and the whole gradient of
every parameter (the Recorder optimizer gathers the shards) and
`global_norm` of the sharded gradients on the mesh.

The yardstick is the JAX step on one device with an optimizer that keeps
the gradients it is given as its state (`_capture`): distill
(`distill_train_step`), f-distill (`f_distill_train_step`, whose
discriminator then stays as it was on both sides) and omni
(`omni_train_step`, the port fed JAX's draws). The APT steps draw from a
`torch.Generator`, so their yardstick is the port's single-process step
on the same draws (tests/test_torch_apt.py holds that one to JAX), at
the meshes' padded length, since the probes attend over every token.

Tolerance: rtol 1e-4 on losses and norms; gradients within rtol 1e-4
plus 1e-4 of the step's largest gradient element (fp32: the ring merges
its hops in another order than one softmax, and the mesh sums the ranks'
gradients; a gradient that is 0 in exact arithmetic, such as a norm
bias before a softmax, comes out as rounding noise on both sides).

The (1, 2, 2) run also writes its distill state through CheckpointManager
(rank 0 writes whole tensors) and restores a single-process checkpoint
into sharded state: the file restores in this process to the mesh's
state, bit for bit, and the mesh's restore equals the file."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from omnihuman_tpu.apt import distill as jd
from omnihuman_tpu.apt import f_distill as jfd
from omnihuman_tpu.configs.wan import DTypePolicy as JaxPolicy
from omnihuman_tpu.configs.wan import TINY_TEST as JAX_TINY
from omnihuman_tpu.configs.wan import WanModelConfig as JaxWanCfg
from omnihuman_tpu.omni import trainer as jax_trainer
from omnihuman_tpu.omni.model import OmniModelConfig as JaxOmniCfg
from omnihuman_tpu.omni.model import init_omni_model
from omnihuman_tpu.ops.rope import rope_angles_3d as jax_rope
from omnihuman_tpu.utils.convert import convert_wan_dit
from omnihuman_tpu_torch.apt import apt_trainer as tr
from omnihuman_tpu_torch.apt.distill import (
    distill_train_step, init_distill_state, make_optimizer)
from omnihuman_tpu_torch.apt.generate import latent_rope
from omnihuman_tpu_torch.apt.model import init_apt_discriminator
from omnihuman_tpu_torch.configs.wan import (
    TINY_TEST, DTypePolicy, WanModelConfig)
from omnihuman_tpu_torch.models.wan_dit import build_wan_model
from omnihuman_tpu_torch.omni.model import OmniModelConfig
from omnihuman_tpu_torch.omni.trainer import MASKED_CONDITIONS
from omnihuman_tpu_torch.utils.checkpoint import CheckpointManager
from omnihuman_tpu_torch.utils.convert import (
    mlp_discriminator_state_dict_from_jax, omni_state_dict_from_jax,
    wan_dit_state_dict_from_jax)
from torch_sp_workers import Ranks, Recorder, _wan

torch.set_num_threads(1)

CFG = TINY_TEST.model
LATENT = (2, 16, 1, 6, 6)          # grid (1, 3, 3): 9 tokens
GRID, SEQ = (1, 3, 3), 9
FEAT = 512
FD_KW = dict(f_divergence="jensen-shannon", cfg_scale=7.5, alpha=0.1,
             beta=0.9, t_max=1000.0)
OBASE = dict(dim=32, ffn_dim=64, num_heads=4, num_layers=2, freq_dim=16,
             text_dim=24, text_len=8)
JOCFG = JaxOmniCfg(base=JaxWanCfg(**OBASE), audio_dim=20, num_keypoints=8,
                   num_frames=8)
POCFG = OmniModelConfig(base=WanModelConfig(**OBASE), audio_dim=20,
                        num_keypoints=8, num_frames=8)
OSHAPE = (2, 16, 2, 6, 6)          # 18 video + 9 reference tokens
RATIOS = {"text": 1.0, "reference": 0.5, "audio": 0.5, "pose": 0.5}
JF32 = JaxPolicy(compute=jnp.float32)
PF32 = DTypePolicy(compute=torch.float32)
TOL = 1e-4
OMNI_KEY = 5


def _compiled(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options={
        "xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True})(*args)


def _capture():
    """An optax transform whose state is the last gradients it saw (its
    updates are zero)."""
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda grads, state, params=None: (
            jax.tree.map(jnp.zeros_like, grads), grads))


def _wan_params(seed):
    """The port's reference init with a random head, in JAX's layout."""
    model = build_wan_model(CFG, "cpu", torch.float32, seed=seed)
    params = jax.tree.map(np.asarray, convert_wan_dit(
        {k: v.numpy() for k, v in model.state_dict().items()},
        JAX_TINY.model))
    rng = np.random.default_rng(seed + 11)
    params["head"]["w"] = (rng.normal(size=params["head"]["w"].shape)
                           * 0.1).astype(np.float32)
    return params


def _payload(tmp):
    rng = np.random.default_rng(0)

    def rnd(*shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    ctx = lambda: rnd(2, CFG.text_len, CFG.text_dim, scale=0.5)
    student, teacher = _wan_params(1), _wan_params(0)
    d_params = {name: {"w": rnd(i, o, scale=(2.0 / i) ** 0.5),
                       "b": rnd(o, scale=0.1)}
                for name, i, o in (("fc1", FEAT, 256), ("fc2", 256, 128),
                                   ("fc3", 128, 1))}
    oparams = jax.tree.map(np.asarray, jax.jit(
        lambda k: init_omni_model(k, JOCFG))(jax.random.key(0)))
    base, cond = oparams["base"], oparams["cond"]
    base["head"]["w"] = rnd(*base["head"]["w"].shape, scale=0.1)
    ad = base["blocks"]["audio_attn"]
    ad["o"]["w"] = rnd(*ad["o"]["w"].shape, scale=0.2)
    ad["gate"] = 1.0 + rnd(*ad["gate"].shape, scale=0.3)
    cond["pose_proj"]["w"] = rnd(*cond["pose_proj"]["w"].shape, scale=0.2)
    b, c, f, h, w = OSHAPE
    obatch = {"frames": rnd(*OSHAPE), "context": rnd(b, 8, 24),
              "audio": rnd(b, 4, 20),
              "pose": rnd(b, 8, f, 2 * h, 2 * w, scale=0.1),
              "reference": rnd(b, c, 1, h, w)}
    sd = lambda params: {k: v.contiguous() for k, v in
                         wan_dit_state_dict_from_jax(params, CFG).items()}
    return {
        "student": student, "teacher": teacher, "d_params": d_params,
        "oparams": oparams,
        "wan_sd": sd(student), "teacher_sd": sd(teacher),
        "distill_batch": {"noise": rnd(*LATENT), "context": ctx(),
                          "v_teacher": rnd(*LATENT)},
        "apt_batch": {"real": rnd(*LATENT), "noise": rnd(*LATENT),
                      "context": ctx()},
        "fd_batch": {"noise": rnd(*LATENT), "context": ctx(),
                     "context_null": ctx()},
        "feat": FEAT, "fd_kw": FD_KW,
        "mlp_sd": mlp_discriminator_state_dict_from_jax(d_params),
        "omni": {"cfg": POCFG, "batch": obatch,
                 "sd": omni_state_dict_from_jax(oparams, POCFG)},
        "ckpt_in": str(tmp / "ckpt_in"), "ckpt_out": str(tmp / "ckpt_out"),
    }


@jax.jit
def _omni_draws(key):
    b = OSHAPE[0]
    k_mask, k_t, k_noise = jax.random.split(key, 3)
    masks = {name: (jax.random.uniform(jax.random.fold_in(k_mask, i), (b,))
                    < RATIOS[name]).astype(jnp.float32)
             for i, name in enumerate(MASKED_CONDITIONS)}
    t = jax.random.uniform(k_t, (b,), minval=1e-4, maxval=1.0 - 1e-4)
    return masks, t, jax.random.normal(k_noise, OSHAPE)


def _jax_results(p):
    """Loss, grad norm and gradients (port names) of the JAX steps."""
    sin, cos = jax_rope(GRID, CFG.head_dim, seq_len=SEQ)
    cap = _capture()
    out = {}
    dstep = functools.partial(
        jd.distill_train_step, optimizer=cap, cfg=JAX_TINY.model,
        seq_len=SEQ, rope_sin=sin, rope_cos=cos, policy=JF32, remat=False)
    st, m = _compiled(lambda pr, b: dstep(jd.init_distill_state(pr, cap), b),
                      p["student"], p["distill_batch"])
    out["distill"] = dict(loss=float(m["loss"]),
                          grad_norm=float(m["grad_norm"]),
                          grads=wan_dit_state_dict_from_jax(
                              jax.tree.map(np.asarray, st.opt_state), CFG))

    fstep = functools.partial(
        jfd.f_distill_train_step, optimizer=cap, d_optimizer=cap,
        cfg=JAX_TINY.model, seq_len=SEQ, rope_sin=sin, rope_cos=cos,
        policy=JF32, feature_fn=functools.partial(jfd.default_feature_fn,
                                                  dim=FEAT), **FD_KW)
    st, m = _compiled(
        lambda s, t, d, b: fstep(jfd.init_f_distill_state(s, d, cap, cap),
                                 t, b),
        p["student"], p["teacher"], p["d_params"], p["fd_batch"])
    out["f_distill"] = dict(
        {k: float(v) for k, v in m.items()},
        grads=wan_dit_state_dict_from_jax(
            jax.tree.map(np.asarray, st.opt_state), CFG),
        d_grads=mlp_discriminator_state_dict_from_jax(
            jax.tree.map(np.asarray, st.d_opt_state)))

    def ostep(params, batch, key):
        state = jax_trainer.OmniTrainState(
            params=params, opt_state=cap.init(params),
            step=jnp.asarray(0, jnp.int32))
        return jax_trainer.omni_train_step(
            state, batch, RATIOS, key, optimizer=cap, cfg=JOCFG,
            policy=JF32, remat=False)
    st, m = _compiled(ostep, p["oparams"], p["omni"]["batch"],
                      jax.random.key(OMNI_KEY))
    out["omni"] = dict(loss=float(m["loss"]),
                       grad_norm=float(m["grad_norm"]),
                       grads=omni_state_dict_from_jax(
                           jax.tree.map(np.asarray, st.opt_state), POCFG))
    return out


def _apt_results(p):
    """The port's single-process APT D and G steps on the same draws, at
    the meshes' padded length (10): the probes read every token, padding
    included, in JAX as in the port."""
    f32 = {k: torch.from_numpy(v) for k, v in p["apt_batch"].items()}
    disc = init_apt_discriminator(_wan(p["teacher_sd"], trainable=False),
                                  torch.Generator().manual_seed(7))
    g_rec, d_rec = Recorder(), Recorder()
    state = tr.init_apt_state(_wan(p["wan_sd"]), disc, 5e-6, 5e-6)
    kw = dict(apt_cfg=tr.SeaweedAPTConfig(), video=False, policy=PF32,
              **latent_rope(CFG, LATENT, "cpu", sp=2))
    state, dm = tr.apt_d_step(state, f32, torch.Generator().manual_seed(11),
                              d_optimizer=d_rec, **kw)
    state, gm = tr.apt_g_step(state, f32, torch.Generator().manual_seed(12),
                              g_optimizer=g_rec, **kw)
    return {"apt_d": dict({k: float(v) for k, v in dm.items()},
                          grads=d_rec.grads, grad_norm=float(d_rec.norm)),
            "apt_g": dict({k: float(v) for k, v in gm.items()},
                          grads=g_rec.grads, grad_norm=float(g_rec.norm))}


def _write_single_checkpoint(p):
    """A single-process distill state after one real step, saved."""
    model = _wan(p["wan_sd"])
    opt = make_optimizer()
    state = init_distill_state(model, opt)
    batch = {k: torch.from_numpy(v) for k, v in p["distill_batch"].items()}
    state, _ = distill_train_step(state, batch, optimizer=opt, policy=PF32,
                                  **latent_rope(CFG, LATENT, "cpu"))
    CheckpointManager(p["ckpt_in"]).save(1, state)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sp_train")
    p = _payload(tmp)
    _write_single_checkpoint(p)
    # JAX's omni draws for the key its step gets, before the ranks start
    masks, t, noise = _omni_draws(jax.random.key(OMNI_KEY))
    p["omni"]["draws"] = {"t": np.asarray(t), "noise": np.asarray(noise),
                          **{k: np.asarray(v) for k, v in masks.items()}}
    ranks = Ranks(4, "train_steps", p, tmp)
    want = _jax_results(p)
    want.update(_apt_results(p))
    return ranks.results(), want, p


STEPS = ("distill", "apt_d", "apt_g", "f_distill", "omni")
LOSS = {"distill": "loss", "apt_d": "d_total", "apt_g": "g_loss",
        "f_distill": "loss", "omni": "loss"}


def _close_grads(got, want, what):
    assert set(got) == set(want), what
    scale = max(float(np.abs(np.asarray(w)).max()) for w in want.values())
    for n, w in want.items():
        g = got[n].float().numpy()
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape, (what, n)
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL * scale,
                                   err_msg=f"{what}/{n}")


@pytest.mark.parametrize("mesh", ["data", "fsdp"])
@pytest.mark.parametrize("step", STEPS)
def test_mesh_step_matches_the_single_device_gradients(runs, mesh, step):
    ranks, want, _ = runs
    got = ranks[0][mesh][step]
    w = want[step]
    loss = LOSS[step]
    np.testing.assert_allclose(got[loss], w[loss], rtol=TOL)
    for r in ranks[1:]:            # every rank reports the global loss
        np.testing.assert_allclose(r[mesh][step][loss], got[loss],
                                   rtol=1e-6)
    if "grad_norm" in w:
        np.testing.assert_allclose(got["norm"], w["grad_norm"], rtol=TOL)
    if "grad_norm" in got:
        np.testing.assert_allclose(got["grad_norm"], w["grad_norm"],
                                   rtol=TOL)
    _close_grads(got["grads"], w["grads"], f"{mesh}/{step}")
    if step == "f_distill":
        for k in ("f_div_loss", "g_loss", "d_loss", "density_ratio_mean",
                  "weight_mean"):
            np.testing.assert_allclose(got[k], w[k], rtol=TOL, err_msg=k)
        _close_grads(got["d_grads"], w["d_grads"], f"{mesh}/disc")
    # every rank holds the same whole gradients
    for r in ranks[1:]:
        for n, g in r[mesh][step]["grads"].items():
            torch.testing.assert_close(g, got["grads"][n], rtol=0, atol=0)


def test_meshes_pad_and_shard(runs):
    """sp 2 pads the 9 tokens to 10; min_size 1 shards the DiT on fsdp 2
    and leaves it whole on fsdp 1."""
    ranks, _, _ = runs
    assert ranks[0]["data"]["seq_len"] == 10
    assert ranks[0]["fsdp"]["dtensors"] > 0
    assert ranks[0]["data"]["dtensors"] > 0     # FSDP2 over one rank


def _equal_trees(a, b, where=""):
    if isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            _equal_trees(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), where
    else:
        assert a == b, where


def test_checkpoints_cross_between_mesh_and_one_process(runs):
    ranks, _, p = runs
    res = ranks[0]["fsdp"]
    # written on (1, 2, 2) by rank 0, read back here whole
    mgr = CheckpointManager(p["ckpt_out"])
    assert mgr.all_steps() == [1]
    _equal_trees(mgr.restore(1), res["state"])
    fresh = init_distill_state(_wan(p["wan_sd"]), make_optimizer())
    mgr.restore(target=fresh)
    _equal_trees({"params": {n: t.detach() for n, t in
                             fresh.state_dict()["params"].items()},
                  **{k: v for k, v in fresh.state_dict().items()
                     if k != "params"}}, res["state"])
    # written here, restored into sharded state on the mesh
    assert res["restored_dtensor"]
    _equal_trees(res["restored"], CheckpointManager(p["ckpt_in"]).restore())
    for r in ranks[1:]:
        _equal_trees(r["fsdp"]["restored"], res["restored"])
