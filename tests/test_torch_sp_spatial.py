"""The port's spatial sharding through real collectives: one spawn of 4
gloo processes (tests/torch_sp_workers.py, `spatial_cases`) against the
in-process virtual ranks and the JAX package, on the CPU.

- `halo_exchange` and `gather_spatial` over the world group, forward and
  backward (the halo's gradient sent back to its owner and added; the
  gather's backward a reduce-scatter): bit-equal to `VirtualRanks`.
- The W-sharded VAE decode (latent width 10: shards of 3, 3, 2, 2
  columns) and encode over 4 ranks, conv_impl "torch" and "plain":
  bit-equal to the virtual ranks' run in this process.
- An omni training step on a (1, 2, 2) mesh with the pose heatmaps
  H-sharded over sp (H 16: 8 rows a rank, `put_batch`), every condition
  on, fp32, against JAX's single-device `omni_train_step`: the loss and
  grad norm within rtol 1e-4, every gradient within rtol 1e-4 plus 1e-4
  of the step's largest (tests/test_torch_sp_train.py's tolerance).
- `cli.generate --one_step --sp_size 2 --fsdp_size 2` (the ring, FSDP2,
  and the decode W-sharded over the 4 ranks) on a checkpoint directory
  both packages read, JAX's noise and context patched in: its latents
  against JAX's `SeaweedWanAPTGenerator` on its (2, 2, 2) mesh
  (tests/test_mesh_pipeline.py:124 holds JAX's to its unsharded
  latents), bf16 on both sides, relative L2 under 2e-2; its video equal,
  bit for bit, to the virtual ranks' W-sharded decode of those latents
  with the directory's VAE in this process; only rank 0 writes.
- int8 with fsdp 2: the quantised DiT sharded by FSDP2 (w_q and w_s on the
  dimension JAX's rule gives its int8 leaves) equals the same model whole,
  bit for bit; `cli.generate` and `cli.omni_inference --precision int8
  --fsdp_size 2` run.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from omnihuman_tpu.configs.wan import DTypePolicy as JaxPolicy
from omnihuman_tpu.configs.wan import TINY_TEST as JAX_TINY
from omnihuman_tpu.configs.wan import VAEConfig as JaxVAEConfig
from omnihuman_tpu.configs.wan import WanModelConfig as JaxWanCfg
from omnihuman_tpu.models.vae import init_vae
from omnihuman_tpu.models.wan_dit import init_wan_model
from omnihuman_tpu.omni import trainer as jax_trainer
from omnihuman_tpu.omni.model import OmniModelConfig as JaxOmniCfg
from omnihuman_tpu.omni.model import init_omni_model
from omnihuman_tpu.ops.quant import quantize_wan_params
from omnihuman_tpu.parallel import MeshConfig as JaxMeshConfig
from omnihuman_tpu.parallel import create_mesh as jax_create_mesh
from omnihuman_tpu.parallel import infer_param_specs as jax_specs
from omnihuman_tpu.pipelines.text2video import WanT2V as JaxWanT2V
from omnihuman_tpu.pipelines.wan_inference import (
    SeaweedWanAPTGenerator as JaxOneStep)
from omnihuman_tpu_torch.configs.wan import (
    TINY_TEST, VAEConfig, WanModelConfig)
from omnihuman_tpu_torch.models.vae import build_vae, vae_decode, vae_encode
from omnihuman_tpu_torch.models.wan_dit import build_wan_model
from omnihuman_tpu_torch.omni.model import OmniModelConfig
from omnihuman_tpu_torch.omni.trainer import MASKED_CONDITIONS
from omnihuman_tpu_torch.ops.quant import quantize_wan_model
from omnihuman_tpu_torch.parallel import infer_param_specs
from omnihuman_tpu_torch.parallel.spatial import (
    VirtualRanks, halo_exchange, shard_bounds)
from omnihuman_tpu_torch.utils.convert import (
    omni_state_dict_from_jax, vae_state_dict_from_jax)
from torch_sp_workers import Ranks

torch.set_num_threads(1)

VAE_KW = dict(base_dim=8, z_dim=16, dim_mult=(1, 1, 1, 1), num_res_blocks=1,
              temporal_downsample=(False, True, True))
OBASE = dict(dim=32, ffn_dim=64, num_heads=4, num_layers=2, freq_dim=16,
             text_dim=24, text_len=8)
JOCFG = JaxOmniCfg(base=JaxWanCfg(**OBASE), audio_dim=20, num_keypoints=8,
                   num_frames=8)
POCFG = OmniModelConfig(base=WanModelConfig(**OBASE), audio_dim=20,
                        num_keypoints=8, num_frames=8)
OSHAPE = (2, 16, 1, 8, 4)          # 8 video + 8 reference tokens
RATIOS = {"text": 1.0, "reference": 1.0, "audio": 1.0, "pose": 1.0}
OMNI_KEY = 9
TOL = 1e-4
ONE_STEP = dict(size=(32, 32), frame_num=5, seed=7)


def _t(a):
    return torch.from_numpy(np.array(a))


def _compiled(fn, *args):
    """fn(*args) as one program compiled without XLA's costly passes (the
    random init compiles in a third of the time)."""
    return jax.jit(fn).lower(*args).compile(compiler_options={
        "xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True})(*args)


def _write_dir(d):
    """A reference-layout checkpoint directory both packages load (the
    DiT with a random head, the VAE; fp32 files)."""
    from safetensors.torch import save_file
    model = build_wan_model(TINY_TEST.model, "cpu", torch.float32, seed=0)
    with torch.no_grad():
        model.head.head.weight.normal_(
            0.0, 0.1, generator=torch.Generator().manual_seed(1))
    save_file(model.state_dict(),
              str(d / "diffusion_pytorch_model.safetensors"))
    vae = build_vae(TINY_TEST.vae, "cpu", torch.float32, seed=3)
    torch.save(vae.state_dict(), str(d / "Wan2.1_VAE.pth"))
    return {k: v.clone() for k, v in model.state_dict().items()}


def _random_omni_params(rng):
    """JAX omni params of JOCFG's shapes (`init_omni_model` traced, not
    compiled), filled from `rng`: weights scaled by 1/sqrt(fan-in), norm
    scales and gates near 1, biases and the rest small."""
    shapes = jax.eval_shape(lambda: init_omni_model(jax.random.key(0),
                                                    JOCFG))

    def fill(path, leaf):
        keys = [getattr(k, "key", str(k)) for k in path]
        shape, name = leaf.shape, keys[-1]
        x = rng.normal(size=shape)
        if name == "w" and len(shape) >= 2 and "norm" not in keys[-2]:
            lead = 1 if keys[0] == "base" and "blocks" in keys else 0
            x = x * float(np.prod(shape[lead:-1])) ** -0.5
        elif name in ("gamma", "gate") or (name == "w" and "norm" in keys[-2]):
            x = 1.0 + 0.2 * x
        else:
            x = 0.1 * x
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _omni_payload(rng):
    def rnd(*shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    params = _random_omni_params(rng)
    b, c, f, h, w = OSHAPE
    batch = {"frames": rnd(*OSHAPE), "context": rnd(b, 8, 24),
             "audio": rnd(b, 4, 20),
             "pose": rnd(b, 8, f, 2 * h, 2 * w, scale=0.3),
             "reference": rnd(b, c, 1, h, w)}

    @jax.jit
    def draws(key):
        k_mask, k_t, k_noise = jax.random.split(key, 3)
        masks = {n: (jax.random.uniform(jax.random.fold_in(k_mask, i), (b,))
                     < RATIOS[n]).astype(jnp.float32)
                 for i, n in enumerate(MASKED_CONDITIONS)}
        t = jax.random.uniform(k_t, (b,), minval=1e-4, maxval=1.0 - 1e-4)
        return masks, t, jax.random.normal(k_noise, OSHAPE)

    masks, t, noise = draws(jax.random.key(OMNI_KEY))
    return params, {
        "cfg": POCFG, "batch": batch,
        "sd": omni_state_dict_from_jax(params, POCFG),
        "draws": {"t": np.asarray(t), "noise": np.asarray(noise),
                  **{k: np.asarray(v) for k, v in masks.items()}}}


def _jax_omni(params, batch):
    cap = optax.GradientTransformation(
        lambda prm: jax.tree.map(jnp.zeros_like, prm),
        lambda g, s, prm=None: (jax.tree.map(jnp.zeros_like, g), g))

    def step(prm, bt, key):
        state = jax_trainer.OmniTrainState(
            params=prm, opt_state=cap.init(prm),
            step=jnp.asarray(0, jnp.int32))
        return jax_trainer.omni_train_step(
            state, bt, RATIOS, key, optimizer=cap, cfg=JOCFG,
            policy=JaxPolicy(compute=jnp.float32), remat=False)

    st, m = _compiled(step, params, batch, jax.random.key(OMNI_KEY))
    return dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                grads=omni_state_dict_from_jax(
                    jax.tree.map(np.asarray, st.opt_state), POCFG))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from PIL import Image
    tmp = tmp_path_factory.mktemp("sp_spatial")
    rng = np.random.default_rng(0)
    ckpt = tmp / "ckpt"
    ckpt.mkdir()
    wan_sd = _write_dir(ckpt)
    Image.fromarray(rng.integers(0, 255, (32, 32, 3), dtype=np.uint8)
                    ).save(tmp / "ref.png")
    vparams = jax.tree.map(np.asarray, _compiled(
        lambda k: init_vae(k, JaxVAEConfig(**VAE_KW)), jax.random.key(1)))
    for part in ("encoder", "decoder"):
        for layer in vparams[part]:
            if "proj" in layer:
                layer["proj"]["w"] = (rng.normal(size=layer["proj"]["w"].shape)
                                      * 0.2).astype(np.float32)
    vcfg = VAEConfig(**VAE_KW)
    oparams, omni = _omni_payload(rng)
    lat = (1, 16, 2, 4, 4)
    one_noise = np.asarray(jax.vmap(
        lambda k: jax.random.normal(k, lat[1:], jnp.float32))(
        jax.vmap(jax.random.fold_in, (None, 0))(
            jax.random.key(ONE_STEP["seed"]), jnp.arange(1))))
    payload = {
        "x": rng.normal(size=(2, 3, 2, 4, 10)).astype(np.float32),
        "halo_w": [rng.normal(size=(2, 3, 2, 4, e - s + 2)).astype(
            np.float32) for s, e in shard_bounds(10, 4)],
        "gather_w": rng.normal(size=(2, 3, 2, 4, 10)).astype(np.float32),
        "vae_cfg": vcfg, "vae_sd": vae_state_dict_from_jax(vparams, vcfg),
        "z": rng.normal(size=(1, 16, 3, 8, 10)).astype(np.float32),
        "vid": (rng.normal(size=(1, 3, 5, 32, 80)) * 0.3).astype(np.float32),
        "omni": omni, "wan_sd": wan_sd,
        "int8_in": {"x": rng.normal(size=(2, 16, 2, 8, 8)).astype(np.float32),
                    "t": np.array([700.0, 30.0], np.float32),
                    "ctx": rng.normal(size=(2, 16, 32)).astype(np.float32)},
        "ckpt": str(ckpt), "out_dir": str(tmp), "image": str(tmp / "ref.png"),
        "one_step_noise": one_noise,
        "one_step_ctx": (rng.normal(size=(1, 16, 32)) * 0.5).astype(
            np.float32)}
    ranks = Ranks(4, "spatial", payload, tmp)
    jpipe = JaxWanT2V(JAX_TINY, checkpoint_dir=str(ckpt),
                      mesh=jax_create_mesh(JaxMeshConfig(2, 2, 2)))
    want_latents = np.asarray(JaxOneStep(jpipe).generate(
        "x", context=jnp.asarray(payload["one_step_ctx"]),
        return_latents=True, **ONE_STEP))
    want_omni = _jax_omni(oparams, omni["batch"])
    return payload, ranks.results(), want_latents, want_omni


def test_halo_and_gather_through_gloo_equal_the_virtual_ranks(runs):
    p, ranks, _, _ = runs
    x = _t(p["x"])
    bounds = shard_bounds(10, 4)
    leaf = x.clone().requires_grad_(True)
    halos = VirtualRanks(4).run(
        lambda g, s, e: halo_exchange(leaf[..., s:e], 4, 1, 1, g), bounds)
    sum((h * _t(w)).sum() for h, w in zip(halos, p["halo_w"])).backward()
    for r, (s, e) in enumerate(bounds):
        y, gx = ranks[r]["halo"]
        torch.testing.assert_close(y, halos[r].detach(), rtol=0, atol=0)
        torch.testing.assert_close(gx, leaf.grad[..., s:e], rtol=0,
                                   atol=1e-6)
        g, gg = ranks[r]["gather"]
        torch.testing.assert_close(g, x, rtol=0, atol=0)
        # every rank's loss reads the whole gathered tensor: the sum over
        # the 4 ranks of the same weights, this rank's columns of it
        torch.testing.assert_close(gg, 4 * _t(p["gather_w"])[..., s:e],
                                   rtol=1e-6, atol=1e-6)


def test_gloo_vae_equals_the_virtual_ranks(runs):
    p, ranks, _, _ = runs
    vae = build_vae(p["vae_cfg"], "cpu", torch.float32, seed=None)
    vae.load_state_dict(p["vae_sd"])
    for impl in ("torch", "plain"):
        dec = vae_decode(vae, _t(p["z"]), conv_impl=impl,
                         spatial=VirtualRanks(4))
        enc = vae_encode(vae, _t(p["vid"]), conv_impl=impl,
                         spatial=VirtualRanks(4))
        assert dec.shape == (1, 3, 9, 64, 80)
        assert enc.shape == (1, 16, 2, 4, 10)
        for r in ranks:
            torch.testing.assert_close(r[f"decode_{impl}"], dec, rtol=0,
                                       atol=0)
            torch.testing.assert_close(r[f"encode_{impl}"], enc, rtol=0,
                                       atol=0)


def test_omni_step_with_h_sharded_pose_matches_jax(runs):
    _, ranks, _, want = runs
    got = ranks[0]["omni"]
    assert got["pose_sharded"] and got["pose_rows"] == 8
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=TOL)
    np.testing.assert_allclose(got["norm"], want["grad_norm"], rtol=TOL)
    scale = max(float(np.abs(np.asarray(w)).max())
                for w in want["grads"].values())
    assert set(got["grads"]) == set(want["grads"])
    for n, w in want["grads"].items():
        np.testing.assert_allclose(got["grads"][n].numpy(), np.asarray(w),
                                   rtol=TOL, atol=TOL * scale, err_msg=n)
    for r in ranks[1:]:
        np.testing.assert_allclose(r["omni"]["loss"], got["loss"],
                                   rtol=1e-6)


def test_one_step_cli_on_a_mesh_matches_jax(runs):
    p, ranks, want, _ = runs
    path = ranks[0]["one_step"]
    assert path is not None and os.path.getsize(path) > 0
    assert [r["one_step"] for r in ranks[1:]] == [None] * 3
    lat = ranks[0]["one_step_latents"]
    for r in ranks[1:]:
        torch.testing.assert_close(r["one_step_latents"], lat, rtol=0,
                                   atol=0)
    got = lat.float().numpy()
    assert got.shape == want.shape == (1, 16, 2, 4, 4)
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel < 2e-2, rel
    vae = build_vae(TINY_TEST.vae, "cpu", torch.bfloat16, seed=None)
    vae.load_state_dict({k: v.to(torch.bfloat16) for k, v in torch.load(
        os.path.join(p["ckpt"], "Wan2.1_VAE.pth")).items()})
    video = vae_decode(vae, lat, spatial=VirtualRanks(4))[0]
    assert video.shape == (3, 5, 32, 32)
    torch.testing.assert_close(ranks[0]["one_step_video"], video, rtol=0,
                               atol=0)


def test_int8_with_fsdp(runs):
    """The sharded int8 DiT equals the whole one bit for bit, each int8
    weight and scale on JAX's dimension; the int8 CLIs run on the mesh."""
    _, ranks, _, _ = runs
    for r in ranks:
        torch.testing.assert_close(r["int8"]["mesh"], r["int8"]["whole"],
                                   rtol=0, atol=0)
    placed = ranks[0]["int8"]["placed"]
    assert any(n.endswith(".w_q") for n in placed)
    # the dimension of every sharded int8 leaf is the one JAX's rule picks
    model = quantize_wan_model(build_wan_model(TINY_TEST.model, "cpu",
                                               torch.float32, seed=None))
    specs = infer_param_specs(model, min_size=1, axis_size=2)
    for n, (dim, local) in placed.items():
        assert dim == specs[n], n
    jparams = jax.eval_shape(lambda: quantize_wan_params(init_wan_model(
        jax.random.key(0), JAX_TINY.model)))
    jblocks = jax_specs(jparams, min_size=1, axis_size=2)["blocks"]
    # JAX's stacked leaves: w_q [L, in, out], w_s [L, out]; the port's
    # per block: w_q [out, in], w_s [out]
    to_port = {"w_q": {0: None, 1: 1, 2: 0}, "w_s": {0: None, 1: 0}}
    checked = 0
    for n, dim in specs.items():
        parts = n.split(".")
        if parts[-1] not in to_port:
            continue
        if parts[2] == "ffn":
            leaf = jblocks[{"0": "ffn_fc1", "2": "ffn_fc2"}[parts[3]]]
        else:
            leaf = jblocks[parts[2]][parts[3]]
        spec = tuple(leaf[parts[-1]])
        jdim = spec.index("fsdp") if "fsdp" in spec else None
        assert dim == (None if jdim is None else to_port[parts[-1]][jdim]), n
        checked += 1
    assert checked == 2 * sum(isinstance(m, type(model.blocks[0].ffn[0]))
                              for m in model.modules())
    for key in ("int8_generate", "int8_omni"):
        assert ranks[0][key] is not None and os.path.getsize(ranks[0][key])
        assert [r[key] for r in ranks[1:]] == [None] * 3
