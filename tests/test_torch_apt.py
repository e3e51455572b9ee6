"""The port's Seaweed-APT stack (apt/model.py, apt/apt_trainer.py) against
the JAX package: the DiT's collect_layers taps, and one D step and one G
step with the same weights (carried by the port's converters), the same
numpy batch and the same random draws (JAX's, handed to the port's
`*_with_draws` steps).

Tolerances, fp32 parameters and compute throughout: taps and velocities
atol 1e-5 (activations of order 1); losses rtol 1e-5; the R1 estimate on
a toy discriminator with JAX's noise rtol 1e-4 (a mean of squared
differences of nearby logits, which cancel); parameters after
one RMSprop step at lr 1e-3 atol 1e-6 (each update is ~3e-3, and both
sides take the same arithmetic on gradients that agree to fp32
rounding)."""

import copy
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnihuman_tpu.apt import apt_trainer as jtr
from omnihuman_tpu.apt import model as jmodel
from omnihuman_tpu.configs.wan import DTypePolicy as JaxPolicy
from omnihuman_tpu.configs.wan import WanModelConfig as JaxModelConfig
from omnihuman_tpu.ops.rope import rope_angles_3d as jax_rope
from omnihuman_tpu.utils.convert import convert_wan_dit
from omnihuman_tpu_torch.apt import apt_trainer as tr
from omnihuman_tpu_torch.apt.distill import trainable_params
from omnihuman_tpu_torch.apt.model import (
    apt_discriminator_forward, approximated_r1_loss, default_tap_layers,
    init_apt_discriminator, timestep_shift)
from omnihuman_tpu_torch.configs.wan import DTypePolicy, WanModelConfig
from omnihuman_tpu_torch.models.wan_dit import build_wan_model
from omnihuman_tpu_torch.ops.rope import rope_angles_3d
from omnihuman_tpu_torch.utils.convert import (
    apt_discriminator_state_dict_from_jax, wan_dit_state_dict_from_jax)

torch.set_num_threads(1)

CFG = WanModelConfig(dim=32, ffn_dim=64, num_heads=4, num_layers=3,
                     freq_dim=16, text_dim=24, text_len=8)
JCFG = JaxModelConfig(**dataclasses.asdict(CFG))
GRID, SEQ, B = (2, 2, 2), 8, 2
LR = 1e-3
FP32 = DTypePolicy(compute=torch.float32)


def _compiled(fn, *args):
    """jit with XLA's cheap CPU pipeline: the steps run once, so compile
    time is what the test pays."""
    return jax.jit(fn).lower(*args).compile(compiler_options={
        "xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True})(*args)


@pytest.fixture(scope="module")
def setup():
    """JAX params made from a port init (the reference init with a random
    head) through the JAX converter: quicker than JAX's eager init."""
    model = build_wan_model(CFG, "cpu", torch.float32, seed=0)
    params = jax.tree.map(np.asarray, convert_wan_dit(
        {k: v.numpy() for k, v in model.state_dict().items()}, JCFG))
    rng = np.random.default_rng(0)
    params["head"]["w"] = (rng.normal(size=params["head"]["w"].shape)
                           * 0.1).astype(np.float32)
    batch = {k: rng.normal(size=(B, 16, 2, 4, 4)).astype(np.float32)
             for k in ("noise", "real")}
    batch["context"] = rng.normal(size=(B, CFG.text_len, CFG.text_dim)
                                  ).astype(np.float32)
    d_params = jax.tree.map(np.asarray, _compiled(
        functools.partial(jmodel.init_apt_discriminator, cfg=JCFG),
        jax.random.key(1), params))
    return params, d_params, batch


def _port_models(params, d_params):
    g = build_wan_model(CFG, "cpu", torch.float32, seed=None, trainable=True)
    g.load_state_dict(wan_dit_state_dict_from_jax(params, CFG))
    disc = init_apt_discriminator(copy.deepcopy(g))
    disc.load_state_dict(apt_discriminator_state_dict_from_jax(d_params, CFG))
    return g, disc


def _rope():
    sin, cos = rope_angles_3d(GRID, CFG.head_dim, seq_len=SEQ)
    return dict(seq_len=SEQ, rope_sin=sin, rope_cos=cos, policy=FP32)


def _jax_kw():
    sin, cos = jax_rope(GRID, CFG.head_dim, seq_len=SEQ)
    return dict(cfg=JCFG, seq_len=SEQ, rope_sin=sin, rope_cos=cos,
                policy=JaxPolicy(compute=jnp.float32))


def _tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_tap_layers_and_timestep_shift_match_jax():
    for n in (2, 3, 30, 40):
        assert default_tap_layers(n) == tuple(jmodel.default_tap_layers(n))
    t = np.array([0.0, 0.3, 0.5, 1.0], np.float32)
    for s in (1.0, 12.0):
        np.testing.assert_allclose(
            timestep_shift(torch.from_numpy(t), s).numpy(),
            np.asarray(jmodel.timestep_shift(jnp.asarray(t), s)), rtol=1e-6)


def _jax_step(step, draws, params, d_params, batch, key):
    """`step` from a fresh APTState -> (state, metrics, draws(key)): the
    init and the step's own random draws inside the compiled program
    (eager, their ops would compile one by one)."""
    def run(p, d, b, k):
        return step(jtr.init_apt_state(p, d, LR, LR), b, k) + (draws(k),)
    return _compiled(run, params, d_params, jax.tree.map(jnp.asarray, batch),
                     key)


def _assert_close_tree(got, want_sd, atol, what):
    for n, w in want_sd.items():
        np.testing.assert_allclose(got[n].detach().numpy(), w.numpy(),
                                   atol=atol, err_msg=f"{what} {n}")


def test_steps_draw_from_the_generator_and_video_phase_boots_from_ema(setup):
    params, d_params, batch = setup
    g, disc = _port_models(params, d_params)
    apt_cfg = tr.SeaweedAPTConfig()
    state = tr.init_apt_state(g, disc, LR, LR)
    kw = dict(apt_cfg=apt_cfg, video=False, **_rope())
    gen = torch.Generator().manual_seed(0)
    state, dm = tr.apt_d_step(state, _tensors(batch), gen,
                              d_optimizer=tr.make_d_optimizer(LR, disc), **kw)
    state, gm = tr.apt_g_step(state, _tensors(batch), gen,
                              g_optimizer=tr.make_rmsprop(LR), **kw)
    assert np.isfinite(float(dm["d_total"])) and np.isfinite(
        float(gm["g_loss"]))

    with torch.no_grad():
        for e in state.ema_params.values():
            e.add_(1.0)
    ema = {n: e.clone() for n, e in state.ema_params.items()}
    _, fresh = _port_models(params, d_params)
    s2 = tr.start_video_phase(state, fresh, apt_cfg)
    for n, p in trainable_params(s2.g_model).items():
        assert torch.equal(p, ema[n]), n
    assert s2.step == 0 and s2.disc is fresh
    assert all(not v.any() for v in s2.g_opt["nu"].values())


def test_discriminator_stop_features_cuts_the_backbone_gradient(setup):
    params, d_params, batch = setup
    _, disc = _port_models(params, d_params)
    x = torch.from_numpy(batch["real"]).requires_grad_(True)
    t = torch.tensor([500.0, 500.0])
    ctx = torch.from_numpy(batch["context"])
    logit = apt_discriminator_forward(disc, x, t, ctx, **_rope())
    assert logit.shape == (B, 1)
    assert torch.autograd.grad(logit.sum(), x, allow_unused=True)[0] is None
    logit = apt_discriminator_forward(disc, x, t, ctx, stop_features=False,
                                      remat=True, **_rope())
    assert torch.autograd.grad(logit.sum(), x)[0].abs().max() > 0


def test_approximated_r1_loss_matches_jax():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(3, 16, 1, 2, 2)).astype(np.float32)
    w = rng.normal(size=(16 * 4,)).astype(np.float32)
    key = jax.random.key(6)
    noise = np.array(jax.random.normal(key, x.shape, jnp.float32))
    want = jmodel.approximated_r1_loss(
        lambda v: jnp.tanh(v.reshape(3, -1) @ jnp.asarray(w)), jnp.asarray(x),
        key, sigma=0.1)
    got = approximated_r1_loss(
        lambda v: torch.tanh(v.reshape(3, -1) @ torch.from_numpy(w)),
        torch.from_numpy(x), torch.from_numpy(noise), sigma=0.1)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-4)
