"""The port's consistency-distillation step (apt/distill.py) against the
JAX `distill_train_step` at TINY_TEST, with the weights carried across by
the port's converter and the same numpy batch.

Tolerances:
  - fp32 parameters and compute: loss and grad norm rtol 1e-5; parameters
    and EMA after one step atol 1e-7 (the update is ~lr = 5e-6 a weight,
    and both sides take the same AdamW arithmetic on gradients that agree
    to fp32 rounding);
  - bf16 parameters, bf16 compute (the trainer's default): loss and grad
    norm rtol 2e-2 (bf16 matmuls summed in another order); parameters
    and EMA within two bf16 rounding steps (rtol 2^-6) of JAX's, but for
    at most 0.1% of the elements, where a gradient element is at the bf16
    noise level and the sign of its ~lr update differs (those within
    2.02 lr); the AdamW moments, made from bf16 gradients, within 2e-2
    relative L2.
Remat and accumulation are port-only identities: per-block, grouped and
no remat give bit-equal gradients on the CPU; k=2 accumulation equals one
step on the doubled batch to fp32 rounding (atol 1e-7 on parameters)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnihuman_tpu.apt.distill import distill_train_step as jax_step
from omnihuman_tpu.apt.distill import init_distill_state as jax_init
from omnihuman_tpu.apt.distill import make_optimizer as jax_make_optimizer
from omnihuman_tpu.configs.wan import DTypePolicy as JaxPolicy
from omnihuman_tpu.configs.wan import TINY_TEST as JAX_TINY
from omnihuman_tpu.ops.rope import rope_angles_3d as jax_rope
from omnihuman_tpu.utils.convert import convert_wan_dit
from omnihuman_tpu_torch.apt.distill import (
    distill_loss, distill_train_step, init_distill_state, make_optimizer,
    trainable_params)
from omnihuman_tpu_torch.configs.wan import TINY_TEST, DTypePolicy
from omnihuman_tpu_torch.models.wan_dit import build_wan_model
from omnihuman_tpu_torch.ops.rope import rope_angles_3d
from omnihuman_tpu_torch.utils.convert import wan_dit_state_dict_from_jax

torch.set_num_threads(1)

CFG = TINY_TEST.model
GRID, SEQ = (2, 2, 3), 12          # latents [2, 16, 2, 4, 6]
LATENT = (2, 16, 2, 4, 6)
LR = 5e-6                          # make_optimizer's default


def _compiled(fn, *args):
    """jit with XLA's cheap CPU pipeline: the step runs once, so compile
    time is what the test pays."""
    return jax.jit(fn).lower(*args).compile(compiler_options={
        "xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True})(*args)


def _jax_params(seed=0):
    """The reference init (made by the port, carried to JAX by the JAX
    converter: quicker than JAX's eager init) with a random head (the
    zero-initialised reference head would send a gradient to the head
    only)."""
    model = build_wan_model(CFG, "cpu", torch.float32, seed=seed)
    params = jax.tree.map(np.asarray, convert_wan_dit(
        {k: v.numpy() for k, v in model.state_dict().items()},
        JAX_TINY.model))
    rng = np.random.default_rng(seed + 11)
    params["head"]["w"] = (rng.normal(size=params["head"]["w"].shape)
                           * 0.1).astype(np.float32)
    return params


def _batch(seed=0, b=2):
    rng = np.random.default_rng(seed)
    shape = (b,) + LATENT[1:]
    return {"noise": rng.normal(size=shape).astype(np.float32),
            "context": (rng.normal(size=(b, CFG.text_len, CFG.text_dim))
                        * 0.5).astype(np.float32),
            "v_teacher": rng.normal(size=shape).astype(np.float32)}


def _port_model(params, dtype):
    model = build_wan_model(CFG, "cpu", dtype, seed=None, trainable=True)
    model.load_state_dict(wan_dit_state_dict_from_jax(params, CFG))
    return model


def _to_port(tree):
    return {k: v.float().numpy() for k, v in
            wan_dit_state_dict_from_jax(
                jax.tree.map(lambda a: np.asarray(a, np.float32), tree),
                CFG).items()}


def _run_both(dtype):
    jdt = jnp.float32 if dtype == "fp32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "fp32" else torch.bfloat16
    jpol = JaxPolicy(compute=jnp.float32) if dtype == "fp32" else JaxPolicy()
    tpol = (DTypePolicy(compute=torch.float32) if dtype == "fp32"
            else DTypePolicy())
    params = _jax_params()
    batch = _batch()

    # cast in numpy (ml_dtypes' bf16 rounds to nearest even, as XLA does)
    jparams = jax.tree.map(lambda a: np.asarray(a, jdt), params)
    jopt = jax_make_optimizer()
    sin, cos = jax_rope(GRID, CFG.head_dim, seq_len=SEQ)
    step = functools.partial(
        jax_step, optimizer=jopt, cfg=JAX_TINY.model, seq_len=SEQ,
        rope_sin=sin, rope_cos=cos, policy=jpol, remat=True)
    # the init inside the compiled step: eager, its ops compile one by one
    jstate, jm = _compiled(lambda p, b: step(jax_init(p, jopt), b),
                           jparams, batch)

    model = _port_model(jax.tree.map(
        lambda a: a.astype(np.float32), jparams), tdt)
    opt = make_optimizer()
    psin, pcos = rope_angles_3d(GRID, CFG.head_dim, seq_len=SEQ)
    state, m = distill_train_step(
        init_distill_state(model, opt),
        {k: torch.from_numpy(v) for k, v in batch.items()}, optimizer=opt,
        seq_len=SEQ, rope_sin=psin, rope_cos=pcos, policy=tpol, remat=True)
    return jstate, jm, state, m


def test_distill_step_matches_jax_fp32():
    jstate, jm, state, m = _run_both("fp32")
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-5)
    assert state.step == int(jstate.step) == 1
    want_p, want_e = _to_port(jstate.params), _to_port(jstate.ema_params)
    got_p = {n: p.detach().numpy() for n, p in
             trainable_params(state.model).items()}
    assert set(got_p) == set(want_p)
    for n in want_p:
        np.testing.assert_allclose(got_p[n], want_p[n], atol=1e-7,
                                   err_msg=n)
        np.testing.assert_allclose(state.ema_params[n].numpy(), want_e[n],
                                   atol=1e-7, err_msg=n)


def test_distill_step_matches_jax_bf16():
    jstate, jm, state, m = _run_both("bf16")
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=2e-2)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                               rtol=2e-2)
    want = {"params": _to_port(jstate.params),
            "ema": _to_port(jstate.ema_params)}
    got = {"params": trainable_params(state.model),
           "ema": state.ema_params}
    for what in want:
        off = total = 0
        for n, w in want[what].items():
            g = got[what][n]
            assert g.dtype == torch.bfloat16, (what, n)
            err = np.abs(g.detach().float().numpy() - w)
            # at worst the sign of one update differs (2 lr, plus decay)
            assert (err <= 2 ** -6 * np.abs(w) + 2.02 * LR).all(), (what, n)
            off += int((err > 2 ** -6 * np.abs(w)).sum())
            total += w.size
        assert off <= 1e-3 * total, (what, off, total)
    adam = jstate.opt_state[1][0]          # chain(clip, adamw) -> adam state
    for what, tree in (("mu", adam.mu), ("nu", adam.nu)):
        want_m = _to_port(tree)
        got_m = state.opt_state[what]
        num = sum(float(np.sum((got_m[n].float().numpy() - w) ** 2))
                  for n, w in want_m.items())
        den = sum(float(np.sum(w ** 2)) for w in want_m.values())
        assert np.sqrt(num / den) < 2e-2, what


def _grads(model, batch, remat):
    params = trainable_params(model)
    sin, cos = rope_angles_3d(GRID, CFG.head_dim, seq_len=SEQ)
    loss = distill_loss(model, batch, seq_len=SEQ, rope_sin=sin,
                        rope_cos=cos, policy=DTypePolicy(
                            compute=torch.float32), remat=remat)
    return torch.autograd.grad(loss, list(params.values()))


def test_remat_variants_give_equal_gradients():
    model = _port_model(_jax_params(1), torch.float32)
    batch = {k: torch.from_numpy(v) for k, v in _batch(1).items()}
    want = _grads(model, batch, False)
    for remat in (True, 2):
        for a, b in zip(_grads(model, batch, remat), want):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError, match="divide"):
        _grads(model, batch, 3)


def test_accumulation_equals_one_step_on_doubled_batch():
    params = _jax_params(2)
    batch = {k: torch.from_numpy(v) for k, v in _batch(2, b=2).items()}
    sin, cos = rope_angles_3d(GRID, CFG.head_dim, seq_len=SEQ)
    kw = dict(seq_len=SEQ, rope_sin=sin, rope_cos=cos,
              policy=DTypePolicy(compute=torch.float32))

    model_a = _port_model(params, torch.float32)
    before = {n: p.detach().clone() for n, p in
              trainable_params(model_a).items()}
    opt_a = make_optimizer(accumulation_steps=2)
    state_a = init_distill_state(model_a, opt_a)
    for i in range(2):
        half = {k: v[i:i + 1] for k, v in batch.items()}
        state_a, _ = distill_train_step(state_a, half, optimizer=opt_a, **kw)
        if i == 0:       # the first mini-step leaves the parameters alone
            for n, p in trainable_params(model_a).items():
                assert torch.equal(p, before[n]), n
    assert state_a.opt_state["gradient_step"] == 1

    model_b = _port_model(params, torch.float32)
    opt_b = make_optimizer()
    state_b, _ = distill_train_step(init_distill_state(model_b, opt_b),
                                    batch, optimizer=opt_b, **kw)
    pb = trainable_params(model_b)
    for n, p in trainable_params(model_a).items():
        torch.testing.assert_close(p, pb[n], rtol=0, atol=1e-7)
