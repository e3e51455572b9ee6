"""The port's f-divergence distillation (apt/f_distill.py) against the JAX
package at TINY_TEST: the five weightings h(r), the feature function, the
MLP discriminator, and one `f_distill_train_step` with the same student,
teacher and discriminator weights (carried by the port's converters) and
the same numpy batch.

Tolerances:
  - h(r) and the features: rtol 1e-6 (the same fp32 elementwise ops);
    the discriminator forward atol 1e-6;
  - fp32 parameters and compute, with and without the discriminator: the
    six metrics rtol 1e-5; the teacher's CFG velocity, which the port
    takes from one batch-2 forward where JAX runs two, atol 1e-5; the
    student and discriminator parameters after the step atol 1e-7 (each
    update is ~lr, and both sides take the same Adam arithmetic on
    gradients that agree to fp32 rounding), both Adam states to atol 1e-7
    plus 1e-5 of each tensor's peak (the discriminator's gradients are of
    order 1), but for the
    parameter elements whose gradient is within 10 eps (1e-7) of zero:
    Adam's first update there, lr g / (|g| + eps), turns fp32 noise in g
    into up to 2 lr, so those are held within 2.02 lr;
  - bf16 parameters and compute (the CLI's setting), the distill test's
    bf16 tolerances: the metrics rtol 2e-2; the student's parameters
    within two bf16 rounding steps (rtol 2^-6) of JAX's, but for at most
    0.1% of the elements, which are within 2.02 lr (an update's sign
    flipped where a gradient element is at the bf16 noise level); the
    fp32 discriminator within 2.02 d_lr for the same reason; the student's
    Adam moments within 2e-2 relative L2."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from omnihuman_tpu.apt import f_distill as jfd
from omnihuman_tpu.configs.wan import DTypePolicy as JaxPolicy
from omnihuman_tpu.configs.wan import TINY_TEST as JAX_TINY
from omnihuman_tpu.models.wan_dit import wan_model_forward
from omnihuman_tpu.ops.rope import rope_angles_3d as jax_rope
from omnihuman_tpu.utils.convert import convert_wan_dit
from omnihuman_tpu_torch.apt import f_distill as fd
from omnihuman_tpu_torch.apt.distill import trainable_params
from omnihuman_tpu_torch.apt.generate import teacher_cfg_velocity
from omnihuman_tpu_torch.configs.wan import TINY_TEST, DTypePolicy
from omnihuman_tpu_torch.models.wan_dit import build_wan_model
from omnihuman_tpu_torch.ops.rope import rope_angles_3d
from omnihuman_tpu_torch.utils.convert import (
    f_distill_state_from_jax, mlp_discriminator_state_dict_from_jax,
    wan_dit_state_dict_from_jax)

torch.set_num_threads(1)

CFG = TINY_TEST.model
GRID, SEQ = (2, 2, 3), 12          # latents [2, 16, 2, 4, 6]
LATENT = (2, 16, 2, 4, 6)
FEAT = 512
LR, D_LR = 1e-5, 1e-5                # the CLI's defaults
KW = dict(f_divergence="jensen-shannon", cfg_scale=7.5, alpha=0.1, beta=0.9,
          t_max=1000.0)
METRICS = ("loss", "f_div_loss", "g_loss", "d_loss", "density_ratio_mean",
           "weight_mean")


def _compiled(fn, *args):
    """One jitted program without XLA:CPU's excess precision, so the bf16
    roundings the JAX code asks for happen, as the port performs them."""
    return jax.jit(fn).lower(*args).compile(compiler_options={
        "xla_allow_excess_precision": False})(*args)


def _jax_params(seed):
    """The reference init (made by the port, carried to JAX by the JAX
    converter) with a random head."""
    model = build_wan_model(CFG, "cpu", torch.float32, seed=seed)
    params = jax.tree.map(np.asarray, convert_wan_dit(
        {k: v.numpy() for k, v in model.state_dict().items()},
        JAX_TINY.model))
    rng = np.random.default_rng(seed + 11)
    params["head"]["w"] = (rng.normal(size=params["head"]["w"].shape)
                           * 0.1).astype(np.float32)
    return params


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    ctx = lambda: (rng.normal(size=(LATENT[0], CFG.text_len, CFG.text_dim))
                   * 0.5).astype(np.float32)
    return {"noise": rng.normal(size=LATENT).astype(np.float32),
            "context": ctx(), "context_null": ctx()}


def _d_params(seed=3):
    """JAX's discriminator init, drawn once in numpy."""
    rng = np.random.default_rng(seed)
    lin = lambda i, o: {"w": (rng.normal(size=(i, o)) * (2.0 / i) ** 0.5
                              ).astype(np.float32),
                        "b": (rng.normal(size=(o,)) * 0.1).astype(np.float32)}
    return {"fc1": lin(FEAT, 256), "fc2": lin(256, 128), "fc3": lin(128, 1)}


def _port_model(params, dtype, trainable):
    model = build_wan_model(CFG, "cpu", dtype, seed=None, trainable=trainable)
    model.load_state_dict(wan_dit_state_dict_from_jax(params, CFG))
    return model


def _port_disc(d_params):
    disc = fd.MLPDiscriminator(FEAT)
    disc.load_state_dict(mlp_discriminator_state_dict_from_jax(d_params))
    return disc


def test_f_divergences_and_features_match_jax():
    r = np.concatenate([[0.01, 1.0, 100.0], np.random.default_rng(0).uniform(
        0.01, 100.0, size=29)]).astype(np.float32).reshape(-1, 1)
    want = _compiled(lambda r: [jfd.get_f_divergence_fn(n)(r)
                                for n in fd.F_DIVERGENCES], r)
    for name, w in zip(fd.F_DIVERGENCES, want):
        got = fd.get_f_divergence_fn(name)(torch.from_numpy(r))
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=1e-6,
                                   err_msg=name)
    v = np.random.default_rng(1).normal(size=(2, 16, 2, 4, 6)
                                        ).astype(np.float32)
    want = np.asarray(jfd.default_feature_fn(v))
    # a channels-last velocity gives the same logical elements
    vt = torch.from_numpy(v).contiguous(memory_format=torch.channels_last_3d)
    np.testing.assert_allclose(fd.default_feature_fn(vt).numpy(), want,
                               rtol=1e-6)
    with pytest.raises(ValueError, match="Unsupported"):
        fd.get_f_divergence_fn("total-variation")


def test_mlp_discriminator_matches_jax():
    d_params = _d_params()
    x = np.random.default_rng(2).normal(size=(3, FEAT)).astype(np.float32)
    want = np.asarray(jfd.mlp_discriminator_forward(d_params, x))
    with torch.no_grad():
        got = _port_disc(d_params)(torch.from_numpy(x)).numpy()
    assert got.shape == (3, 1)
    np.testing.assert_allclose(got, want, atol=1e-6)
    # the init draws He-normal weights and zero biases
    disc = fd.init_mlp_discriminator(FEAT, generator=torch.Generator()
                                     .manual_seed(0))
    assert float(disc.fc3.bias.detach().abs().max()) == 0.0
    he = (2.0 / FEAT) ** 0.5
    assert abs(float(disc.fc1.weight.detach().std()) - he) < 0.02 * he


def _run_both(dtype, use_discriminator):
    jdt = jnp.float32 if dtype == "fp32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "fp32" else torch.bfloat16
    jpol = JaxPolicy(compute=jnp.float32) if dtype == "fp32" else JaxPolicy()
    tpol = (DTypePolicy(compute=torch.float32) if dtype == "fp32"
            else DTypePolicy())
    teacher, student = _jax_params(0), _jax_params(1)
    d_params, batch = _d_params(), _batch()
    jt = jax.tree.map(lambda a: np.asarray(a, jdt), teacher)
    js = jax.tree.map(lambda a: np.asarray(a, jdt), student)

    opt, d_opt = optax.adamw(LR, weight_decay=0.01), optax.adam(D_LR)
    sin, cos = jax_rope(GRID, CFG.head_dim, seq_len=SEQ)
    step = functools.partial(
        jfd.f_distill_train_step, optimizer=opt, d_optimizer=d_opt,
        cfg=JAX_TINY.model, seq_len=SEQ, rope_sin=sin, rope_cos=cos,
        policy=jpol, use_discriminator=use_discriminator,
        feature_fn=functools.partial(jfd.default_feature_fn, dim=FEAT), **KW)

    def program(s, t, d, b):
        state, m = step(jfd.init_f_distill_state(s, d, opt, d_opt), t, b)
        t_ = jnp.full((LATENT[0],), KW["t_max"], jnp.float32)
        v = [wan_model_forward(t, b["noise"], t_, b[k], cfg=JAX_TINY.model,
                               seq_len=SEQ, rope_sin=sin, rope_cos=cos,
                               policy=jpol) for k in ("context",
                                                      "context_null")]
        return state, m, v[1] + KW["cfg_scale"] * (v[0] - v[1])
    jstate, jm, jv = _compiled(program, js, jt, d_params, batch)

    f32 = lambda tree: jax.tree.map(lambda a: np.asarray(a, np.float32),
                                    tree)
    teacher_m = _port_model(f32(jt), tdt, trainable=False)
    student_m = _port_model(f32(js), tdt, trainable=True)
    p_opt, p_dopt = fd.make_student_optimizer(LR), fd.make_d_optimizer(D_LR)
    state = fd.init_f_distill_state(student_m, _port_disc(d_params), p_opt,
                                    p_dopt)
    psin, pcos = rope_angles_3d(GRID, CFG.head_dim, seq_len=SEQ)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    v_teacher = teacher_cfg_velocity(
        teacher_m, tb["noise"], tb["context"], tb["context_null"],
        seq_len=SEQ, rope_sin=psin, rope_cos=pcos, policy=tpol,
        t_value=KW["t_max"], cfg_scale=KW["cfg_scale"])
    state, m = fd.f_distill_train_step(
        state, teacher_m, tb, optimizer=p_opt, d_optimizer=p_dopt,
        seq_len=SEQ, rope_sin=psin, rope_cos=pcos, policy=tpol,
        use_discriminator=use_discriminator,
        feature_fn=functools.partial(fd.default_feature_fn, dim=FEAT), **KW)
    want = f_distill_state_from_jax(
        jax.tree.map(lambda a: np.asarray(a, np.float32)
                     if hasattr(a, "dtype") and a.ndim else a, jstate),
        CFG)
    return want, jm, np.asarray(jv), state, m, v_teacher.numpy()


def _got(state):
    sd = state.state_dict()
    conv = lambda t: {n: v.float().numpy() for n, v in t.items()}
    return {"params": conv(sd["params"]), "d_params": conv(sd["d_params"]),
            "mu": conv(sd["opt_state"]["mu"]),
            "nu": conv(sd["opt_state"]["nu"]),
            "d_mu": conv(sd["d_opt_state"]["mu"]),
            "d_nu": conv(sd["d_opt_state"]["nu"])}


def _want(sd):
    conv = lambda t: {n: v.numpy() for n, v in t.items()}
    return {"params": conv(sd["params"]), "d_params": conv(sd["d_params"]),
            "mu": conv(sd["opt_state"]["mu"]),
            "nu": conv(sd["opt_state"]["nu"]),
            "d_mu": conv(sd["d_opt_state"]["mu"]),
            "d_nu": conv(sd["d_opt_state"]["nu"])}


@pytest.mark.parametrize("use_discriminator", [True, False])
def test_f_distill_step_matches_jax_fp32(use_discriminator):
    want_sd, jm, jv, state, m, v_teacher = _run_both("fp32",
                                                     use_discriminator)
    np.testing.assert_allclose(v_teacher, jv, atol=1e-5)
    for k in METRICS:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5,
                                   err_msg=k)
    assert float(m["f_div_loss"]) > 0
    if use_discriminator:
        assert 0.01 <= float(m["density_ratio_mean"]) <= 100.0
        assert float(m["d_loss"]) > 0 and float(m["g_loss"]) > 0
    else:
        assert float(m["d_loss"]) == 0.0 and float(m["g_loss"]) == 0.0
        assert float(m["density_ratio_mean"]) == 1.0
    assert state.step == want_sd["step"] == 1
    want, got = _want(want_sd), _got(state)
    assert want_sd["opt_state"]["count"] == state.opt_state["count"] == 1
    assert (want_sd["d_opt_state"]["count"] == state.d_opt_state["count"]
            == int(use_discriminator))
    for what in want:
        assert set(got[what]) == set(want[what]), what
        for n, w in want[what].items():
            err = np.abs(got[what][n] - w)
            if what in ("params", "d_params"):
                # Adam's first update is lr g / (|g| + eps): where |g| is
                # within 10 eps of zero, fp32 noise in g moves it by up
                # to 2 lr (1e-6 relative on the gradients in all)
                lr, mu = ((LR, want["mu"][n]) if what == "params"
                          else (D_LR, want["d_mu"][n]))
                near0 = np.abs(mu) < 0.1 * 10 * 1e-8    # mu = 0.1 g
                assert (err[near0] <= 2.02 * lr).all(), (what, n)
                err = np.where(near0, 0.0, err)
                tol = 1e-7
            else:     # the moments: fp32 rounding at the gradients' scale
                tol = 1e-7 + 1e-5 * np.abs(w).max()
            assert err.max() <= tol, (what, n, err.max())


def test_f_distill_step_matches_jax_bf16():
    want_sd, jm, jv, state, m, _ = _run_both("bf16", True)
    for k in METRICS:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=2e-2,
                                   err_msg=k)
    want, got = _want(want_sd), _got(state)
    assert all(p.dtype == torch.bfloat16
               for p in trainable_params(state.student).values())
    off = total = 0
    for n, w in want["params"].items():
        err = np.abs(got["params"][n] - w)
        # at worst the sign of one update differs (2 lr, plus decay)
        assert (err <= 2 ** -6 * np.abs(w) + 2.02 * LR).all(), n
        off += int((err > 2 ** -6 * np.abs(w)).sum())
        total += w.size
    assert off <= 1e-3 * total, (off, total)
    for n, w in want["d_params"].items():
        assert (np.abs(got["d_params"][n] - w) <= 2.02 * D_LR).all(), n
    for what in ("mu", "nu"):
        num = sum(float(np.sum((got[what][n] - w) ** 2))
                  for n, w in want[what].items())
        den = sum(float(np.sum(w ** 2)) for w in want[what].values())
        assert np.sqrt(num / den) < 2e-2, what
