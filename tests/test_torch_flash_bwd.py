"""The port's flash-attention LSE and plain backward against the JAX Pallas
kernels run in interpret mode (as tests/test_ops.py runs them on the
CPU), and against torch.autograd of the plain forward.

Inputs and the cotangent are made with numpy from a seed and handed to
both packages. Tolerances: fp32 2e-5 x the gradient's own peak (same math,
other summation order); bf16 compute 2^-5 x the peak (P and dS are rounded
to bf16 at the same points, but from fp32 values that differ in the last
bits); the LSE in fp32 1e-5."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnihuman_tpu.ops.flash_pallas import (
    _flash_fwd_nd, pallas_flash_attention)
from omnihuman_tpu_torch.ops.attention import flash_attention
from omnihuman_tpu_torch.ops.flash_attention import (
    KERNELS, NEG_INF, FlashAttention, flash_attention_plain, flash_bwd_cuda,
    flash_bwd_plain)

torch.set_num_threads(1)

# k_lens and k_len_zero have one shape: they share a JAX compile
CASES = {
    "k_lens": dict(lq=40, lk=70, k_lens=(70, 33)),
    "k_len_zero": dict(lq=40, lk=70, k_lens=(50, 0)),
    "causal_offsets": dict(lq=40, lk=72, k_lens=(72, 60), causal=True,
                           offsets=(8, 3)),
    "window_offsets": dict(lq=64, lk=64, k_lens=None, window=(20, 5),
                           offsets=(16, 0)),
}


def _inputs(case, d, seed=0):
    c = CASES[case]
    rng = np.random.default_rng(seed)
    b, n = 2, 2
    q = rng.normal(size=(b, c["lq"], n, d)).astype(np.float32)
    k = rng.normal(size=(b, c["lk"], n, d)).astype(np.float32)
    v = rng.normal(size=(b, c["lk"], n, d)).astype(np.float32)
    g = rng.normal(size=(b, c["lq"], n, d)).astype(np.float32)
    kw = dict(causal=c.get("causal", False),
              window_size=c.get("window", (-1, -1)), offsets=c.get("offsets"))
    return q, k, v, g, c["k_lens"], kw


def _torch_lens(kl):
    return None if kl is None else torch.tensor(kl, dtype=torch.int32)


@functools.lru_cache(maxsize=None)
def _pallas_program(dtype, causal, window):
    """JAX's LSE (the Pallas forward, with_lse; the LSE test reads the fp32
    cases) and the Pallas VJP's gradients, jitted once per mask kind with
    XLA's cheap CPU pipeline (the programs run once: compile time is what
    the tests pay). The data, k_lens and offsets are arguments, so cases of
    one shape that differ only there share a compile."""
    jdt = jnp.float32 if dtype == "fp32" else jnp.bfloat16
    hi = jax.lax.Precision.HIGHEST

    def run(q, k, v, g, k_lens, offsets):
        b, lq, n, d = q.shape
        lk = k.shape[1]
        lens = (jnp.full((b,), lk, jnp.int32) if k_lens is None
                else jnp.minimum(k_lens, lk))
        lse = None if dtype != "fp32" else _flash_fwd_nd(   # fp32 cases only
            q.reshape(b, lq, n * d), k.reshape(b, lk, n * d),
            v.reshape(b, lk, n * d), lens, d ** -0.5, causal, window, 32, 32,
            True, hi, True, d, offsets=offsets)[1]

        def loss(q_, k_, v_):
            out = pallas_flash_attention(
                q_, k_, v_, k_lens=k_lens, causal=causal, window_size=window,
                offsets=offsets, compute_dtype=jdt, block_q=32, block_k=32,
                interpret=True, precision=hi)
            return jnp.sum(out.astype(jnp.float32) * g)

        return lse, jax.grad(loss, argnums=(0, 1, 2))(q, k, v)

    return jax.jit(run, compiler_options={
        "xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True})


@functools.lru_cache(maxsize=None)
def _pallas_reference(case, d, seed, dtype):
    """(LSE, [dq, dk, dv]) of JAX for one case, as fp32 numpy: the LSE and
    the fp32 backward tests read the same inputs, so they share the run."""
    q, k, v, g, kl, kw = _inputs(case, d, seed)
    jdt = jnp.float32 if dtype == "fp32" else jnp.bfloat16
    offs = kw["offsets"]
    lse, grads = _pallas_program(dtype, kw["causal"], kw["window_size"])(
        *(np.asarray(x, jdt) for x in (q, k, v)), g,
        None if kl is None else np.array(kl, np.int32),
        None if offs is None else np.array(offs, np.int32))
    return (None if lse is None else np.asarray(lse, np.float32),
            [np.asarray(x, np.float32) for x in grads])


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_lse_matches_pallas(case):
    q, k, v, _, kl, kw = _inputs(case, 16)
    b, lq, n, d = q.shape
    want, _ = _pallas_reference(case, 16, 0, "fp32")
    _, got = flash_attention_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        k_lens=_torch_lens(kl), return_lse=True, **kw)
    assert got.shape == (b, n, lq) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    if kl is not None and 0 in kl:
        assert (got[list(kl).index(0)] == NEG_INF).all()


def _plain_grads(q, k, v, g, kl, kw, dtype):
    tdt = torch.float32 if dtype == "fp32" else torch.bfloat16
    qt, kt, vt = (torch.from_numpy(x).to(tdt) for x in (q, k, v))
    out, lse = flash_attention_plain(qt, kt, vt, k_lens=_torch_lens(kl),
                                     return_lse=True, **kw)
    grads = flash_bwd_plain(qt, kt, vt, out, lse,
                            torch.from_numpy(g).to(tdt),
                            k_lens=_torch_lens(kl), **kw)
    for x, ref in zip(grads, (qt, kt, vt)):
        assert x.dtype == ref.dtype and x.shape == ref.shape
    return [x.float().numpy() for x in grads]


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_backward_matches_pallas_vjp_fp32(case):
    q, k, v, g, kl, kw = _inputs(case, 16)
    _, want = _pallas_reference(case, 16, 0, "fp32")
    got = _plain_grads(q, k, v, g, kl, kw, "fp32")
    for name, a, b in zip("qkv", got, want):
        tol = 2e-5 * max(1.0, np.abs(b).max())
        np.testing.assert_allclose(a, b, atol=tol, err_msg=f"d{name}")
    if kl is not None and 0 in kl:     # no valid key: every gradient is 0
        i = list(kl).index(0)
        assert not got[0][i].any() and not got[1][i].any()
        assert not got[2][i].any()


@pytest.mark.parametrize("case", ["k_lens", "causal_offsets"])
def test_plain_backward_matches_pallas_vjp_bf16(case):
    q, k, v, g, kl, kw = _inputs(case, 128, seed=1)
    _, want = _pallas_reference(case, 128, 1, "bf16")
    got = _plain_grads(q, k, v, g, kl, kw, "bf16")
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a, b, atol=2 ** -5 * np.abs(b).max(),
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_backward_matches_autograd_of_plain_forward(case):
    """In fp32 the written-out backward is the exact gradient of the plain
    forward; the k_len=0 rows, whose forward is a constant 0, get 0."""
    q, k, v, g, kl, kw = _inputs(case, 16, seed=2)
    qt, kt, vt = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out = flash_attention_plain(qt, kt, vt, k_lens=_torch_lens(kl), **kw)
    want = torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(g))
    got = _plain_grads(q, k, v, g, kl, kw, "fp32")
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a, b.numpy(), atol=1e-5,
                                   err_msg=f"d{name}")


def test_front_end_takes_the_autograd_function_only_for_gradients():
    """With requires_grad the front end's gradients are the plain backward's
    (through the dtype casts); without, it is one forward. No kernel is
    launched on the CPU."""
    q, k, v, g, kl, kw = _inputs("k_lens", 16, seed=3)
    before = [kn.launches for kn in KERNELS]
    qt, kt, vt = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out = flash_attention(qt, kt, vt, k_lens=_torch_lens(kl),
                          dtype=torch.float32)
    assert out.grad_fn is not None
    out.backward(torch.from_numpy(g))
    want = _plain_grads(q, k, v, g, kl, dict(causal=False,
                                             window_size=(-1, -1),
                                             offsets=None), "fp32")
    for a, b in zip((qt.grad, kt.grad, vt.grad), want):
        np.testing.assert_allclose(a.numpy(), b, atol=1e-6)
    with torch.no_grad():
        assert flash_attention(qt, kt, vt).grad_fn is None
    assert [kn.launches for kn in KERNELS] == before


def test_function_applies_on_cpu_with_bf16():
    q, k, v, _, kl, kw = _inputs("causal_offsets", 16, seed=4)
    qt, kt, vt = (torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
                  for x in (q, k, v))
    out = FlashAttention.apply(qt, kt, vt, _torch_lens(kl), None,
                               kw["causal"], kw["window_size"], kw["offsets"])
    out.float().sum().backward()
    assert qt.grad.dtype == torch.bfloat16 and torch.isfinite(
        qt.grad.float()).all()


def test_backward_kernel_wrapper_refuses_cpu_tensors():
    q = torch.zeros(1, 8, 1, 128, dtype=torch.bfloat16)
    lse = torch.zeros(1, 1, 8)
    with pytest.raises(ValueError, match="CUDA"):
        flash_bwd_cuda(q, q, q, q, lse, q)
