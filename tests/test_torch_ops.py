"""PyTorch port ops against the JAX package: norms, RoPE, the sinusoid,
and the plain flash-attention version against the Pallas kernel run in
interpret mode (the way tests/test_ops.py runs it on the CPU).

Inputs are made with numpy from a seed and handed to both packages.
Tolerances: fp32 elementwise ops 1e-6; attention in fp32 1e-5 (same
online softmax, other summation order); attention with bf16 compute 2e-2
(P and the inputs are rounded to bf16 at different points)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnihuman_tpu.models.wan_dit import (
    sinusoidal_embedding_1d as jax_sinusoid)
from omnihuman_tpu.ops import norms as jax_norms
from omnihuman_tpu.ops import rope as jax_rope
from omnihuman_tpu.ops.flash_pallas import pallas_flash_attention
from omnihuman_tpu_torch.models.wan_dit import sinusoidal_embedding_1d
from omnihuman_tpu_torch.ops import norms, rope
from omnihuman_tpu_torch.ops.attention import flash_attention
from omnihuman_tpu_torch.ops.flash_attention import (
    KERNELS, flash_attention_cuda, flash_attention_plain)

torch.set_num_threads(1)


def _np(x):
    return np.asarray(x, np.float32)


def test_rms_norm_matches_jax(rng):
    x = rng.normal(size=(2, 5, 24)).astype(np.float32)
    w = rng.normal(size=(24,)).astype(np.float32)
    want = jax_norms.rms_norm(jnp.asarray(x), jnp.asarray(w), eps=1e-6)
    got = norms.rms_norm(torch.from_numpy(x), torch.from_numpy(w), eps=1e-6)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-6)


@pytest.mark.parametrize("affine", [False, True])
def test_layer_norm_matches_jax(rng, affine):
    x = (rng.normal(size=(2, 5, 24)) * 3 + 1).astype(np.float32)
    w = rng.normal(size=(24,)).astype(np.float32) if affine else None
    b = rng.normal(size=(24,)).astype(np.float32) if affine else None
    want = jax_norms.layer_norm(
        jnp.asarray(x), None if w is None else jnp.asarray(w),
        None if b is None else jnp.asarray(b), eps=1e-6,
        out_dtype=jnp.float32)
    got = norms.layer_norm(
        torch.from_numpy(x), None if w is None else torch.from_numpy(w),
        None if b is None else torch.from_numpy(b), eps=1e-6,
        out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-6)


def test_adaln_modulate_matches_jax(rng):
    x, sh, sc = (rng.normal(size=(2, 4, 8)).astype(np.float32)
                 for _ in range(3))
    want = jax_norms.adaln_modulate(*map(jnp.asarray, (x, sh, sc)))
    got = norms.adaln_modulate(*map(torch.from_numpy, (x, sh, sc)))
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-6)


@pytest.mark.parametrize("kw", [
    dict(grid=(3, 4, 5), head_dim=16),
    dict(grid=(2, 3, 4), head_dim=128, seq_len=32),
    dict(grid=(2, 3, 4), head_dim=24, time_offset=3, shard_offset=5,
         shard_len=10),
])
def test_rope_tables_match_jax(kw):
    ws, wc = jax_rope.rope_angles_3d(**kw)
    s, c = rope.rope_angles_3d(**kw)
    np.testing.assert_array_equal(s.numpy(), _np(ws))
    np.testing.assert_array_equal(c.numpy(), _np(wc))


@pytest.mark.parametrize("inverse", [False, True])
def test_apply_rope_matches_jax(rng, inverse):
    x = rng.normal(size=(2, 30, 3, 16)).astype(np.float32)
    ws, wc = jax_rope.rope_angles_3d((2, 3, 4), 16, seq_len=30)
    want = jax_rope.apply_rope(jnp.asarray(x), ws, wc, inverse=inverse)
    s, c = rope.rope_angles_3d((2, 3, 4), 16, seq_len=30)
    got = rope.apply_rope(torch.from_numpy(x), s, c, inverse=inverse)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-6)


def test_sinusoid_matches_jax_in_fp32():
    t = np.array([999.0, 500.5, 0.0, 17.25], np.float32)
    want = jax_sinusoid(32, jnp.asarray(t))
    got = sinusoidal_embedding_1d(32, torch.from_numpy(t))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-6)


# ---------------------------------------------------------------------------
# flash attention: plain version vs the Pallas kernel in interpret mode

ATTN_CASES = {
    # Lk <= block_k: the Pallas `_fwd_kernel` path
    "short_k": dict(lq=40, lk=24, k_lens=None),
    # Lk > block_k: the unroll-by-2 `_fwd_kernel_u2` path
    "u2": dict(lq=32, lk=96, k_lens=(96, 61)),
    "ragged_q": dict(lq=45, lk=70, k_lens=(70, 33)),
    "k_len_zero": dict(lq=32, lk=64, k_lens=(50, 0)),
    "lk33_no_lens": dict(lq=32, lk=33, k_lens=None),
    "causal_offsets": dict(lq=40, lk=72, k_lens=(72, 60), causal=True,
                           offsets=(8, 3)),
    "window_offsets": dict(lq=64, lk=64, k_lens=None, window=(20, 5),
                           offsets=(16, 0)),
}


def _attn_case(rng, case, d, dtype):
    c = ATTN_CASES[case]
    b, n = 2, 2
    q = rng.normal(size=(b, c["lq"], n, d)).astype(np.float32)
    k = rng.normal(size=(b, c["lk"], n, d)).astype(np.float32)
    v = rng.normal(size=(b, c["lk"], n, d)).astype(np.float32)
    kl = c["k_lens"]
    kw = dict(causal=c.get("causal", False),
              window_size=c.get("window", (-1, -1)))
    jdt = jnp.float32 if dtype == "fp32" else jnp.bfloat16
    offs = c.get("offsets")
    want = pallas_flash_attention(
        jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
        k_lens=None if kl is None else jnp.asarray(np.array(kl, np.int32)),
        compute_dtype=jdt, block_q=32, block_k=32, interpret=True,
        precision=jax.lax.Precision.HIGHEST,
        offsets=None if offs is None else jnp.asarray(np.array(offs)), **kw)
    tdt = torch.float32 if dtype == "fp32" else torch.bfloat16
    got = flash_attention_plain(
        torch.from_numpy(q).to(tdt), torch.from_numpy(k).to(tdt),
        torch.from_numpy(v).to(tdt),
        k_lens=None if kl is None else torch.tensor(kl, dtype=torch.int32),
        offsets=offs, **kw)
    return got.float().numpy(), _np(jnp.asarray(want, jnp.float32)), kl


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
@pytest.mark.parametrize("d", [128, 16])
def test_flash_plain_matches_pallas_fp32(rng, case, d):
    got, want, kl = _attn_case(rng, case, d, "fp32")
    np.testing.assert_allclose(got, want, atol=1e-5)
    if kl is not None and 0 in kl:       # no valid key -> exactly 0
        assert not got[list(kl).index(0)].any()


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_flash_plain_matches_pallas_bf16(rng, case):
    got, want, _ = _attn_case(rng, case, 128, "bf16")
    np.testing.assert_allclose(got, want, atol=2e-2)


def test_flash_attention_front_end_q_scale_and_dtype(rng):
    """The front-end casts to the compute dtype, applies q_scale there and
    returns q's dtype (ops/attention.py contract)."""
    q = torch.from_numpy(rng.normal(size=(1, 10, 2, 16)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(1, 12, 2, 16)).astype(np.float32))
    out = flash_attention(q, k, k, q_scale=0.5, dtype=torch.float32)
    want = flash_attention_plain(q * 0.5, k, k)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), want.numpy(), atol=1e-6)
    assert flash_attention(q, k, k, dtype=torch.bfloat16).dtype == q.dtype


def test_kernel_counter_stays_zero_on_cpu(rng):
    q = torch.from_numpy(rng.normal(size=(2, 16, 2, 128)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(2, 1100, 2, 128)).astype(np.float32))
    flash_attention(q, q, q, k_lens=torch.tensor([16, 3]))
    flash_attention(q, k, k)
    assert [kn.launches for kn in KERNELS] == [0, 0]


def test_kernel_wrapper_refuses_cpu_tensors():
    q = torch.zeros(1, 8, 1, 128, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, q, q)
