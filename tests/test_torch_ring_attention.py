"""The port's sequence-parallel attention (ops/ring_attention.py) against
the JAX package's on the 8-device virtual CPU mesh, sp 4.

The port runs as 4 gloo processes (tests/torch_sp_workers.py, spawned
once for the file), each holding its quarter of the tokens; JAX runs
`shard_map` over (data 2, fsdp 1, sp 4). Inputs come from a numpy seed,
fp32 on both sides; tolerance 2e-4 (as tests/test_ring_attention.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnihuman_tpu.ops import ring_attention as jra
from omnihuman_tpu.ops.attention import flash_attention as jax_attention
from omnihuman_tpu.parallel import MeshConfig as JaxMeshConfig
from omnihuman_tpu.parallel import create_mesh as jax_create_mesh
from omnihuman_tpu.parallel.mesh import use_mesh as jax_use_mesh
from omnihuman_tpu_torch.ops import ring_attention as ra
from omnihuman_tpu_torch.ops.attention import flash_attention
from omnihuman_tpu_torch.ops.flash_attention import NEG_INF, flash_fwd
from torch_sp_workers import Ranks

torch.set_num_threads(1)

TOL = dict(atol=2e-4, rtol=2e-4)
RING_MASKS = {"lens": {}, "causal": {"causal": True},
              "window": {"window_size": (5, 3)}}
CROSS_MASKS = {"lens": {}, "window": {"window_size": (4, 2)}}


def _inputs():
    rng = np.random.default_rng(0)

    def rnd(*shape):
        return rng.normal(size=shape).astype(np.float32)

    # lens [20, 9] of 32 over 4 shards of 8: sample 0's last shard and
    # sample 1's last two are fully masked (JAX's varlen case)
    return {"q": rnd(2, 32, 2, 16), "k": rnd(2, 32, 2, 16),
            "v": rnd(2, 32, 2, 16), "lens": np.array([20, 9], np.int32),
            "qh": rnd(2, 32, 4, 16), "kh": rnd(2, 32, 4, 16),
            "vh": rnd(2, 32, 4, 16), "kc": rnd(2, 12, 2, 16),
            "vc": rnd(2, 12, 2, 16), "klens": np.array([12, 7], np.int32),
            "ring_masks": RING_MASKS, "cross_masks": CROSS_MASKS}


def _jax_results(p):
    """Every JAX case, traced into one program (one compile)."""
    arrays = {k: jnp.asarray(v) for k, v in p.items()
              if isinstance(v, np.ndarray)}
    return {k: np.asarray(v) for k, v in jax.jit(_jax_cases)(arrays).items()}


def _jax_cases(j):
    mesh = jax_create_mesh(JaxMeshConfig(data=2, fsdp=1, sp=4))
    f32 = jnp.float32
    out = {}
    for impl in ("flash", "dense"):
        for tag, kw in RING_MASKS.items():
            out[f"ring_{impl}_{tag}"] = jra.ring_attention(
                j["q"], j["k"], j["v"], mesh, seq_lens=j["lens"],
                compute_dtype=f32, impl=impl, **kw)
        out[f"ulysses_{impl}"] = jra.ulysses_attention(
            j["qh"], j["kh"], j["vh"], mesh, seq_lens=j["lens"],
            compute_dtype=f32, impl=impl)
    for tag, kw in CROSS_MASKS.items():
        out[f"sp_cross_{tag}"] = jra.sp_cross_attention(
            j["q"], j["kc"], j["vc"], mesh, k_lens=j["klens"],
            compute_dtype=f32, **kw)
    with jax_use_mesh(mesh):
        out["dispatch_ring_qscale"] = jax_attention(
            j["q"], j["k"], j["v"], k_lens=j["lens"], q_scale=0.5,
            dtype=f32, implementation="ring")
        out["dispatch_sp_cross"] = jax_attention(
            j["q"], j["kc"], j["vc"], k_lens=j["klens"], dtype=f32,
            implementation="sp_cross")
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    p = _inputs()
    ranks = Ranks(4, "attention", p, tmp_path_factory.mktemp("ring"))
    want = _jax_results(p)
    ranks = ranks.results()
    # rank r of the (1, 1, 4) mesh is sp rank r: its token quarter
    got = {k: torch.cat([r[k] for r in ranks], dim=1).numpy()
           for k in ranks[0]}
    return got, want


CASES = ([f"ring_{i}_{t}" for i in ("flash", "dense") for t in RING_MASKS]
         + ["ulysses_flash", "ulysses_dense", "sp_cross_lens",
            "sp_cross_window", "dispatch_ring_qscale", "dispatch_sp_cross"])


@pytest.mark.parametrize("case", CASES)
def test_sp_attention_matches_jax(results, case):
    got, want = results
    assert got[case].shape == want[case].shape
    np.testing.assert_allclose(got[case], want[case], **TOL)


def _partials(rng):
    """Two partial attentions over [B=1, Lq=4, N=2, D=8]: row 0 empty in
    both (the kernel's -1e30 in one, JAX's -inf in the other), row 1
    empty in the first, rows 2-3 valid in both."""
    o0 = rng.normal(size=(1, 4, 2, 8)).astype(np.float32)
    o1 = rng.normal(size=(1, 4, 2, 8)).astype(np.float32)
    o0[:, :2] = 0.0
    o1[:, 0] = 0.0
    lse0 = rng.normal(size=(1, 2, 4)).astype(np.float32)
    lse1 = rng.normal(size=(1, 2, 4)).astype(np.float32)
    lse0[:, :, 0], lse1[:, :, 0] = NEG_INF, -np.inf
    lse0[:, :, 1] = -np.inf
    return o0, lse0, o1, lse1


def test_merge_empty_rows():
    """A row with no valid key in any chunk comes out exactly 0 (not NaN)
    whichever sentinel marks it; a row empty in some chunks gets JAX's
    result, i.e. the other chunks' exactly."""
    o0, lse0, o1, lse1 = _partials(np.random.default_rng(3))
    o, lse = ra._merge(*(torch.from_numpy(a) for a in (o0, lse0, o1, lse1)))
    assert torch.isfinite(o).all()
    assert (o[:, 0] == 0).all() and torch.isneginf(lse[:, :, 0]).all()
    np.testing.assert_array_equal(o[:, 1].numpy(), o1[:, 1])
    # JAX's merge reads -inf as empty: give it -inf where the kernel's
    # sentinel stands
    jo, jl = jra._merge(jnp.asarray(o0), jnp.asarray(np.where(
        lse0 <= NEG_INF, -np.inf, lse0)), jnp.asarray(o1), jnp.asarray(lse1))
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=1e-6)
    np.testing.assert_allclose(lse.numpy()[:, :, 1:], np.asarray(jl)[:, :, 1:],
                               atol=1e-6)


def test_ring_hop_chain_equals_one_call():
    """`ring_forward_hop` over every chunk of a one-process replay of rank
    1's program equals attention over the whole (the chip smoke's check at
    flagship width, here at a small one)."""
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 24, 2, 16)).astype(
        np.float32)) for _ in range(3))
    lens = torch.tensor([17], dtype=torch.int32)
    sp, lq = 3, 8
    rank = 1
    qs = q[:, rank * lq:(rank + 1) * lq]
    o = lse = None
    for i in range(sp):
        src = (rank + i) % sp
        o, lse = ra.ring_forward_hop(
            qs, k[:, src * lq:(src + 1) * lq], v[:, src * lq:(src + 1) * lq],
            (lens - src * lq).clamp(0, lq), o, lse, (rank * lq, src * lq),
            scale=16 ** -0.5)
    want = flash_attention(q, k, v, k_lens=lens, dtype=torch.float32)
    np.testing.assert_allclose(o.numpy(), want[:, rank * lq:(rank + 1) * lq],
                               **TOL)


def test_first_hop_is_one_kernel_call():
    """With no accumulator a hop returns its chunk's K1 result as the
    kernel gives it, so a ring of one hop (sp 1) is one K1 call."""
    rng = np.random.default_rng(6)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 8, 2, 16)).astype(
        np.float32)) for _ in range(3))
    lens = torch.tensor([8, 3], dtype=torch.int32)
    o, lse = ra.ring_forward_hop(q, k, v, lens, scale=16 ** -0.5)
    want_o, want_lse = flash_fwd(q, k, v, k_lens=lens,
                                 softmax_scale=16 ** -0.5, return_lse=True)
    assert o.dtype == want_o.dtype
    torch.testing.assert_close(o, want_o, rtol=0, atol=0)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=0)


def test_ulysses_replay_equals_one_call():
    """Every rank's Ulysses program replayed in one process, the
    all-to-all emulated (rank r receives part r of every rank's buffer):
    the buffer layouts and `ulysses_local` give the whole call's rows."""
    rng = np.random.default_rng(7)
    sp, ls = 2, 8
    q, k, v = (torch.from_numpy(rng.normal(size=(1, sp * ls, 4, 16)).astype(
        np.float32)) for _ in range(3))
    lens = torch.tensor([13], dtype=torch.int32)

    def exchange(bufs):
        return [torch.stack([b[r] for b in bufs]) for r in range(sp)]

    def heads(x):
        return [ra.ulysses_gather_tokens(buf) for buf in exchange(
            [ra.ulysses_split_heads(x[:, r * ls:(r + 1) * ls], sp)
             for r in range(sp)])]

    outs = [ra.ulysses_local(qh, kh, vh, lens, compute_dtype=torch.float32)
            for qh, kh, vh in zip(heads(q), heads(k), heads(v))]
    got = torch.cat([ra.ulysses_gather_heads(buf) for buf in exchange(
        [ra.ulysses_split_tokens(o, sp) for o in outs])], dim=1)
    want = flash_attention(q, k, v, k_lens=lens, dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_no_mesh_takes_the_single_device_route():
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 8, 2, 16)).astype(
        np.float32)) for _ in range(3))
    want = flash_attention(q, k, v, dtype=torch.float32)
    for impl in ("ring", "ulysses", "sp_cross"):
        got = flash_attention(q, k, v, dtype=torch.float32,
                              implementation=impl)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
