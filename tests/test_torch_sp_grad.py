"""The gradients of the port's sequence-parallel attention
(ops/ring_attention.py: the ring's backward through K2 / its plain
version, Ulysses' exchanges around FlashAttention, sp_cross) against
`jax.grad` through the JAX package's on its virtual CPU mesh.

The port runs as 4 gloo processes (tests/torch_sp_workers.py, spawned once
for the file) on a (2, 1, 2) mesh and a (1, 1, 4) one, each rank holding
its 1/sp of the tokens of q / k / v and of the cotangent dO and
back-propagating sum(out * dO); JAX differentiates the same sum through
`shard_map` on (data 4, fsdp 1, sp 2) and (data 2, fsdp 1, sp 4) (for
Ulysses, whose JAX version does not differentiate under the installed
JAX, through JAX's ring on the same inputs: the same function). The
cases: varlen lengths with a sample of k_len 0 (19 of 32 valid keys:
empty in the last chunk at sp 4, in none at sp 2), causal and (5, 3)
window masks at global offsets, the ring's flash and dense impls, Ulysses
(4 heads), sp_cross against 12 replicated keys (lengths 12 and 5) whose
dK / dV are each rank's part of a sum over the ranks. fp32 on both sides,
tolerance 2e-4 (the forward tests' tolerance, on gradients of O(1)).

The replay tests chain `ring_backward_hop` over every rank's hops in one
process (the chip smoke's check at flagship width, here small) and hold
the concatenated dQ / dK / dV to one flash backward over the whole."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnihuman_tpu.ops import ring_attention as jra
from omnihuman_tpu.parallel import MeshConfig as JaxMeshConfig
from omnihuman_tpu.parallel import create_mesh as jax_create_mesh
from omnihuman_tpu_torch.ops import ring_attention as ra
from omnihuman_tpu_torch.ops.flash_attention import (
    bwd_delta, flash_attention_plain, flash_bwd)
from torch_sp_workers import Ranks

torch.set_num_threads(1)

TOL = dict(atol=2e-4, rtol=2e-4)
SPS = (2, 4)
RING_MASKS = {"lens": {}, "causal": {"causal": True},
              "window": {"window_size": (5, 3)}}
CROSS_MASKS = {"lens": {}, "window": {"window_size": (4, 2)}}


def _inputs():
    rng = np.random.default_rng(0)

    def rnd(*shape):
        return rng.normal(size=shape).astype(np.float32)

    return {"q": rnd(2, 32, 2, 16), "k": rnd(2, 32, 2, 16),
            "v": rnd(2, 32, 2, 16), "do": rnd(2, 32, 2, 16),
            "lens": np.array([19, 0], np.int32),
            "qh": rnd(2, 32, 4, 16), "kh": rnd(2, 32, 4, 16),
            "vh": rnd(2, 32, 4, 16), "doh": rnd(2, 32, 4, 16),
            "kc": rnd(2, 12, 2, 16), "vc": rnd(2, 12, 2, 16),
            "klens": np.array([12, 5], np.int32),
            "ring_masks": RING_MASKS, "cross_masks": CROSS_MASKS}


def _jax_cases(j):
    f32 = jnp.float32
    out = {}

    def grads(fn, q, k, v, do):
        return jax.grad(lambda q, k, v: jnp.sum(fn(q, k, v) * do),
                        argnums=(0, 1, 2))(q, k, v)

    for sp in SPS:
        mesh = jax_create_mesh(JaxMeshConfig(data=8 // sp, fsdp=1, sp=sp))
        for impl in ("flash", "dense"):
            for tag, kw in RING_MASKS.items():
                out[f"sp{sp}_ring_{impl}_{tag}"] = grads(
                    lambda q, k, v: jra.ring_attention(
                        q, k, v, mesh, seq_lens=j["lens"],
                        compute_dtype=f32, impl=impl, **kw),
                    j["q"], j["k"], j["v"], j["do"])
            # JAX's Ulysses does not differentiate (the installed JAX's
            # all_to_all transpose gives a cotangent of the wrong shape):
            # its yardstick is JAX's ring on the same inputs and mesh,
            # which computes the same attention
            out[f"sp{sp}_ulysses_{impl}"] = grads(
                lambda q, k, v: jra.ring_attention(
                    q, k, v, mesh, seq_lens=j["lens"], compute_dtype=f32,
                    impl=impl),
                j["qh"], j["kh"], j["vh"], j["doh"])
        for tag, kw in CROSS_MASKS.items():
            out[f"sp{sp}_sp_cross_{tag}"] = grads(
                lambda q, k, v: jra.sp_cross_attention(
                    q, k, v, mesh, k_lens=j["klens"], compute_dtype=f32,
                    **kw),
                j["q"], j["kc"], j["vc"], j["do"])
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    p = _inputs()
    ranks = Ranks(4, "attention_grads", p, tmp_path_factory.mktemp("grad"))
    arrays = {k: jnp.asarray(v) for k, v in p.items()
              if isinstance(v, np.ndarray)}
    want = jax.tree.map(np.asarray, jax.jit(_jax_cases)(arrays))
    return ranks.results(), want


CASES = [f"sp{sp}_{c}" for sp in SPS for c in (
    [f"ring_{i}_{t}" for i in ("flash", "dense") for t in RING_MASKS]
    + ["ulysses_flash", "ulysses_dense"]
    + [f"sp_cross_{t}" for t in CROSS_MASKS])]


@pytest.mark.parametrize("case", CASES)
def test_sp_attention_gradients_match_jax(results, case):
    """dq / dk / dv of every rank's shard, concatenated in sp order (global
    rank d * sp + r is sp rank r of data group d; both groups hold the
    same), against JAX's. sp_cross's K / V are whole on every rank: the
    sum of the ranks' dk / dv is the gradient."""
    ranks, want = results
    sp = int(case[2])
    got = []
    for i, w in enumerate(want[case]):
        for d in range(4 // sp):
            per = [ranks[d * sp + r][case][i] for r in range(sp)]
            whole = (sum(per) if case.split("_", 1)[1].startswith("sp_cross")
                     and i > 0 else torch.cat(per, dim=1))
            assert torch.isfinite(whole).all(), (case, i)
            np.testing.assert_allclose(whole.numpy(), w, **TOL,
                                       err_msg=f"{case} grad {i} group {d}")
        got.append(whole)
    # the sample with no valid key gets no gradient
    if "ring" in case:
        assert all(float(g[1].abs().max()) == 0.0 for g in got)


def _replay(q, k, v, do, lens, sp, **mask):
    """Every rank's ring backward in one process: the forward hops give the
    merged out / LSE of rank r's queries, then `ring_backward_hop` over
    the chunks in ring order, dK / dV summed per chunk."""
    lq = q.shape[1] // sp
    scale = q.shape[-1] ** -0.5
    sl = [slice(r * lq, (r + 1) * lq) for r in range(sp)]
    dq = [torch.zeros_like(q[:, s]) for s in sl]
    dk = [torch.zeros_like(k[:, s]) for s in sl]
    dv = [torch.zeros_like(v[:, s]) for s in sl]
    for r in range(sp):
        o = lse = None
        order = [(r + i) % sp for i in range(sp)]
        for src in order:
            o, lse = ra.ring_forward_hop(
                q[:, sl[r]], k[:, sl[src]], v[:, sl[src]],
                (lens - src * lq).clamp(0, lq), o, lse, (r * lq, src * lq),
                scale=scale, compute_dtype=torch.float32, **mask)
        delta = bwd_delta(o, do[:, sl[r]])
        for src in order:
            k_i, v_i = ra.ring_backward_hop(
                q[:, sl[r]], k[:, sl[src]], v[:, sl[src]], o, do[:, sl[r]],
                lse, delta, (lens - src * lq).clamp(0, lq), dq[r],
                (r * lq, src * lq), scale=scale, **mask)
            dk[src] += k_i
            dv[src] += v_i
    return [torch.cat(x, dim=1) for x in (dq, dk, dv)]


@pytest.mark.parametrize("mask", list(RING_MASKS))
def test_ring_backward_replay_equals_one_call(mask):
    """`ring_backward_hop` chained over every rank's hops at sp 3 (a sample
    empty in its last chunk and one with no valid key) equals one flash
    backward over all 24 tokens with the whole LSE."""
    rng = np.random.default_rng(8)
    q, k, v, do = (torch.from_numpy(rng.normal(size=(2, 24, 2, 16)).astype(
        np.float32)) for _ in range(4))
    lens = torch.tensor([13, 0], dtype=torch.int32)
    kw = RING_MASKS[mask]
    mkw = {"causal": kw.get("causal", False),
           "window": kw.get("window_size", (-1, -1))}
    got = _replay(q, k, v, do, lens, 3, **mkw)
    out, lse = flash_attention_plain(q, k, v, lens, causal=mkw["causal"],
                                     window_size=mkw["window"],
                                     return_lse=True)
    want = flash_bwd(q, k, v, out, lse, do, lens, causal=mkw["causal"],
                     window_size=mkw["window"])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL)
        assert float(g[1].abs().max()) == 0.0


def test_ring_backward_hop_rejects_an_unknown_impl():
    x = torch.zeros(1, 4, 2, 16)
    lse = torch.zeros(1, 2, 4)
    with pytest.raises(ValueError, match="unknown ring impl"):
        ra.ring_backward_hop(x, x, x, x, x, lse, lse,
                             torch.tensor([4]), torch.zeros_like(x),
                             scale=0.25, impl="sparse")
