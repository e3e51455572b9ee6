"""Sequence-parallel attention over the `sp` mesh axis, forward only (port
of omnihuman_tpu/ops/ring_attention.py).

Each rank of the `sp` group holds its own shard of the tokens: q / k / v
[B, L/sp, N, D], with `seq_lens` [B] the GLOBAL valid counts.

- `ring_attention`: the K / V shards travel round the ring (rank r sends
  to r - 1 and receives from r + 1, `batch_isend_irecv`); at hop i rank r
  holds the shard of rank src = (r + i) % sp and attends its queries to
  it, masked by the shard's part of seq_lens and, for causal / window
  masks, by GLOBAL token offsets (q_off, k_off) = (r * Lq, src * Lk); the
  partial results merge by their log-sum-exp (`_merge`). impl "flash"
  runs each hop as one K1 launch with the LSE (`flash_fwd(...,
  return_lse=True)`), impl "dense" as `_chunk_attention`. The next hop's
  send and receive are posted before the current hop's attention, so the
  copy overlaps the kernel.
- `ulysses_attention`: `all_to_all_single` scatters the heads and gathers
  the tokens, K1 runs over all tokens for N/sp heads, and the inverse
  all-to-all brings the output back to the token shard.
- `sp_cross_attention`: the rank's queries against the whole (replicated)
  short K / V, one local K1 call; causal / window masks fold the rank's
  offset into the kernel's q offset.

`ring_forward_hop`, `ulysses_local` with the `ulysses_split_* / gather_*`
buffer layouts, and `sp_cross_local` are a rank's work apart from its
collectives; the distributed functions and a one-process replay of every
rank's program (chip_smoke.py) run the same code. The K1 kernel writes an LSE of NEG_INF (-1e30, finite) on a
row with no valid key, where JAX's chunks write -inf: `_merge` treats both
as empty, so a row empty in every chunk comes out 0 and a row empty in
some chunks gets exactly the other chunks' result.

Under autograd these raise: the ring backward through K2 is the next part
of ROADMAP queue A, item 19.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from omnihuman_tpu_torch.ops.flash_attention import NEG_INF, flash_fwd
from omnihuman_tpu_torch.parallel.mesh import AXIS_SP

BACKWARD_SLICE = ("the sequence-parallel backward (the ring through K2) "
                  "comes with ROADMAP queue A, item 19")


def _no_grad_only(*xs) -> None:
    if torch.is_grad_enabled() and any(x.requires_grad for x in xs):
        raise NotImplementedError(
            f"sequence-parallel attention is forward only: "
            f"{BACKWARD_SLICE}")


def _masked(causal: bool, window: Tuple[int, int]) -> bool:
    return bool(causal) or tuple(window) != (-1, -1)


def _chunk_attention(q, k, v, k_len, scale: float, compute_dtype,
                     causal: bool = False, window=(-1, -1), q_off: int = 0,
                     k_off: int = 0):
    """Dense attention of one chunk -> (normalised out [B, Lq, N, D] fp32,
    lse [B, N, Lq] fp32); a row with no valid key gets out 0 and lse
    -inf. q_off / k_off: the chunk's GLOBAL token offsets for the causal /
    window masks."""
    lq, lk = q.shape[1], k.shape[1]
    dev = q.device
    logits = torch.einsum("bqnd,bknd->bnqk", q.to(compute_dtype).float(),
                          k.to(compute_dtype).float()) * scale
    mask = (torch.arange(lk, device=dev)[None, None, None, :]
            < k_len.reshape(-1, 1, 1, 1))
    if _masked(causal, window):
        qg = torch.arange(lq, device=dev)[None, None, :, None] + q_off
        kg = torch.arange(lk, device=dev)[None, None, None, :] + k_off
        if causal:
            mask = mask & (kg <= qg)
        left, right = window
        if left >= 0:
            mask = mask & (qg - kg <= left)
        if right >= 0:
            mask = mask & (kg - qg <= right)
    logits = logits.masked_fill(~mask, float("-inf"))
    m = logits.amax(dim=-1)                                  # [B, N, Lq]
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(logits - m_safe[..., None]) * mask
    l = p.sum(dim=-1)
    o = torch.einsum("bnqk,bknd->bqnd", p.to(compute_dtype).float(),
                     v.to(compute_dtype).float())
    l_safe = torch.where(l > 0, l, torch.ones_like(l))
    o = o / l_safe.transpose(1, 2)[..., None]
    lse = torch.where(l > 0, m_safe + torch.log(l_safe),
                      torch.full_like(l, float("-inf")))
    return o, lse


def _merge(o0, lse0, o1, lse1):
    """Two normalised partial attentions ([B, Lq, N, D] fp32, lse [B, N, Lq]
    fp32) combined by their LSE weights (JAX `_merge`). An lse of -inf or
    at most NEG_INF marks a row with no valid key in that part."""
    ok0, ok1 = lse0 > NEG_INF, lse1 > NEG_INF
    m = torch.maximum(torch.where(ok0, lse0, torch.full_like(lse0, -1e38)),
                      torch.where(ok1, lse1, torch.full_like(lse1, -1e38)))
    m_safe = torch.where(ok0 | ok1, m, torch.zeros_like(m))
    w0 = torch.where(ok0, torch.exp(lse0 - m_safe), torch.zeros_like(m))
    w1 = torch.where(ok1, torch.exp(lse1 - m_safe), torch.zeros_like(m))
    denom = torch.clamp(w0 + w1, min=1e-30)

    def bw(x):   # [B, N, Lq] -> [B, Lq, N, 1]
        return x.transpose(1, 2)[..., None]

    o = o0 * bw(w0 / denom) + o1 * bw(w1 / denom)
    lse = torch.where(denom > 1e-30, m_safe + torch.log(denom),
                      torch.full_like(m, float("-inf")))
    return o, lse


def ring_forward_hop(q, k_chunk, v_chunk, k_len_chunk, o_acc=None,
                     lse_acc=None, offsets: Optional[Tuple[int, int]] = None,
                     *, scale: float, causal: bool = False, window=(-1, -1),
                     impl: str = "flash", compute_dtype=torch.bfloat16):
    """One hop of the ring: q [B, Lq, N, D] against one K / V chunk [B, Lk,
    N, D] with its valid lengths k_len_chunk [B] (clamped to [0, Lk]),
    merged into the running (o_acc [B, Lq, N, D], lse_acc [B, N, Lq] fp32);
    merged results are fp32. The first hop passes no accumulator and gets
    its chunk's own (out, lse): at sp 1 the ring is one K1 call. `offsets`
    = (q_off, k_off) in global tokens, used only with a causal / window
    mask. impl "flash": one K1 launch with the LSE; "dense":
    `_chunk_attention`."""
    q_off, k_off = offsets if offsets is not None else (0, 0)
    if impl == "flash":
        o_i, lse_i = flash_fwd(
            q, k_chunk, v_chunk, k_lens=k_len_chunk, softmax_scale=scale,
            causal=causal, window_size=tuple(window),
            offsets=(q_off, k_off) if _masked(causal, window) else None,
            return_lse=True)
    elif impl == "dense":
        o_i, lse_i = _chunk_attention(q, k_chunk, v_chunk, k_len_chunk,
                                      scale, compute_dtype, causal, window,
                                      q_off, k_off)
    else:
        raise ValueError(f"unknown ring impl {impl!r}: 'flash' or 'dense'")
    if o_acc is None:
        return o_i, lse_i
    return _merge(o_acc.float(), lse_acc, o_i.float(), lse_i)


def _sp(mesh):
    sub = mesh[AXIS_SP]
    return sub.get_group(), int(sub.get_local_rank()), int(sub.size())


def _seq_lens(seq_lens, b: int, l: int, device) -> torch.Tensor:
    if seq_lens is None:
        return torch.full((b,), l, dtype=torch.int32, device=device)
    return torch.as_tensor(seq_lens, device=device).to(torch.int32)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh,
                   seq_lens: Optional[torch.Tensor] = None,
                   softmax_scale: Optional[float] = None,
                   compute_dtype=torch.bfloat16, impl: str = "flash",
                   causal: bool = False,
                   window_size: Tuple[int, int] = (-1, -1)) -> torch.Tensor:
    """Attention of this rank's query shard against every rank's K / V
    shard: q / k / v [B, L/sp, N, D] (L/sp equal on every rank), seq_lens
    [B] the global valid counts; returns [B, L/sp, N, D] in q's dtype.
    Causal / window masks are in global token coordinates."""
    _no_grad_only(q, k, v)
    b, lq, n, d = q.shape
    lk = k.shape[1]
    group, rank, sp = _sp(mesh)
    scale = float(softmax_scale if softmax_scale is not None else d ** -0.5)
    lens = _seq_lens(seq_lens, b, lq * sp, q.device)
    qc, k_cur, v_cur = (x.to(compute_dtype).contiguous() for x in (q, k, v))
    send_to = dist.get_global_rank(group, (rank - 1) % sp)
    recv_from = dist.get_global_rank(group, (rank + 1) % sp)
    o = lse = None
    for i in range(sp):
        src = (rank + i) % sp
        reqs = []
        if i < sp - 1:       # the next hop's chunk, in flight meanwhile
            k_nxt, v_nxt = torch.empty_like(k_cur), torch.empty_like(v_cur)
            reqs = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, k_cur, send_to, group),
                dist.P2POp(dist.isend, v_cur, send_to, group),
                dist.P2POp(dist.irecv, k_nxt, recv_from, group),
                dist.P2POp(dist.irecv, v_nxt, recv_from, group)])
        k_len = (lens - src * lk).clamp(0, lk)
        o, lse = ring_forward_hop(
            qc, k_cur, v_cur, k_len, o, lse, (rank * lq, src * lk),
            scale=scale, causal=causal, window=window_size, impl=impl,
            compute_dtype=compute_dtype)
        for r in reqs:
            r.wait()
        if reqs:
            k_cur, v_cur = k_nxt, v_nxt
    if impl == "flash":     # the kernel's output dtype first, as in JAX
        o = o.to(compute_dtype)
    return o.to(q.dtype)


def sp_cross_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       mesh, k_lens: Optional[torch.Tensor] = None,
                       softmax_scale: Optional[float] = None,
                       q_scale: Optional[float] = None, causal: bool = False,
                       window_size: Tuple[int, int] = (-1, -1),
                       compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Cross-attention of this rank's query shard [B, L/sp, N, D] to the
    whole short K / V [B, Lk, N, D] (the same on every rank): one local K1
    call, no collective (`sp_cross_local` at this rank)."""
    _no_grad_only(q, k, v)
    _, rank, sp = _sp(mesh)
    return sp_cross_local(q, k, v, rank, sp, k_lens=k_lens,
                          softmax_scale=softmax_scale, q_scale=q_scale,
                          causal=causal, window_size=window_size,
                          compute_dtype=compute_dtype)


def sp_cross_local(q, k, v, rank: int, sp: int, k_lens=None,
                   softmax_scale: Optional[float] = None,
                   q_scale: Optional[float] = None, causal: bool = False,
                   window_size: Tuple[int, int] = (-1, -1),
                   compute_dtype=torch.bfloat16) -> torch.Tensor:
    """sp_cross's work on rank `rank` of `sp`. A causal / window mask is
    evaluated in global query coordinates: the kernel's diagonal (Lk -
    Lq_local) is moved to the unsharded call's (Lk - L) + rank * Lq_local
    through the q offset."""
    from omnihuman_tpu_torch.ops.attention import single_device_attention
    lq = q.shape[1]
    offsets = None
    if _masked(causal, window_size):
        offsets = ((rank + 1) * lq - sp * lq, 0)
    return single_device_attention(
        q, k, v, k_lens=k_lens, softmax_scale=softmax_scale,
        q_scale=q_scale, causal=causal, window_size=window_size,
        dtype=compute_dtype, offsets=offsets)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      mesh, seq_lens: Optional[torch.Tensor] = None,
                      softmax_scale: Optional[float] = None,
                      compute_dtype=torch.bfloat16, impl: str = "flash",
                      causal: bool = False,
                      window_size: Tuple[int, int] = (-1, -1)
                      ) -> torch.Tensor:
    """Head-scatter sequence parallelism (num_heads % sp == 0): q / k / v
    [B, L/sp, N, D] -> [B, L, N/sp, D] by one all-to-all each, attention
    over all tokens for this rank's heads (`ulysses_local`), and the
    inverse all-to-all back to [B, L/sp, N, D]. Each all-to-all sends
    part j of its [sp, ...] buffer to rank j and receives rank j's part
    for this rank into part j."""
    _no_grad_only(q, k, v)
    b, ls, n, d = q.shape
    group, _, sp = _sp(mesh)
    assert n % sp == 0, f"num_heads {n} not divisible by sp {sp}"
    lens = _seq_lens(seq_lens, b, ls * sp, q.device)

    def exchange(x):
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=group)
        return out

    qh, kh, vh = (ulysses_gather_tokens(exchange(
        ulysses_split_heads(x.to(compute_dtype), sp))) for x in (q, k, v))
    o = ulysses_local(qh, kh, vh, lens, softmax_scale=softmax_scale,
                      compute_dtype=compute_dtype, impl=impl, causal=causal,
                      window_size=window_size)
    return ulysses_gather_heads(exchange(
        ulysses_split_tokens(o.to(q.dtype), sp)))


def ulysses_split_heads(x, sp: int):
    """[B, Ls, N, D] -> the send buffer [sp, B, Ls, N/sp, D], part j the
    heads of rank j."""
    b, ls, n, d = x.shape
    return x.reshape(b, ls, sp, n // sp, d).permute(2, 0, 1, 3, 4
                                                    ).contiguous()


def ulysses_gather_tokens(buf):
    """The received [sp, B, Ls, N/sp, D] (part j rank j's tokens) -> [B, L,
    N/sp, D], tokens in rank order."""
    sp, b, ls, nh, d = buf.shape
    return buf.permute(1, 0, 2, 3, 4).reshape(b, sp * ls, nh, d
                                              ).contiguous()


def ulysses_split_tokens(o, sp: int):
    """[B, L, N/sp, D] -> the send buffer [sp, B, Ls, N/sp, D], part j the
    tokens of rank j."""
    b, l, nh, d = o.shape
    return o.reshape(b, sp, l // sp, nh, d).permute(1, 0, 2, 3, 4
                                                    ).contiguous()


def ulysses_gather_heads(buf):
    """The received [sp, B, Ls, N/sp, D] (part j rank j's heads) -> [B, Ls,
    N, D]."""
    sp, b, ls, nh, d = buf.shape
    return buf.permute(1, 2, 0, 3, 4).reshape(b, ls, sp * nh, d)


def ulysses_local(qh, kh, vh, seq_lens, softmax_scale: Optional[float] = None,
                  compute_dtype=torch.bfloat16, impl: str = "flash",
                  causal: bool = False,
                  window_size: Tuple[int, int] = (-1, -1)) -> torch.Tensor:
    """Ulysses' work on one rank: attention of [B, L, N/sp, D] over all
    tokens with the global valid counts seq_lens [B]; impl "flash" is one
    K1 launch, "dense" `_chunk_attention`."""
    scale = float(softmax_scale if softmax_scale is not None
                  else qh.shape[-1] ** -0.5)
    if impl == "flash":
        return flash_fwd(qh, kh, vh, k_lens=seq_lens, softmax_scale=scale,
                         causal=causal, window_size=tuple(window_size))
    if impl == "dense":
        return _chunk_attention(qh, kh, vh, seq_lens, scale, compute_dtype,
                                causal, window_size)[0]
    raise ValueError(f"unknown ulysses impl {impl!r}")
