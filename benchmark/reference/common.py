"""Shared plain pieces: fp32 linears (or, for the control, linears whose
operands are rounded to fp8), norms, activations, chunked attention and
the comparisons."""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

FP8_MAX = 448.0     # largest float8_e4m3fn


@contextlib.contextmanager
def fp32_exact():
    """TF32 off for matmuls and convolutions while the reference runs."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8_e4m3fn with one per-tensor scale (amax / 448),
    back in fp32: the operand of an fp8 GEMM. The gradient passes through
    as if unrounded (straight through)."""
    t = t.float()
    s = t.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    q = (t.detach() / s).to(torch.float8_e4m3fn).float() * s
    return t + (q - t.detach())


class Linear:
    """y = x @ W^T + b in fp32; `fp8=True` (the control) rounds both
    operands to fp8 first, as an fp8 GEMM would."""

    def __init__(self, fp8: bool = False):
        self.fp8 = fp8

    def __call__(self, x: torch.Tensor, w: torch.Tensor,
                 b: Optional[torch.Tensor] = None) -> torch.Tensor:
        x, w = x.float(), w.float()
        if self.fp8:
            x, w = fp8_round(x), fp8_round(w)
        y = x @ w.t()
        return y if b is None else y + b.float()


def layer_norm(x, w=None, b=None, eps=1e-6):
    return F.layer_norm(x.float(), x.shape[-1:],
                        None if w is None else w.float(),
                        None if b is None else b.float(), eps)


def rms_norm(x, w, eps=1e-6):
    x = x.float()
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * w.float()


def gelu_tanh(x):
    return F.gelu(x, approximate="tanh")


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              budget: int = 1 << 29) -> torch.Tensor:
    """softmax(q k^T / sqrt(D)) v of one sample over all its keys: q
    [Lq, N, D], k / v [Lk, N, D] fp32 -> [Lq, N, D], in blocks of heads
    and queries whose scores hold at most `budget` elements."""
    lq, n, d = q.shape
    lk = k.shape[0]
    qh, kh, vh = (t.float().transpose(0, 1) for t in (q, k, v))
    out = torch.empty((n, lq, d), dtype=torch.float32, device=q.device)
    heads = max(1, min(n, budget // (lk * min(lq, 4096))))
    rows = max(1, min(lq, budget // (lk * heads)))
    scale = 1.0 / math.sqrt(d)
    for h0 in range(0, n, heads):
        kt = kh[h0:h0 + heads].transpose(1, 2)
        for r0 in range(0, lq, rows):
            s = torch.matmul(qh[h0:h0 + heads, r0:r0 + rows], kt)
            s.mul_(scale)
            p = torch.softmax(s, dim=-1)
            del s
            out[h0:h0 + heads, r0:r0 + rows] = torch.matmul(
                p, vh[h0:h0 + heads])
            del p
    return out.transpose(0, 1)


def _attention_block(q, k, v, fp8):
    s = torch.einsum("rnd,knd->nrk", q, k) / math.sqrt(q.shape[-1])
    p = torch.softmax(s, dim=-1)
    return torch.einsum("nrk,knd->rnd", fp8_round(p) if fp8 else p, v)


def attention_grad(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   fp8: bool = False, rows: int = 1024) -> torch.Tensor:
    """`attention` for autograd: each block of queries is checkpointed,
    so its scores are recomputed in the backward, never kept. `fp8` (the
    training control): q, k, v and the probabilities rounded to fp8, as
    an fp8 attention kernel would take them."""
    if fp8:
        q, k, v = fp8_round(q), fp8_round(k), fp8_round(v)
    return torch.cat([torch.utils.checkpoint.checkpoint(
        _attention_block, q[r:r + rows], k, v, fp8, use_reentrant=False)
        for r in range(0, q.shape[0], rows)])


def worst_frame_rel(got: torch.Tensor, want: torch.Tensor,
                    base: Optional[torch.Tensor] = None) -> float:
    """The largest relative L2 error over the frames (dim 1 of [C, F, H,
    W]), each against its frame of `base` (default `want`): a fault
    confined to a few frames shows in full."""
    base = want if base is None else base
    return max(rel_l2(got[:, f], want[:, f], base[:, f])
               for f in range(want.shape[1]))


def rel_l2(got: torch.Tensor, want: torch.Tensor,
           base: Optional[torch.Tensor] = None) -> float:
    """||got - want|| / ||base|| (base: want), in fp64 sums."""
    base = want if base is None else base
    num = torch.linalg.vector_norm((got.double() - want.double()))
    den = torch.linalg.vector_norm(base.double()).clamp(min=1e-300)
    return float(num / den)
