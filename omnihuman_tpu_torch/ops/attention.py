"""Attention front-end (port of omnihuman_tpu/ops/attention.py).

Same call contract as the JAX `flash_attention` (and the reference's
flash-attn shim, wan/modules/attention.py:24-179):
    q [B, Lq, N, D], k / v [B, Lk, N, D]
    k_lens [B] int32 per-sample valid key lengths
    window_size (left, right), causal, softmax_scale, q_scale

A CPU tensor goes to the plain PyTorch version, a CUDA tensor to the
hand-written Hopper kernel (ops/flash_attention.py); there is no other
back-end and no fallback between them. The sequence-parallel paths
(ring / ulysses / sp_cross) come with the multi-GPU work.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from omnihuman_tpu_torch.ops.flash_attention import flash_fwd


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_lens: Optional[torch.Tensor] = None,
    k_lens: Optional[torch.Tensor] = None,
    dropout_p: float = 0.0,
    softmax_scale: Optional[float] = None,
    q_scale: Optional[float] = None,
    causal: bool = False,
    window_size: Tuple[int, int] = (-1, -1),
    deterministic: bool = True,
    dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Masked attention, computed in `dtype`, returned in q's dtype.

    q_lens is accepted for parity: rows past q_lens[b] produce values the
    caller never reads. dropout is not used on the serving path and is
    not implemented."""
    del q_lens, deterministic
    if dropout_p:
        raise NotImplementedError("attention dropout is not implemented")
    out_dtype = q.dtype
    qc = q.to(dtype)
    if q_scale is not None:
        qc = qc * torch.tensor(q_scale, dtype=dtype, device=q.device)
    out = flash_fwd(qc.contiguous(), k.to(dtype).contiguous(),
                    v.to(dtype).contiguous(), k_lens=k_lens,
                    softmax_scale=softmax_scale, causal=causal,
                    window_size=tuple(window_size))
    return out.to(out_dtype)
