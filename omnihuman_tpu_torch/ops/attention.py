"""Attention front-end (port of omnihuman_tpu/ops/attention.py).

Same call contract as the JAX `flash_attention` (and the reference's
flash-attn shim, wan/modules/attention.py:24-179):
    q [B, Lq, N, D], k / v [B, Lk, N, D]
    k_lens [B] int32 per-sample valid key lengths
    window_size (left, right), causal, softmax_scale, q_scale

A CPU tensor goes to the plain PyTorch version, a CUDA tensor to the
hand-written Hopper kernels (ops/flash_attention.py); there is no other
back-end and no fallback between them. When a gradient is needed, the call
goes through the autograd Function `FlashAttention` (forward with the LSE,
then the flash backward); otherwise it is one forward launch without the
LSE, the serving path, through K1's custom op (`flash_fwd`, which
`torch.export` traces into the exported serving step).

`implementation` "ring" / "ulysses" / "sp_cross" take the
sequence-parallel paths of ops/ring_attention.py on the mesh that
`parallel.use_mesh` made current (JAX ops/attention.py:345-377); with no
mesh current they take the single-device route, as in JAX. "auto" is the
single-device route.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from omnihuman_tpu_torch.ops.flash_attention import FlashAttention, flash_fwd


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
    implementation: str = "auto",
) -> torch.Tensor:
    """Masked attention, computed in `dtype`, returned in q's dtype.

    q_lens is accepted for parity: rows past q_lens[b] produce values the
    caller never reads. dropout is not used on the serving path and is
    not implemented. Under a mesh, the sequence-parallel implementations
    take this rank's token shard of q (and of k / v for "ring" /
    "ulysses") and k_lens as the global valid counts."""
    del q_lens, deterministic
    if dropout_p:
        raise NotImplementedError("attention dropout is not implemented")
    if implementation not in ("auto", "ring", "ulysses", "sp_cross"):
        raise ValueError(f"unknown attention implementation "
                         f"{implementation!r}")
    mesh = None
    if implementation != "auto":
        from omnihuman_tpu_torch.parallel.mesh import current_mesh
        mesh = current_mesh()
    if mesh is None:
        return single_device_attention(
            q, k, v, k_lens=k_lens, softmax_scale=softmax_scale,
            q_scale=q_scale, causal=causal, window_size=window_size,
            dtype=dtype)
    from omnihuman_tpu_torch.ops import ring_attention as ra
    if implementation == "sp_cross":
        return ra.sp_cross_attention(
            q, k, v, mesh, k_lens=k_lens, softmax_scale=softmax_scale,
            q_scale=q_scale, causal=causal, window_size=window_size,
            compute_dtype=dtype)
    if q_scale is not None:      # before the ring, as JAX applies it
        q = q * torch.tensor(q_scale, dtype=q.dtype, device=q.device)
    fn = (ra.ring_attention if implementation == "ring"
          else ra.ulysses_attention)
    return fn(q, k, v, mesh, seq_lens=k_lens, softmax_scale=softmax_scale,
              compute_dtype=dtype, causal=causal,
              window_size=tuple(window_size))


def single_device_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    k_lens: Optional[torch.Tensor] = None,
    softmax_scale: Optional[float] = None,
    q_scale: Optional[float] = None,
    causal: bool = False,
    window_size: Tuple[int, int] = (-1, -1),
    dtype: torch.dtype = torch.bfloat16,
    offsets: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """The whole attention on this device: one K1 launch (the autograd
    Function when a gradient is needed), or its plain version on the CPU;
    `offsets` = (q_off, k_off) shift the causal / window masks."""
    out_dtype = q.dtype
    qc = q.to(dtype)
    if q_scale is not None:
        qc = qc * torch.tensor(q_scale, dtype=dtype, device=q.device)
    qc, kc, vc = (x.contiguous() for x in (qc, k.to(dtype), v.to(dtype)))
    if torch.is_grad_enabled() and (qc.requires_grad or kc.requires_grad
                                    or vc.requires_grad):
        out = FlashAttention.apply(qc, kc, vc, k_lens, softmax_scale, causal,
                                   tuple(window_size), offsets)
    else:
        out = flash_fwd(qc, kc, vc, k_lens=k_lens,
                        softmax_scale=softmax_scale, causal=causal,
                        window_size=tuple(window_size), offsets=offsets)
    return out.to(out_dtype)
