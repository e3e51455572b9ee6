"""Flash-attention forward: the Hopper kernel and its plain PyTorch version.

Port of omnihuman_tpu/ops/flash_pallas.py (forward only). One CUDA kernel,
`csrc/flash_fwd.cu`, computes what the two TPU kernels `_fwd_kernel`
(Lk <= block_k) and `_fwd_kernel_u2` (Lk > block_k) compute; the source
note there says what bounds it and how it is built.

Contract (flash_pallas.pallas_flash_attention, forward):
  q [B, Lq, N, D], k / v [B, Lk, N, D] in the compute dtype;
  O = softmax(scale * Q K^T + mask) V, fp32 softmax statistics;
  mask: key index < k_lens[b] (clamped to Lk), optional causal and
  (left, right) window masks in global coordinates shifted by
  offsets = (q_off, k_off) and Lk - Lq;
  rows with no valid key are exactly 0; output dtype is q's.

`flash_fwd` dispatches on the tensors' device: CPU tensors take the plain
version, CUDA tensors launch the kernel (or raise). Nothing falls back.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from omnihuman_tpu_torch.ops.cuda_build import CudaKernel

NEG_INF = -1e30   # finite on purpose: see flash_pallas.py NEG_INF note
KERNEL_HEAD_DIMS = (64, 128)
PLAIN_CHUNK_Q = 1024   # queries per step of the plain version

# One kernel, two launch counts: the JAX package picks `_fwd_kernel_u2` when
# Lk > block_k (1024; the DiT self-attention) and `_fwd_kernel` otherwise
# (the cross-attention to <= 512 text tokens). Counting the two cases
# apart lines each up with the TPU kernel it replaces.
PALLAS_BLOCK_K = 1024
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_float]
             + [ctypes.c_int] * 5 + [ctypes.c_void_p])
FLASH_FWD_LONG_K = CudaKernel("flash_fwd (Lk > 1024)", "flash_fwd.cu",
                              "omni_flash_fwd_bf16", _ARGTYPES)
FLASH_FWD_SHORT_K = CudaKernel("flash_fwd (Lk <= 1024)", "flash_fwd.cu",
                               "omni_flash_fwd_bf16", _ARGTYPES)
KERNELS = (FLASH_FWD_LONG_K, FLASH_FWD_SHORT_K)


def _check_shapes(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be [B, L, N, D]")
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    if q.shape[0] != k.shape[0] or q.shape[2:] != k.shape[2:]:
        raise ValueError(f"q {tuple(q.shape)} does not match k "
                         f"{tuple(k.shape)} in batch / heads / head_dim")


def _clamped_lens(k_lens, b: int, lk: int, device) -> torch.Tensor:
    if k_lens is None:
        return torch.full((b,), lk, dtype=torch.int32, device=device)
    kl = torch.as_tensor(k_lens, device=device).to(torch.int32).reshape(-1)
    if kl.numel() != b:
        raise ValueError(f"k_lens has {kl.numel()} entries for batch {b}")
    return kl.clamp(0, lk).contiguous()


def flash_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    k_lens: Optional[torch.Tensor] = None,
    softmax_scale: Optional[float] = None,
    causal: bool = False,
    window_size: Tuple[int, int] = (-1, -1),
    offsets: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch, PLAIN_CHUNK_Q queries at a
    time (a dense [2, 12, 32768, 32768] fp32 logits tensor would be 103 GB).

    Products of the compute-dtype inputs accumulate in fp32; the softmax
    is fp32; P is rounded to v's dtype before P.V, as in the kernels."""
    _check_shapes(q, k, v)
    b, lq, n, d = q.shape
    lk = k.shape[1]
    scale = float(softmax_scale if softmax_scale is not None else d ** -0.5)
    dev = q.device
    kl = _clamped_lens(k_lens, b, lk, dev)
    kmask = (torch.arange(lk, device=dev)[None, :] < kl[:, None])
    kmask = kmask[:, None, None, :]                          # [B,1,1,Lk]
    q_off, k_off = offsets if offsets is not None else (0, 0)
    left, right = window_size

    kt = k.permute(0, 2, 3, 1).float()                       # [B,N,D,Lk]
    vt = v.permute(0, 2, 1, 3).float()                       # [B,N,Lk,D]
    out = torch.empty((b, n, lq, d), dtype=q.dtype, device=dev)
    for s0 in range(0, lq, PLAIN_CHUNK_Q):
        s1 = min(s0 + PLAIN_CHUNK_Q, lq)
        qc = q[:, s0:s1].permute(0, 2, 1, 3).float()         # [B,N,c,D]
        logits = torch.matmul(qc, kt) * scale                # [B,N,c,Lk]
        mask = kmask
        if causal or (left, right) != (-1, -1):
            qg = (torch.arange(s0, s1, device=dev)[:, None]
                  + (lk - lq) + q_off)
            kg = torch.arange(lk, device=dev)[None, :] + k_off
            ok = torch.ones((s1 - s0, lk), dtype=torch.bool, device=dev)
            if causal:
                ok = ok & (kg <= qg)
            if left >= 0:
                ok = ok & (qg - kg <= left)
            if right >= 0:
                ok = ok & (kg - qg <= right)
            mask = mask & ok[None, None]
        logits = logits.masked_fill(~mask, NEG_INF)
        m = logits.amax(dim=-1, keepdim=True)
        p = torch.exp(logits - m) * mask
        l = p.sum(dim=-1, keepdim=True)
        o = torch.matmul(p.to(v.dtype).float(), vt)
        o = o / torch.where(l == 0, torch.ones_like(l), l)
        o = torch.where(mask.any(dim=-1, keepdim=True), o,
                        torch.zeros_like(o))
        out[:, :, s0:s1] = o.to(q.dtype)
    return out.permute(0, 2, 1, 3).contiguous()


def flash_attention_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    k_lens: Optional[torch.Tensor] = None,
    softmax_scale: Optional[float] = None,
    causal: bool = False,
    window_size: Tuple[int, int] = (-1, -1),
    offsets: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """Launch csrc/flash_fwd.cu on the current stream; raises on anything
    the kernel does not take (device, dtype, layout, head_dim)."""
    _check_shapes(q, k, v)
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_cuda:
            raise ValueError(f"{name} is on {x.device}, the kernel needs CUDA")
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if x.dtype != torch.bfloat16:
            raise TypeError(f"{name} is {x.dtype}; the kernel takes bfloat16")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous [B, L, N, D]")
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    b, lq, n, d = q.shape
    lk = k.shape[1]
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"head_dim {d} unsupported by the kernel "
                         f"(supported: {KERNEL_HEAD_DIMS})")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    scale = float(softmax_scale if softmax_scale is not None else d ** -0.5)
    kl = _clamped_lens(k_lens, b, lk, q.device)
    q_off, k_off = offsets if offsets is not None else (0, 0)
    left, right = window_size
    stream = torch.cuda.current_stream(q.device).cuda_stream
    kernel = FLASH_FWD_LONG_K if lk > PALLAS_BLOCK_K else FLASH_FWD_SHORT_K
    with torch.cuda.device(q.device):
        kernel.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), kl.data_ptr(), b, lq, lk, n, d,
                      scale, int(bool(causal)), int(left), int(right),
                      int(q_off), int(k_off), stream)
    return out


def flash_fwd(q, k, v, k_lens=None, softmax_scale=None, causal=False,
              window_size=(-1, -1), offsets=None) -> torch.Tensor:
    """The kernel on CUDA tensors, its plain version on CPU tensors."""
    if q.is_cuda:
        return flash_attention_cuda(q, k, v, k_lens, softmax_scale, causal,
                                    window_size, offsets)
    if q.device.type != "cpu":
        raise ValueError(f"no flash-attention path for device {q.device}")
    return flash_attention_plain(q, k, v, k_lens, softmax_scale, causal,
                                 window_size, offsets)
