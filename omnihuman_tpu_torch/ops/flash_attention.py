"""Flash attention, forward and backward: the Hopper kernels and their
plain PyTorch versions.

Port of omnihuman_tpu/ops/flash_pallas.py. One CUDA kernel,
`csrc/flash_fwd.cu`, computes what the two TPU forward kernels
`_fwd_kernel` (Lk <= block_k) and `_fwd_kernel_u2` (Lk > block_k) compute,
with the natural-log LSE as an optional output; `csrc/flash_bwd.cu` holds
one fused backward kernel that computes what the two TPU backward kernels
`_bwd_dkdv_kernel` and `_bwd_dq_kernel` compute. The source notes there
say what bounds each and how it is built.

Contract (flash_pallas.pallas_flash_attention, forward):
  q [B, Lq, N, D], k / v [B, Lk, N, D] in the compute dtype;
  O = softmax(scale * Q K^T + mask) V, fp32 softmax statistics;
  mask: key index < k_lens[b] (clamped to Lk), optional causal and
  (left, right) window masks in global coordinates shifted by
  offsets = (q_off, k_off) and Lk - Lq;
  rows with no valid key are exactly 0; output dtype is q's.

Backward (flash_pallas._flash_bwd): given dO, the saved O and the LSE,
  delta = rowsum(dO * O) in fp32,
  P = where(mask, exp(scale * Q K^T - lse), 0),  dS = P * (dP - delta) * scale
  with dP = dO V^T; dV = P^T dO, dK = dS^T Q, dQ = dS K, fp32 accumulation,
  P and dS rounded to the input dtype before their products.

`flash_fwd` / `flash_bwd` dispatch on the tensors' device: CPU tensors take
the plain versions, CUDA tensors launch the kernels (or raise). Nothing
falls back. `FlashAttention` is the autograd Function over the pair.
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
_FWD_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                 + [ctypes.c_float] + [ctypes.c_int] * 5 + [ctypes.c_void_p])
FLASH_FWD_LONG_K = CudaKernel("flash_fwd (Lk > 1024)", "flash_fwd.cu",
                              "omni_flash_fwd_bf16", _FWD_ARGTYPES)
FLASH_FWD_SHORT_K = CudaKernel("flash_fwd (Lk <= 1024)", "flash_fwd.cu",
                               "omni_flash_fwd_bf16", _FWD_ARGTYPES)
FLASH_BWD = CudaKernel(
    "flash_bwd (K2)", "flash_bwd.cu", "omni_flash_bwd_bf16",
    [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_float]
    + [ctypes.c_int] * 5 + [ctypes.c_void_p])
KERNELS = (FLASH_FWD_LONG_K, FLASH_FWD_SHORT_K, FLASH_BWD)


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


def _index_mask(s0: int, s1: int, lq: int, lk: int, causal: bool,
                window_size: Tuple[int, int], offsets, device):
    """The causal / window part of flash_pallas._mask_block for queries
    [s0, s1) against all keys: bool [s1 - s0, Lk], or None without one."""
    left, right = window_size
    if not causal and (left, right) == (-1, -1):
        return None
    q_off, k_off = offsets if offsets is not None else (0, 0)
    qg = torch.arange(s0, s1, device=device)[:, None] + (lk - lq) + q_off
    kg = torch.arange(lk, device=device)[None, :] + k_off
    ok = torch.ones((s1 - s0, lk), dtype=torch.bool, device=device)
    if causal:
        ok = ok & (kg <= qg)
    if left >= 0:
        ok = ok & (qg - kg <= left)
    if right >= 0:
        ok = ok & (kg - qg <= right)
    return ok


def flash_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    k_lens: Optional[torch.Tensor] = None,
    softmax_scale: Optional[float] = None,
    causal: bool = False,
    window_size: Tuple[int, int] = (-1, -1),
    offsets: Optional[Tuple[int, int]] = None,
    return_lse: bool = False,
):
    """The kernel's function in plain PyTorch, PLAIN_CHUNK_Q queries at a
    time (a dense [2, 12, 32768, 32768] fp32 logits tensor would be 103 GB).

    Products of the compute-dtype inputs accumulate in fp32; the softmax
    is fp32; P is rounded to v's dtype before P.V, as in the kernels.
    With `return_lse`, also the natural-log LSE [B, N, Lq] fp32 of each
    row (NEG_INF on a row with no valid key)."""
    _check_shapes(q, k, v)
    b, lq, n, d = q.shape
    lk = k.shape[1]
    scale = float(softmax_scale if softmax_scale is not None else d ** -0.5)
    dev = q.device
    kl = _clamped_lens(k_lens, b, lk, dev)
    kmask = (torch.arange(lk, device=dev)[None, :] < kl[:, None])
    kmask = kmask[:, None, None, :]                          # [B,1,1,Lk]

    kt = k.permute(0, 2, 3, 1).float()                       # [B,N,D,Lk]
    vt = v.permute(0, 2, 1, 3).float()                       # [B,N,Lk,D]
    out = torch.empty((b, n, lq, d), dtype=q.dtype, device=dev)
    lse = (torch.empty((b, n, lq), dtype=torch.float32, device=dev)
           if return_lse else None)
    for s0 in range(0, lq, PLAIN_CHUNK_Q):
        s1 = min(s0 + PLAIN_CHUNK_Q, lq)
        qc = q[:, s0:s1].permute(0, 2, 1, 3).float()         # [B,N,c,D]
        logits = torch.matmul(qc, kt) * scale                # [B,N,c,Lk]
        mask = kmask
        ok = _index_mask(s0, s1, lq, lk, causal, window_size, offsets, dev)
        if ok is not None:
            mask = mask & ok[None, None]
        logits = logits.masked_fill(~mask, NEG_INF)
        m = logits.amax(dim=-1, keepdim=True)
        p = torch.exp(logits - m) * mask
        l = p.sum(dim=-1, keepdim=True)
        valid = mask.any(dim=-1, keepdim=True)
        o = torch.matmul(p.to(v.dtype).float(), vt)
        denom = torch.where(l == 0, torch.ones_like(l), l)
        o = o / denom
        o = torch.where(valid, o, torch.zeros_like(o))
        out[:, :, s0:s1] = o.to(q.dtype)
        if lse is not None:
            row = torch.where(valid, m + torch.log(denom),
                              torch.full_like(m, NEG_INF))
            lse[:, :, s0:s1] = row[..., 0]
    out = out.permute(0, 2, 1, 3).contiguous()
    return (out, lse) if return_lse else out


def bwd_delta(out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * O) per head, fp32 [B, N, Lq], from the stored
    (compute-dtype) O (flash_pallas._flash_bwd, `:494-497`)."""
    return (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def flash_bwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
    lse: torch.Tensor, dout: torch.Tensor,
    k_lens: Optional[torch.Tensor] = None,
    softmax_scale: Optional[float] = None,
    causal: bool = False,
    window_size: Tuple[int, int] = (-1, -1),
    offsets: Optional[Tuple[int, int]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernels' function written out (not autograd through the
    plain forward), PLAIN_CHUNK_Q queries at a time: P recomputed from the
    LSE with the mask applied before the exponential, fp32 products of the
    input-dtype operands, P and dS rounded to the input dtype before their
    products. Returns (dq, dk, dv) in the dtypes of q, k, v."""
    _check_shapes(q, k, v)
    b, lq, n, d = q.shape
    lk = k.shape[1]
    scale = float(softmax_scale if softmax_scale is not None else d ** -0.5)
    dev, cd = q.device, q.dtype
    kl = _clamped_lens(k_lens, b, lk, dev)
    kmask = (torch.arange(lk, device=dev)[None, :] < kl[:, None])
    kmask = kmask[:, None, None, :]                          # [B,1,1,Lk]
    delta = bwd_delta(out, dout)                             # [B,N,Lq]
    dout = dout.to(cd)

    kt = k.permute(0, 2, 3, 1).float()                       # [B,N,D,Lk]
    kf = k.permute(0, 2, 1, 3).float()                       # [B,N,Lk,D]
    vt = v.permute(0, 2, 3, 1).float()                       # [B,N,D,Lk]
    dq = torch.empty((b, n, lq, d), dtype=q.dtype, device=dev)
    dk = torch.zeros((b, n, lk, d), dtype=torch.float32, device=dev)
    dv = torch.zeros((b, n, lk, d), dtype=torch.float32, device=dev)
    for s0 in range(0, lq, PLAIN_CHUNK_Q):
        s1 = min(s0 + PLAIN_CHUNK_Q, lq)
        qc = q[:, s0:s1].permute(0, 2, 1, 3).float()         # [B,N,c,D]
        doc = dout[:, s0:s1].permute(0, 2, 1, 3).float()     # [B,N,c,D]
        s = torch.matmul(qc, kt) * scale                     # [B,N,c,Lk]
        mask = kmask
        ok = _index_mask(s0, s1, lq, lk, causal, window_size, offsets, dev)
        if ok is not None:
            mask = mask & ok[None, None]
        # select BEFORE using exp: a row with no valid key has lse = -1e30
        p = torch.where(mask, torch.exp(s - lse[:, :, s0:s1, None]),
                        torch.zeros_like(s))
        dv += torch.matmul(p.to(cd).float().transpose(-1, -2), doc)
        dp = torch.matmul(doc, vt)                           # [B,N,c,Lk]
        ds = (p * (dp - delta[:, :, s0:s1, None]) * scale).to(cd).float()
        dq[:, :, s0:s1] = torch.matmul(ds, kf).to(q.dtype)
        dk += torch.matmul(ds.transpose(-1, -2), qc)
    return (dq.permute(0, 2, 1, 3).contiguous(),
            dk.permute(0, 2, 1, 3).to(k.dtype).contiguous(),
            dv.permute(0, 2, 1, 3).to(v.dtype).contiguous())


def _check_kernel_inputs(**tensors) -> None:
    """What the CUDA kernels take: bf16, contiguous, 16-byte aligned
    tensors on one CUDA device."""
    dev = next(iter(tensors.values())).device
    for name, x in tensors.items():
        if not x.is_cuda:
            raise ValueError(f"{name} is on {x.device}, the kernel needs CUDA")
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, q on {dev}")
        if x.dtype != torch.bfloat16:
            raise TypeError(f"{name} is {x.dtype}; the kernel takes bfloat16")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous [B, L, N, D]")
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    d = tensors["q"].shape[-1]
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"head_dim {d} unsupported by the kernel "
                         f"(supported: {KERNEL_HEAD_DIMS})")


def _mask_args(softmax_scale, d, causal, window_size, offsets):
    scale = float(softmax_scale if softmax_scale is not None else d ** -0.5)
    q_off, k_off = offsets if offsets is not None else (0, 0)
    left, right = window_size
    return (scale, int(bool(causal)), int(left), int(right), int(q_off),
            int(k_off))


def flash_attention_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    k_lens: Optional[torch.Tensor] = None,
    softmax_scale: Optional[float] = None,
    causal: bool = False,
    window_size: Tuple[int, int] = (-1, -1),
    offsets: Optional[Tuple[int, int]] = None,
    return_lse: bool = False,
):
    """Launch csrc/flash_fwd.cu on the current stream; raises on anything
    the kernel does not take (device, dtype, layout, head_dim). With
    `return_lse` the kernel also writes the LSE [B, N, Lq] fp32."""
    _check_shapes(q, k, v)
    _check_kernel_inputs(q=q, k=k, v=v)
    b, lq, n, d = q.shape
    lk = k.shape[1]
    out = torch.empty_like(q)
    lse = (torch.empty((b, n, lq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if out.numel() == 0:
        return (out, lse) if return_lse else out
    kl = _clamped_lens(k_lens, b, lk, q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    kernel = FLASH_FWD_LONG_K if lk > PALLAS_BLOCK_K else FLASH_FWD_SHORT_K
    with torch.cuda.device(q.device):
        kernel.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), None if lse is None else lse.data_ptr(),
                      kl.data_ptr(), b, lq, lk, n, d,
                      *_mask_args(softmax_scale, d, causal, window_size,
                                  offsets), stream)
    return (out, lse) if return_lse else out


def _check_bwd_shapes(q, out, lse, dout) -> None:
    b, lq, n, _ = q.shape
    for name, x in (("out", out), ("dout", dout)):
        if x.shape != q.shape:
            raise ValueError(f"{name} {tuple(x.shape)} != q {tuple(q.shape)}")
    if tuple(lse.shape) != (b, n, lq):
        raise ValueError(f"lse {tuple(lse.shape)} != {(b, n, lq)}")


def flash_bwd_launch(q, k, v, dout, lse, delta, kl, dq_acc, dk, dv,
                     softmax_scale=None, causal=False, window_size=(-1, -1),
                     offsets=None) -> None:
    """One launch of the backward kernel (flash_bwd.cu) on checked inputs:
    writes dk and dv (bf16 like k and v) and adds dQ into `dq_acc`, an fp32
    tensor shaped like q. `kl` is the clamped int32 k_lens; lse and delta
    are [B, N, Lq] fp32 contiguous."""
    b, lq, n, d = q.shape
    if dk.numel() == 0:
        return
    if lq == 0:     # no query sees a key; a tensor map needs rows to map
        dk.zero_()
        dv.zero_()
        return
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        FLASH_BWD.launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), kl.data_ptr(),
            dq_acc.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, lq,
            k.shape[1], n, d,
            *_mask_args(softmax_scale, d, causal, window_size, offsets),
            stream)


def flash_bwd_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
    lse: torch.Tensor, dout: torch.Tensor,
    k_lens: Optional[torch.Tensor] = None,
    softmax_scale: Optional[float] = None,
    causal: bool = False,
    window_size: Tuple[int, int] = (-1, -1),
    offsets: Optional[Tuple[int, int]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch csrc/flash_bwd.cu once on the current stream, with delta
    computed here in fp32 from the stored O; raises on anything the kernel
    does not take. dQ is summed in a zero-filled fp32 accumulator (its sum
    order varies from run to run) and cast to q's dtype."""
    _check_shapes(q, k, v)
    _check_bwd_shapes(q, out, lse, dout)
    _check_kernel_inputs(q=q, k=k, v=v, out=out, dout=dout)
    if not (lse.is_cuda and lse.dtype == torch.float32
            and lse.is_contiguous() and lse.device == q.device):
        raise ValueError("lse must be a contiguous float32 tensor on "
                         f"{q.device}")
    kl = _clamped_lens(k_lens, q.shape[0], k.shape[1], q.device)
    delta = bwd_delta(out, dout)
    mask = dict(softmax_scale=softmax_scale, causal=causal,
                window_size=window_size, offsets=offsets)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    dq_acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    flash_bwd_launch(q, k, v, dout, lse, delta, kl, dq_acc, dk, dv, **mask)
    return dq_acc.to(q.dtype), dk, dv


def flash_fwd(q, k, v, k_lens=None, softmax_scale=None, causal=False,
              window_size=(-1, -1), offsets=None, return_lse=False):
    """The kernel on CUDA tensors, its plain version on CPU tensors."""
    if q.is_cuda:
        return flash_attention_cuda(q, k, v, k_lens, softmax_scale, causal,
                                    window_size, offsets, return_lse)
    if q.device.type != "cpu":
        raise ValueError(f"no flash-attention path for device {q.device}")
    return flash_attention_plain(q, k, v, k_lens, softmax_scale, causal,
                                 window_size, offsets, return_lse)


def flash_bwd(q, k, v, out, lse, dout, k_lens=None, softmax_scale=None,
              causal=False, window_size=(-1, -1), offsets=None):
    """The backward kernel on CUDA tensors, the plain backward on CPU
    tensors: (dq, dk, dv)."""
    if q.is_cuda:
        return flash_bwd_cuda(q, k, v, out, lse, dout, k_lens, softmax_scale,
                              causal, window_size, offsets)
    if q.device.type != "cpu":
        raise ValueError(f"no flash-attention path for device {q.device}")
    return flash_bwd_plain(q, k, v, out, lse, dout, k_lens, softmax_scale,
                           causal, window_size, offsets)


class FlashAttention(torch.autograd.Function):
    """Flash attention with its flash backward (flash_pallas's custom_vjp,
    `:609-638`): the forward saves q, k, v, O, the LSE and the clamped
    k_lens; the backward recomputes P from the LSE. Both dispatch on the
    device like `flash_fwd`.

        FlashAttention.apply(q, k, v, k_lens, softmax_scale, causal,
                             window_size, offsets)
    """

    @staticmethod
    def forward(ctx, q, k, v, k_lens, softmax_scale, causal, window_size,
                offsets):
        kl = _clamped_lens(k_lens, q.shape[0], k.shape[1], q.device)
        out, lse = flash_fwd(q, k, v, kl, softmax_scale, causal, window_size,
                             offsets, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse, kl)
        ctx.mask = (softmax_scale, causal, window_size, offsets)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, kl = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, out, lse, dout.contiguous(), kl,
                               *ctx.mask)
        return dq, dk, dv, None, None, None, None, None
