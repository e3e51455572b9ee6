"""Fused VAE convolutions: the Hopper kernels K3 and K4 and their plain
PyTorch versions (port of omnihuman_tpu/ops/vae_pallas.py).

K3, `fused_act_causal_conv3d` (csrc/vae_conv.cu; TPU kernel vae_pallas.py
`_kernel`): one conv of a VAE residual block,
    a = bf16(silu(bf16(x * (sqrt(C) / max(|x|, 1e-12)) * gamma)))  (fp32 math)
    y = causal 3x3x3 conv of [cache, a] (SAME in H and W) + bias [+ residual]
and the new cache, the last 2 frames of [cache, a]. The cache holds
activated frames already; the residual is the block input, added in fp32.

K4, `fused_upsample_conv2d` (csrc/vae_upsample.cu; TPU kernel `_up_kernel`):
nearest-2x upsample + SAME 3x3 conv as four 2x2 parity convs on the
low-res grid (weights from `pack_upsample_weights`), + bias. The kernel
reads the weights in the K-major layout [2, 2, 4, Cout, Cin]
(`upsample_weights_kmajor`, made once per VAE pass beside the packed
weights, or per call when the caller does not pass it).

Layout: the port's VAE layout, logical [B, C, T, H, W], in
`torch.channels_last_3d` memory, which is [B, T, H, W, C] in memory: the
TPU kernels' channels-last layout. Weights come K-packed exactly as the
JAX packers pack them. The TPU's tile pickers and its `fused_viable` rule
(VMEM and MXU fill) have no counterpart: the kernels take every shape
that meets their preconditions and raise on the rest.

`*_plain` computes the kernel's function with its rounding points in
plain PyTorch: inputs rounded to bf16, products summed in fp32 (an fp32
conv of bf16 values; TF32 keeps bf16 values exact, so cuDNN's TF32
default changes nothing), bias and residual added in fp32. `*_cuda`
launches the kernel on the current stream and raises on anything it does
not take: bf16 activations in channels_last_3d memory, fp32 gamma and
bias, Cin % 16 == 0 and Cout % 8 == 0. The public functions run the
kernel on CUDA tensors and the plain version on CPU tensors; nothing
falls back.

K3 runs in two launches that count as one ("vae_conv (K3)"): a pre-pass
writes the activated frames a ([B, Cin, T, H, W], channels_last_3d) and
the new cache (`act_cache_plain` is its plain version), then the conv
reads [cache, a] and the weights in the K-major layout [27, Cout, Cin]
(`conv_weights_kmajor`, made once per VAE pass beside the packed weights,
or per call when the caller does not pass it).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from omnihuman_tpu_torch.ops.cuda_build import CudaKernel

CL3D = torch.channels_last_3d

VAE_CONV = CudaKernel(
    "vae_conv (K3)", "vae_conv.cu", "omni_vae_conv_bf16",
    [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
# the pre-pass alone, for the card tests and the smoke's timing; K3's own
# launches run it inside VAE_CONV
VAE_ACT_CACHE = CudaKernel(
    "vae_conv pre-pass (K3)", "vae_conv.cu", "omni_vae_act_cache_bf16",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
# (x, wk, bias, y, B, T, h, w, Cin, Cout, stream)
VAE_UPSAMPLE = CudaKernel(
    "vae_upsample (K4)", "vae_upsample.cu", "omni_vae_upsample_bf16",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
KERNELS = (VAE_CONV, VAE_UPSAMPLE)

# (parity, (low-res tap, high-res tap)) pairs of pack_upsample_weights:
# output row 2i+a reads high-res rows 2i+a-1+u, u in 0..2, which are the
# low-res rows i-1+a+p
_UP_TAPS = {0: ((0, 0), (1, 1), (1, 2)), 1: ((0, 0), (0, 1), (1, 2))}


def pack_conv_weights(w: torch.Tensor) -> torch.Tensor:
    """[3, 3, 3, Cin, Cout] -> K-packed [27 * Cin, Cout] bf16, rows in
    (dt, dy, dx, ci) order (vae_pallas.pack_conv_weights)."""
    kt, kh, kw, cin, cout = w.shape
    return w.reshape(kt * kh * kw * cin, cout).to(torch.bfloat16).contiguous()


def conv_weights_kmajor(w2: torch.Tensor) -> torch.Tensor:
    """K-packed [27 * Cin, Cout] (`pack_conv_weights`) -> the layout K3's
    kernel reads, [27, Cout, Cin] bf16: per tap, each output channel's
    Cin weights contiguous (the K-major B operand of its wgmma)."""
    cin = w2.shape[0] // 27
    return w2.reshape(27, cin, w2.shape[1]).transpose(1, 2).to(
        torch.bfloat16).contiguous()


def pack_upsample_weights(w: torch.Tensor) -> torch.Tensor:
    """[3, 3, Cin, Cout] SAME conv at the upsampled resolution -> the four
    parity kernels [2, 2, 4 * Cin, Cout] bf16 ((a, b) output parity, rows
    (p, q, ci) over the 2x2 low-res window). The tap sums run in w's dtype
    in the JAX order, so bf16 weights round as they do there
    (vae_pallas.pack_upsample_weights)."""
    cin, cout = w.shape[2], w.shape[3]
    out = torch.zeros((2, 2, 2, 2, cin, cout), dtype=w.dtype, device=w.device)
    for a in (0, 1):
        for b in (0, 1):
            for p, u in _UP_TAPS[a]:
                for q, v in _UP_TAPS[b]:
                    out[a, b, p, q] += w[u, v]
    return out.reshape(2, 2, 4 * cin, cout).to(torch.bfloat16).contiguous()


def upsample_weights_kmajor(w4: torch.Tensor) -> torch.Tensor:
    """Parity kernels [2, 2, 4 * Cin, Cout] (`pack_upsample_weights`) ->
    the layout K4's kernel reads, [2, 2, 4, Cout, Cin] bf16:
    wk[a, b, tap, co, ci] = w4[a, b, tap * Cin + ci, co] (per parity and
    tap, each output channel's Cin weights contiguous: the K-major B
    operand of its wgmma)."""
    cin, cout = w4.shape[2] // 4, w4.shape[3]
    return w4.reshape(2, 2, 4, cin, cout).transpose(3, 4).to(
        torch.bfloat16).contiguous()


# ---------------------------------------------------------------------------
# plain versions


def activate_plain(x: torch.Tensor, gamma: torch.Tensor) -> torch.Tensor:
    """K3's prologue on [B, C, T, H, W]: channel RMS norm (fp32 statistics,
    x * (sqrt(C) / max(norm, 1e-12)) * gamma, rounded to bf16), then SiLU
    in fp32, rounded to bf16 (vae_pallas._silu_rms)."""
    c = x.shape[1]
    xf = x.float()
    norm = xf.square().sum(dim=1, keepdim=True).sqrt()
    y = xf * (math.sqrt(c) / norm.clamp_min(1e-12))
    y = (y * gamma.float().reshape(1, c, 1, 1, 1)).to(torch.bfloat16).float()
    return (y * torch.sigmoid(y)).to(torch.bfloat16)


def act_cache_plain(x: torch.Tensor, cache: torch.Tensor,
                    gamma: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3's pre-pass in plain PyTorch: a = activate_plain(x) ([B, Cin, T,
    H, W] bf16) and the new cache, the last 2 frames of [cache, a] along
    time, both channels-last like the kernel's."""
    a = activate_plain(x, gamma).contiguous(memory_format=CL3D)
    new_cache = torch.cat([cache.to(torch.bfloat16), a], dim=2)[:, :, -2:]
    return a, new_cache.contiguous(memory_format=CL3D)


def fused_act_causal_conv3d_plain(
    x: torch.Tensor, cache: torch.Tensor, gamma: torch.Tensor,
    w2: torch.Tensor, b: torch.Tensor,
    residual: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3 in plain PyTorch. x [B, Cin, T, H, W] pre-activation; cache
    [B, Cin, 2, H, W] activated history; gamma [Cin]; w2 [27 * Cin, Cout]
    (`pack_conv_weights`); b [Cout]; residual [B, Cout, T, H, W] or None.
    Returns (y [B, Cout, T, H, W] in x's dtype, new cache [B, Cin, 2, H, W]
    bf16), channels-last like the kernel's."""
    cin, cout = x.shape[1], w2.shape[1]
    a, new_cache = act_cache_plain(x, cache, gamma)
    xin = torch.cat([cache.to(torch.bfloat16), a], dim=2)
    w = w2.float().reshape(3, 3, 3, cin, cout).permute(4, 3, 0, 1, 2)
    y = F.conv3d(xin.float(), w, padding=(0, 1, 1))
    y = y + b.float().reshape(1, cout, 1, 1, 1)
    if residual is not None:
        y = y + residual.float()
    return y.to(x.dtype).contiguous(memory_format=CL3D), new_cache


def fused_upsample_conv2d_plain(x: torch.Tensor, w4: torch.Tensor,
                                b: torch.Tensor) -> torch.Tensor:
    """K4 in plain PyTorch: x [B, Cin, T, h, w], w4 [2, 2, 4 * Cin, Cout]
    (`pack_upsample_weights`), b [Cout] -> [B, Cout, T, 2h, 2w] in x's
    dtype, channels-last like the kernel's. Parity (a, b) is a 2x2 conv over the zero-padded low-res grid
    starting at row a, column b."""
    bsz, cin, t, h, w = x.shape
    cout = w4.shape[-1]
    xp = F.pad(x.to(torch.bfloat16).float(), (1, 1, 1, 1))
    y = torch.empty((bsz, cout, t, 2 * h, 2 * w), dtype=torch.float32,
                    device=x.device)
    for a in (0, 1):
        for bb in (0, 1):
            wk = w4[a, bb].float().reshape(2, 2, cin, cout).permute(3, 2, 0, 1)
            win = xp[:, :, :, a:a + h + 1, bb:bb + w + 1]
            y[:, :, :, a::2, bb::2] = F.conv3d(win, wk.unsqueeze(2))
    y = y + b.float().reshape(1, cout, 1, 1, 1)
    return y.to(x.dtype).contiguous(memory_format=CL3D)


# ---------------------------------------------------------------------------
# kernel launchers


def _check(name: str, x: torch.Tensor, dtype: torch.dtype, dev,
           channels_last: bool) -> None:
    if not x.is_cuda or x.device != dev:
        raise ValueError(f"{name} is on {x.device}, the kernel needs {dev}")
    if x.dtype != dtype:
        raise TypeError(f"{name} is {x.dtype}; the kernel takes {dtype}")
    if channels_last and not x.is_contiguous(memory_format=CL3D):
        raise ValueError(f"{name} {tuple(x.shape)} is not in "
                         "torch.channels_last_3d memory")
    if not channels_last and not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if x.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def kernel_takes_channels(cin: int, cout: int) -> bool:
    """The channel rule of K3 and K4: Cin % 16 == 0 and Cout % 8 == 0."""
    return cin % 16 == 0 and cout % 8 == 0


def _check_channels(cin: int, cout: int) -> None:
    if not kernel_takes_channels(cin, cout):
        raise ValueError(f"channels {cin} -> {cout}: the kernel needs "
                         "Cin % 16 == 0 and Cout % 8 == 0")


def _check_act_inputs(x, cache, gamma):
    bsz, cin, t, h, w = x.shape
    dev = x.device
    _check("x", x, torch.bfloat16, dev, True)
    _check("cache", cache, torch.bfloat16, dev, True)
    _check("gamma", gamma, torch.float32, dev, False)
    if tuple(cache.shape) != (bsz, cin, 2, h, w):
        raise ValueError(f"cache {tuple(cache.shape)} != {(bsz, cin, 2, h, w)}")
    if gamma.numel() != cin:
        raise ValueError(f"gamma {gamma.numel()} does not fit Cin {cin}")


def act_cache_cuda(x: torch.Tensor, cache: torch.Tensor,
                   gamma: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3's pre-pass alone on the card (csrc/vae_conv.cu
    `act_cache_kernel`): the same contract as `act_cache_plain`, for the
    inputs `fused_act_causal_conv3d_cuda` takes."""
    _check_act_inputs(x, cache, gamma)
    bsz, cin, t, h, w = x.shape
    _check_channels(cin, 8)
    a = torch.empty((bsz, cin, t, h, w), dtype=torch.bfloat16,
                    device=x.device, memory_format=CL3D)
    new_cache = torch.empty((bsz, cin, 2, h, w), dtype=torch.bfloat16,
                            device=x.device, memory_format=CL3D)
    if x.numel() == 0:
        return a, new_cache
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        VAE_ACT_CACHE.launch(x.data_ptr(), cache.data_ptr(), gamma.data_ptr(),
                             a.data_ptr(), new_cache.data_ptr(), bsz, t, h,
                             w, cin, stream)
    return a, new_cache


def fused_act_causal_conv3d_cuda(
    x: torch.Tensor, cache: torch.Tensor, gamma: torch.Tensor,
    w2: torch.Tensor, b: torch.Tensor,
    residual: Optional[torch.Tensor] = None,
    wk: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch csrc/vae_conv.cu (K3): same contract as the plain version,
    for bf16 x / cache / residual in channels_last_3d memory (x in fp32 is
    refused, not converted), fp32 gamma and bias, bf16 w2. `wk` is
    `conv_weights_kmajor(w2)` made ahead (made here when None)."""
    bsz, cin, t, h, w = x.shape
    cout = w2.shape[1]
    dev = x.device
    _check_act_inputs(x, cache, gamma)
    _check("w2", w2, torch.bfloat16, dev, False)
    _check("b", b, torch.float32, dev, False)
    _check_channels(cin, cout)
    if tuple(w2.shape) != (27 * cin, cout) or b.numel() != cout:
        raise ValueError(f"weights {tuple(w2.shape)} / bias {b.numel()} do "
                         f"not fit {cin} -> {cout}")
    if wk is None:
        wk = conv_weights_kmajor(w2)
    _check("wk", wk, torch.bfloat16, dev, False)
    if tuple(wk.shape) != (27, cout, cin):
        raise ValueError(f"wk {tuple(wk.shape)} != {(27, cout, cin)}: pass "
                         "conv_weights_kmajor(w2)")
    if residual is not None:
        _check("residual", residual, torch.bfloat16, dev, True)
        if tuple(residual.shape) != (bsz, cout, t, h, w):
            raise ValueError(f"residual {tuple(residual.shape)} != "
                             f"{(bsz, cout, t, h, w)}")
    y = torch.empty((bsz, cout, t, h, w), dtype=torch.bfloat16, device=dev,
                    memory_format=CL3D)
    new_cache = torch.empty((bsz, cin, 2, h, w), dtype=torch.bfloat16,
                            device=dev, memory_format=CL3D)
    # the activated frames, read by the conv's TMA loads; freed on return
    a = torch.empty((bsz, cin, t, h, w), dtype=torch.bfloat16, device=dev,
                    memory_format=CL3D)
    if x.numel() == 0:
        return y, new_cache
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        VAE_CONV.launch(
            x.data_ptr(), cache.data_ptr(), gamma.data_ptr(), wk.data_ptr(),
            b.data_ptr(), None if residual is None else residual.data_ptr(),
            y.data_ptr(), new_cache.data_ptr(), a.data_ptr(),
            bsz, t, h, w, cin, cout, stream)
    return y, new_cache


def fused_upsample_conv2d_cuda(x: torch.Tensor, w4: torch.Tensor,
                               b: torch.Tensor,
                               wk: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """Launch csrc/vae_upsample.cu (K4): bf16 x in channels_last_3d
    memory, bf16 w4, fp32 bias; the output is bf16 in the same memory
    format. `wk` is `upsample_weights_kmajor(w4)` made ahead (made here
    when None)."""
    bsz, cin, t, h, w = x.shape
    cout = w4.shape[-1]
    dev = x.device
    _check("x", x, torch.bfloat16, dev, True)
    _check("w4", w4, torch.bfloat16, dev, False)
    _check("b", b, torch.float32, dev, False)
    _check_channels(cin, cout)
    if tuple(w4.shape) != (2, 2, 4 * cin, cout) or b.numel() != cout:
        raise ValueError(f"w4 {tuple(w4.shape)} / bias {b.numel()} do not "
                         f"fit {cin} -> {cout}")
    if wk is None:
        wk = upsample_weights_kmajor(w4)
    _check("wk", wk, torch.bfloat16, dev, False)
    if tuple(wk.shape) != (2, 2, 4, cout, cin):
        raise ValueError(f"wk {tuple(wk.shape)} != {(2, 2, 4, cout, cin)}: "
                         "pass upsample_weights_kmajor(w4)")
    y = torch.empty((bsz, cout, t, 2 * h, 2 * w), dtype=torch.bfloat16,
                    device=dev, memory_format=CL3D)
    vae_upsample_launch(x, wk, b, y)
    return y


def vae_upsample_launch(x: torch.Tensor, wk: torch.Tensor, b: torch.Tensor,
                        y: torch.Tensor) -> None:
    """One launch of K4 (csrc/vae_upsample.cu) on inputs that
    `fused_upsample_conv2d_cuda` has checked: writes y [B, Cout, T, 2h, 2w]
    (bf16, channels_last_3d) from x [B, Cin, T, h, w], wk
    (`upsample_weights_kmajor`) and the fp32 bias."""
    bsz, cin, t, h, w = x.shape
    cout = wk.shape[3]
    if x.numel() == 0:
        return
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        VAE_UPSAMPLE.launch(x.data_ptr(), wk.data_ptr(), b.data_ptr(),
                            y.data_ptr(), bsz, t, h, w, cin, cout, stream)


def fused_act_causal_conv3d(x, cache, gamma, w2, b, residual=None, wk=None):
    """K3 on CUDA tensors, its plain version on CPU tensors (which reads
    w2; `wk`, the kernel's copy of the same weights, is then unused)."""
    if x.is_cuda:
        return fused_act_causal_conv3d_cuda(x, cache, gamma, w2, b, residual,
                                            wk)
    if x.device.type != "cpu":
        raise ValueError(f"no K3 path for device {x.device}")
    return fused_act_causal_conv3d_plain(x, cache, gamma, w2, b, residual)


def fused_upsample_conv2d(x, w4, b, wk=None):
    """K4 on CUDA tensors, its plain version on CPU tensors (which reads
    w4; `wk`, the kernel's copy of the same weights, is then unused)."""
    if x.is_cuda:
        return fused_upsample_conv2d_cuda(x, w4, b, wk)
    if x.device.type != "cpu":
        raise ValueError(f"no K4 path for device {x.device}")
    return fused_upsample_conv2d_plain(x, w4, b)
