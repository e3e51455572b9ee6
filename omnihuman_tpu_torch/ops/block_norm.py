"""The DiT block's residual sites in one pass: a gated residual add, then a
LayerNorm with an affine or an AdaLN modulation (csrc/block_norm.cu).

One op, `torch.ops.omnihuman_tpu_torch.add_norm`, does what a residual
site of `models/wan_dit.py:_block_forward` does, in fp32 with today's
rounding points (rd = x's dtype, the residual stream's):

    with y:  x' = rd(x + rd(f32(y) * gate))    (round_inner; no gate: y)
             x' = rd(f32(x) + f32(y) * gate)   (not round_inner: the audio
                                                adapter's scalar gate)
    norm:    h  = LN(x') [* w + b] [* (1 + scale) + shift], in `h_dtype`

LN has fp32 two-pass statistics (mean, then the centred variance). The
op returns (x', h); x' is an empty tensor without y, h one without the
norm. CUDA tensors launch the kernel, which reads and writes each row once;
CPU tensors take `add_norm_eager`, the eager chain the DiT ran before the
kernel, so the CPU tests see its numbers. The op's backward keeps only its
inputs: it runs `add_norm_eager` again on them and differentiates that, so
a trainer's gradients are the eager chain's while its forwards (and remat's
recomputes) launch the kernel.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from omnihuman_tpu_torch.ops.cuda_build import CudaKernel
from omnihuman_tpu_torch.ops.norms import layer_norm

MAX_DIM = 6144
ROW_DTYPES = (torch.bfloat16, torch.float32)
BLOCK_NORM = CudaKernel(
    "block_norm", "block_norm.cu", "omni_block_norm",
    [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong,
     ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
     ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong,
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
     ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
     ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])

Opt = Optional[torch.Tensor]


def add_norm_eager(x: torch.Tensor, y: Opt, gate: Opt, round_inner: bool,
                   norm: bool, weight: Opt, bias: Opt, shift: Opt,
                   scale: Opt, eps: float, h_dtype: torch.dtype
                   ) -> Tuple[torch.Tensor, Opt]:
    """The residual site as eager ops: (x', h), x' being x itself without
    y, h None without the norm."""
    rd, f32 = x.dtype, torch.float32
    if y is not None:
        if not round_inner:
            x = (x.to(f32) + y.to(f32) * gate.to(f32)).to(rd)
        elif gate is None:
            x = x + y.to(rd)
        else:
            x = (x + (y.to(f32) * gate).to(rd)).to(rd)
    if not norm:
        return x, None
    h = layer_norm(x, weight, bias, eps=eps, out_dtype=f32)
    if scale is not None:
        h = h * (1.0 + scale) + shift
    return x, h.to(h_dtype)


def _check_rows(name: str, t: torch.Tensor, like: torch.Tensor) -> None:
    """A [B, L, dim] tensor whose rows are packed within each batch."""
    if t.device != like.device:
        raise ValueError(f"{name} is on {t.device}, x on {like.device}")
    if t.dtype not in ROW_DTYPES:
        raise TypeError(f"{name} is {t.dtype}; the kernel takes bfloat16 "
                        "or float32")
    if t.shape != like.shape:
        raise ValueError(f"{name} {tuple(t.shape)} != x {tuple(like.shape)}")
    b, l, d = t.shape
    if t.stride(2) != 1 or (l > 1 and t.stride(1) != d) or (
            b > 1 and t.stride(0) % 8):
        raise ValueError(f"{name} must have contiguous rows packed in each "
                         f"batch (strides {t.stride()})")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def _vector(name: str, v: Opt, b: int, d: int, like: torch.Tensor,
            scalar_ok: bool = False) -> Tuple[Optional[int], int, int]:
    """(pointer, batch stride, scalar) of a [B or 1, 1, dim] fp32 vector
    (or, where `scalar_ok`, a one-element tensor); (None, 0, 0) for None."""
    if v is None:
        return None, 0, 0
    if v.device != like.device:
        raise ValueError(f"{name} is on {v.device}, x on {like.device}")
    if v.dtype != torch.float32:
        raise TypeError(f"{name} is {v.dtype}; the kernel takes float32")
    if scalar_ok and v.numel() == 1:
        return v.data_ptr(), 0, 1
    if (v.dim() != 3 or v.shape[1] != 1 or v.shape[2] != d
            or v.shape[0] not in (1, b) or v.stride(2) != 1):
        raise ValueError(f"{name} {tuple(v.shape)} is not [{b} or 1, 1, {d}]"
                         " with contiguous rows")
    bs = v.stride(0) if v.shape[0] > 1 else 0
    if v.data_ptr() % 16 or bs % 4:
        raise ValueError(f"{name} must be 16-byte aligned")
    return v.data_ptr(), bs, 0


def _param(name: str, p: Opt, d: int, like: torch.Tensor) -> Optional[int]:
    if p is None:
        return None
    if p.device != like.device:
        raise ValueError(f"{name} is on {p.device}, x on {like.device}")
    if p.dtype not in ROW_DTYPES:
        raise TypeError(f"{name} is {p.dtype}; the kernel takes bfloat16 "
                        "or float32")
    if p.shape != (d,) or not p.is_contiguous() or p.data_ptr() % 16:
        raise ValueError(f"{name} must be a contiguous, 16-byte aligned "
                         f"[{d}] tensor")
    return p.data_ptr()


def _check_args(x, y, gate, round_inner, norm, weight, bias, shift,
                scale) -> None:
    if x.dim() != 3:
        raise ValueError(f"x must be [B, L, dim], not {tuple(x.shape)}")
    if y is None and not norm:
        raise ValueError("add_norm with neither y nor the norm does nothing")
    if (shift is None) != (scale is None):
        raise ValueError("the modulation needs both shift and scale")
    if (weight is None) != (bias is None):
        raise ValueError("the affine norm needs both weight and bias")
    if not round_inner and gate is None:
        raise ValueError("round_inner=False is the gated form: give a gate")


def add_norm_cuda(x, y, gate, round_inner, norm, weight, bias, shift, scale,
                  eps, h_dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch csrc/block_norm.cu once on the current stream; raises on
    anything the kernel does not take (device, dtype, dim, layout)."""
    _check_args(x, y, gate, round_inner, norm, weight, bias, shift, scale)
    if not x.is_cuda:
        raise ValueError(f"x is on {x.device}, the kernel needs CUDA")
    b, l, d = x.shape
    if d % 8 or not 0 < d <= MAX_DIM:
        raise ValueError(f"dim {d} unsupported by the kernel: a multiple of "
                         f"8 up to {MAX_DIM}")
    if h_dtype not in ROW_DTYPES:
        raise TypeError(f"h_dtype {h_dtype}; the kernel writes bfloat16 or "
                        "float32")
    _check_rows("x", x, x)
    if y is not None:
        _check_rows("y", y, x)
    g = _vector("gate", gate, b, d, x, scalar_ok=True)
    sh = _vector("shift", shift, b, d, x)
    sc = _vector("scale", scale, b, d, x)
    w, bb = _param("weight", weight, d, x), _param("bias", bias, d, x)
    if weight is not None and weight.dtype != bias.dtype:
        raise TypeError(f"weight {weight.dtype} and bias {bias.dtype} differ")
    x_out = (torch.empty((b, l, d), dtype=x.dtype, device=x.device)
             if y is not None else _empty(x))
    h = (torch.empty((b, l, d), dtype=h_dtype, device=x.device) if norm
         else _empty(x))
    if x.numel() == 0:
        return x_out, h
    bf = torch.bfloat16
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        BLOCK_NORM.launch(
            x.data_ptr(), x.stride(0), None if y is None else y.data_ptr(),
            0 if y is None else y.stride(0), *g, sh[0], sh[1], sc[0], sc[1],
            w, bb, int(weight is not None and weight.dtype == bf),
            None if y is None else x_out.data_ptr(),
            h.data_ptr() if norm else None, int(round_inner), l, b * l, d,
            float(eps), int(x.dtype == bf),
            int(y is not None and y.dtype == bf), int(h_dtype == bf), stream)
    return x_out, h


def _empty(x: torch.Tensor) -> torch.Tensor:
    return x.new_empty((0,))


# The op: an exported program (utils/export.py) traces it with fake
# tensors and calls it, so a loaded program launches the kernel on CUDA
# tensors. CPU tensors take the eager chain.
@torch.library.custom_op("omnihuman_tpu_torch::add_norm", mutates_args=(),
                         device_types="cuda")
def add_norm_op(x: torch.Tensor, y: Opt, gate: Opt, round_inner: bool,
                norm: bool, weight: Opt, bias: Opt, shift: Opt, scale: Opt,
                eps: float, h_dtype: torch.dtype
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    return add_norm_cuda(x, y, gate, round_inner, norm, weight, bias, shift,
                         scale, eps, h_dtype)


@add_norm_op.register_kernel("cpu")
def _add_norm_op_cpu(x, y, gate, round_inner, norm, weight, bias, shift,
                     scale, eps, h_dtype):
    _check_args(x, y, gate, round_inner, norm, weight, bias, shift, scale)
    xo, h = add_norm_eager(x, y, gate, round_inner, norm, weight, bias,
                           shift, scale, eps, h_dtype)
    return (xo if y is not None else _empty(x),
            h if norm else _empty(x))


@add_norm_op.register_fake
def _add_norm_op_fake(x, y, gate, round_inner, norm, weight, bias, shift,
                      scale, eps, h_dtype):
    _check_args(x, y, gate, round_inner, norm, weight, bias, shift, scale)
    xo = (torch.empty_like(x, memory_format=torch.contiguous_format)
          if y is not None else _empty(x))
    h = (torch.empty_like(x, dtype=h_dtype,
                          memory_format=torch.contiguous_format)
         if norm else _empty(x))
    return xo, h


_TENSORS = (0, 1, 2, 5, 6, 7, 8)      # the op's tensor arguments


def _setup_context(ctx, inputs, output):
    # tensors through save_for_backward alone, so that remat's saved-tensor
    # hooks see them
    ctx.save_for_backward(*(inputs[i] for i in _TENSORS))
    ctx.args = [None if i in _TENSORS else a for i, a in enumerate(inputs)]


def _backward(ctx, grad_x, grad_h):
    """The eager chain again, on the saved inputs, and its gradient."""
    need = [ctx.needs_input_grad[i] for i in _TENSORS]
    args = list(ctx.args)
    with torch.enable_grad():
        for i, t, n in zip(_TENSORS, ctx.saved_tensors, need):
            args[i] = None if t is None else t.detach().requires_grad_(n)
        xo, h = add_norm_eager(*args)
        outs, grads = [], []
        if args[1] is not None and grad_x is not None:
            outs.append(xo)
            grads.append(grad_x)
        if args[4] and grad_h is not None:
            outs.append(h)
            grads.append(grad_h)
        wrt = [args[i] for i, n in zip(_TENSORS, need) if n]
        got = iter(torch.autograd.grad(outs, wrt, grads, allow_unused=True)
                   if outs and wrt else [None] * len(wrt))
    out = [None] * len(args)
    for i, n in zip(_TENSORS, need):
        if n:
            out[i] = next(got)
    return tuple(out)


add_norm_op.register_autograd(_backward, setup_context=_setup_context)


def add_norm(x: torch.Tensor, y: Opt = None, gate: Opt = None, *,
             round_inner: bool = True, norm: bool = True, weight: Opt = None,
             bias: Opt = None, shift: Opt = None, scale: Opt = None,
             eps: float = 1e-6, h_dtype: Optional[torch.dtype] = None
             ) -> Tuple[torch.Tensor, Opt]:
    """One residual site through the op (the kernel on CUDA tensors):
    (x', h), x' being x itself without y and h None without the norm; h
    in `h_dtype` (default x's)."""
    h_dtype = x.dtype if h_dtype is None else h_dtype
    xo, h = add_norm_op(x, y, gate, bool(round_inner), bool(norm), weight,
                        bias, shift, scale, float(eps), h_dtype)
    return (x if y is None else xo), (h if norm else None)
