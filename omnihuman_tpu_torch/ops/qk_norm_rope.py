"""The DiT attention's q / k RMSNorm and 3D RoPE rotation in one pass
(csrc/qk_norm_rope.cu).

One op, `torch.ops.omnihuman_tpu_torch.qk_norm_rope`, does what
`models/wan_dit.py` did with `rms_norm` (ops/norms.py) and `apply_rope`
(ops/rope.py) on an attention's q and k [B, L, dim]:

    q' = apply_rope(rms_norm(q, wq, eps), sin, cos)    (no tables: the norm)
    k' = apply_rope(rms_norm(k, wk, eps), sin, cos)    (when k is given)

with the tables sin / cos [L, head_dim / 2] fp32, the norm over the whole
dim and the rotation over each head's adjacent pairs. The op returns (q',
k') in the rows' dtype, contiguous; k' is an empty tensor without k.
CUDA tensors launch the kernel, which reads and writes each row once and
rounds where the eager chain rounds; CPU tensors take `qk_norm_rope_eager`,
the eager chain itself, so the CPU tests see its numbers. The op's
backward keeps only its inputs: it runs the eager chain again on them and
differentiates that, so a trainer's gradients are the eager chain's while
its forwards (and remat's recomputes) launch the kernel.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from omnihuman_tpu_torch.ops.cuda_build import CudaKernel
from omnihuman_tpu_torch.ops.norms import rms_norm
from omnihuman_tpu_torch.ops.rope import apply_rope

MAX_DIM = 6144
ROW_DTYPES = (torch.bfloat16, torch.float32)
QK_NORM_ROPE = CudaKernel(
    "qk_norm_rope", "qk_norm_rope.cu", "omni_qk_norm_rope",
    [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong,
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
     ctypes.c_float, ctypes.c_int, ctypes.c_void_p])

Opt = Optional[torch.Tensor]


def qk_norm_rope_eager(q: torch.Tensor, k: Opt, wq: torch.Tensor, wk: Opt,
                       sin: Opt, cos: Opt, eps: float
                       ) -> Tuple[torch.Tensor, Opt]:
    """The eager chain: (q', k'), k' None without k."""
    def one(x, w):
        y = rms_norm(x, w, eps=eps)
        if sin is None:
            return y
        b, l, d = y.shape
        hd = 2 * sin.shape[-1]
        return apply_rope(y.reshape(b, l, d // hd, hd), sin,
                          cos).reshape(b, l, d)

    return one(q, wq), (None if k is None else one(k, wk))


def _check_args(q, k, wq, wk, sin, cos) -> None:
    if q.dim() != 3:
        raise ValueError(f"q must be [B, L, dim], not {tuple(q.shape)}")
    d = q.shape[2]
    if k is not None:
        if k.dim() != 3 or k.shape[0] != q.shape[0] or k.shape[2] != d:
            raise ValueError(f"k {tuple(k.shape)} is not [{q.shape[0]}, L, "
                             f"{d}]")
        if k.dtype != q.dtype:
            raise TypeError(f"k is {k.dtype}, q {q.dtype}")
    if (k is None) != (wk is None):
        raise ValueError("k and its norm weight wk come together")
    for name, w in (("wq", wq), ("wk", wk)):
        if w is not None and w.shape != (d,):
            raise ValueError(f"{name} {tuple(w.shape)} is not [{d}]")
    if (sin is None) != (cos is None):
        raise ValueError("the rotation needs both sin and cos")
    if sin is not None:
        half = sin.shape[-1] if sin.dim() == 2 else 0
        if (sin.dim() != 2 or sin.shape != cos.shape
                or sin.shape[0] != q.shape[1] or half == 0
                or d % (2 * half)):
            raise ValueError(f"tables {tuple(sin.shape)} / {tuple(cos.shape)}"
                             f" are not [{q.shape[1]}, head_dim / 2] for "
                             f"dim {d}")
        if k is not None and k.shape != q.shape:
            raise ValueError(f"rotated k {tuple(k.shape)} != q "
                             f"{tuple(q.shape)}")


def _check_rows(name: str, t: torch.Tensor, like: torch.Tensor) -> None:
    """A [B, L, dim] tensor whose rows are packed within each batch."""
    if t.device != like.device:
        raise ValueError(f"{name} is on {t.device}, q on {like.device}")
    if t.dtype not in ROW_DTYPES:
        raise TypeError(f"{name} is {t.dtype}; the kernel takes bfloat16 "
                        "or float32")
    b, l, d = t.shape
    if t.stride(2) != 1 or (l > 1 and t.stride(1) != d) or (
            b > 1 and t.stride(0) % 8):
        raise ValueError(f"{name} must have contiguous rows packed in each "
                         f"batch (strides {t.stride()})")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def _check_param(name: str, t: torch.Tensor, like: torch.Tensor,
                 dtypes) -> None:
    if t.device != like.device:
        raise ValueError(f"{name} is on {t.device}, q on {like.device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} is {t.dtype}; the kernel takes "
                        f"{' or '.join(str(d) for d in dtypes)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def qk_norm_rope_cuda(q, k, wq, wk, sin, cos, eps
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch csrc/qk_norm_rope.cu once on the current stream; raises on
    anything the kernel does not take (device, dtype, dim, layout)."""
    _check_args(q, k, wq, wk, sin, cos)
    if not q.is_cuda:
        raise ValueError(f"q is on {q.device}, the kernel needs CUDA")
    b, lq, d = q.shape
    if d % 8 or not 0 < d <= MAX_DIM:
        raise ValueError(f"dim {d} unsupported by the kernel: a multiple of "
                         f"8 up to {MAX_DIM}")
    head_dim = 0 if sin is None else 2 * sin.shape[1]
    if sin is not None and (head_dim % 8 or 256 % head_dim):
        raise ValueError(f"head_dim {head_dim} unsupported by the kernel: "
                         "a multiple of 8 that divides 256")
    _check_rows("q", q, q)
    _check_param("wq", wq, q, ROW_DTYPES)
    if k is not None:
        _check_rows("k", k, q)
        _check_param("wk", wk, q, ROW_DTYPES)
    if sin is not None:
        _check_param("sin", sin, q, (torch.float32,))
        _check_param("cos", cos, q, (torch.float32,))
    q_out = torch.empty((b, lq, d), dtype=q.dtype, device=q.device)
    k_out = (torch.empty((b, k.shape[1], d), dtype=q.dtype, device=q.device)
             if k is not None else _empty(q))
    if q_out.numel() + k_out.numel() == 0:
        return q_out, k_out
    bf = torch.bfloat16
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        QK_NORM_ROPE.launch(
            q.data_ptr(), q.stride(0), None if k is None else k.data_ptr(),
            0 if k is None else k.stride(0), wq.data_ptr(),
            None if k is None else wk.data_ptr(), int(wq.dtype == bf),
            int(wk is not None and wk.dtype == bf),
            None if sin is None else sin.data_ptr(),
            None if cos is None else cos.data_ptr(), q_out.data_ptr(),
            None if k is None else k_out.data_ptr(), b, lq,
            0 if k is None else k.shape[1], d, head_dim, float(eps),
            int(q.dtype == bf), stream)
    return q_out, k_out


def _empty(x: torch.Tensor) -> torch.Tensor:
    return x.new_empty((0,))


# The op: an exported program (utils/export.py) traces it with fake
# tensors and calls it, so a loaded program launches the kernel on CUDA
# tensors. CPU tensors take the eager chain.
@torch.library.custom_op("omnihuman_tpu_torch::qk_norm_rope",
                         mutates_args=(), device_types="cuda")
def qk_norm_rope_op(q: torch.Tensor, k: Opt, wq: torch.Tensor, wk: Opt,
                    sin: Opt, cos: Opt, eps: float
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    return qk_norm_rope_cuda(q, k, wq, wk, sin, cos, eps)


@qk_norm_rope_op.register_kernel("cpu")
def _qk_norm_rope_op_cpu(q, k, wq, wk, sin, cos, eps):
    _check_args(q, k, wq, wk, sin, cos)
    qo, ko = qk_norm_rope_eager(q, k, wq, wk, sin, cos, eps)
    return qo, (_empty(q) if ko is None else ko)


@qk_norm_rope_op.register_fake
def _qk_norm_rope_op_fake(q, k, wq, wk, sin, cos, eps):
    _check_args(q, k, wq, wk, sin, cos)
    qo = torch.empty_like(q, memory_format=torch.contiguous_format)
    ko = (_empty(q) if k is None else
          torch.empty_like(k, memory_format=torch.contiguous_format))
    return qo, ko


_TENSORS = (0, 1, 2, 3, 4, 5)      # the op's tensor arguments


def _setup_context(ctx, inputs, output):
    # tensors through save_for_backward alone, so that remat's saved-tensor
    # hooks see them
    ctx.save_for_backward(*inputs[:6])
    ctx.eps = inputs[6]


def _backward(ctx, grad_q, grad_k):
    """The eager chain again, on the saved inputs, and its gradient."""
    need = ctx.needs_input_grad[:6]
    with torch.enable_grad():
        args = [None if t is None else t.detach().requires_grad_(n)
                for t, n in zip(ctx.saved_tensors, need)]
        qo, ko = qk_norm_rope_eager(*args, ctx.eps)
        # an output none of whose inputs needs a gradient (a cross-
        # attention's k from a frozen context) takes no part
        outs, grads = [], []
        for o, g in ((qo, grad_q), (ko, grad_k)):
            if o is not None and g is not None and o.requires_grad:
                outs.append(o)
                grads.append(g)
        wrt = [a for a, n in zip(args, need) if n]
        got = iter(torch.autograd.grad(outs, wrt, grads, allow_unused=True)
                   if outs and wrt else [None] * len(wrt))
    return tuple(next(got) if n else None for n in need) + (None,)


qk_norm_rope_op.register_autograd(_backward, setup_context=_setup_context)


def qk_norm_rope(q: torch.Tensor, k: Opt, wq: torch.Tensor, wk: Opt = None,
                 sin: Opt = None, cos: Opt = None, *, eps: float = 1e-6
                 ) -> Tuple[torch.Tensor, Opt]:
    """q (and k) [B, L, dim] normed and, with tables, rotated through the
    op (the kernel on CUDA tensors): (q', k'), k' None without k."""
    qo, ko = qk_norm_rope_op(q, k, wq, wk, sin, cos, float(eps))
    return qo, (None if k is None else ko)
