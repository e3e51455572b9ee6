"""int8 serving quantization of the DiT block GEMMs (port of
omnihuman_tpu/ops/quant.py): W8A8, weights per output channel, activations
per token.

Scheme (the JAX package's, `quant.py:1-32`):
  - weights: symmetric int8 per OUTPUT channel, quantized once after the
    weights are final (`quantize_wan_model`); the float weight is replaced
    by (`w_q` int8 [out, in], `w_s` fp32 [out]), so memory holds one copy;
  - activations: symmetric int8 per token (amax over the features),
    computed in fp32 at every call;
  - the product of the two int8 matrices accumulates in int32
    (`torch._int_mm`, cuBLASLt on the card), is dequantized in fp32 as
    (y * row scale) * column scale, gets the bias and is cast to the
    input's dtype.

Only the transformer blocks' GEMMs are quantized: the self / cross
attention projections (`q k v o k_img v_img`) and the FFN. Embeddings,
time / text MLPs, AdaLN, norms, attention itself, the head and the
OmniHuman audio adapters keep their dtypes. Serving only: training never
sees an `Int8Linear`.

`torch._int_mm` on CUDA takes only M > 16 rows and K, N multiples of 8.
Fewer rows are padded with zero rows, which is exact (their products are
dropped); K or N off the multiple of 8 raises. The product never falls
back to a float GEMM.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

# block GEMMs of the Wan DiT (models/wan_dit.py WanAttention / ffn)
ATTN_GEMMS = ("q", "k", "v", "o", "k_img", "v_img")
INT_MM_MIN_ROWS = 17    # torch._int_mm on CUDA needs more than 16 rows


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., out, in] float -> (w_q int8 [..., out, in], w_s fp32 [..., out])
    with w ~= w_q * w_s[..., None]: the JAX rounding (half to even), clip
    to +-127 and 1e-8 floor on the scale, over the torch [out, in] layout
    (JAX reduces its [in, out] weight over `in` as well). The scale is
    amax x fp32(1/127): XLA compiles the JAX package's division by the
    constant 127 into that product."""
    wf = w.to(torch.float32)
    amax = wf.abs().amax(dim=-1, keepdim=True)
    s = torch.clamp(amax, min=1e-8) * (1.0 / 127.0)
    w_q = torch.clamp(torch.round(wf / s), -127, 127).to(torch.int8)
    return w_q, s.squeeze(-1)


class Int8Linear(nn.Module):
    """A quantized nn.Linear: `w_q` int8 [out, in], `w_s` fp32 [out] and
    the bias in the weight's former dtype (buffers: serving holds no
    gradient)."""

    def __init__(self, w_q: torch.Tensor, w_s: torch.Tensor,
                 bias: torch.Tensor):
        super().__init__()
        self.register_buffer("w_q", w_q)
        self.register_buffer("w_s", w_s)
        self.register_buffer("bias", bias)

    @classmethod
    def from_linear(cls, lin: nn.Linear) -> "Int8Linear":
        w_q, w_s = quantize_weight(lin.weight.detach())
        bias = (lin.bias.detach().clone() if lin.bias is not None else
                torch.zeros(lin.out_features, device=lin.weight.device))
        return cls(w_q, w_s, bias)


def _int_mm(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """[M, K] int8 @ [N, K]^T int8 -> [M, N] int32 in `torch._int_mm`."""
    m, k = x_q.shape
    n = w_q.shape[0]
    if x_q.is_cuda and (k % 8 or n % 8):
        raise ValueError(f"int8 GEMM [{m}, {k}] x [{k}, {n}]: torch._int_mm "
                         "on CUDA needs K and N multiples of 8")
    if m < INT_MM_MIN_ROWS:                 # zero rows: exact, dropped
        x_q = torch.cat([x_q, x_q.new_zeros((INT_MM_MIN_ROWS - m, k))])
    return torch._int_mm(x_q, w_q.t())[:m]


def int8_linear(lin: Int8Linear, x: torch.Tensor) -> torch.Tensor:
    """y = x @ W^T + b through the int8 GEMM (JAX `int8_linear`):
    x [..., in] any float dtype -> [..., out] in x.dtype."""
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=-1, keepdim=True)
    sx = torch.clamp(amax, min=1e-8) * (1.0 / 127.0)
    x_q = torch.clamp(torch.round(xf / sx), -127, 127).to(torch.int8)
    y = _int_mm(x_q.reshape(-1, x_q.shape[-1]), lin.w_q)
    y = y.reshape(*x.shape[:-1], y.shape[-1])
    yf = y.to(torch.float32) * sx * lin.w_s.to(torch.float32)
    return (yf + lin.bias.to(torch.float32)).to(x.dtype)


def quantize_wan_model(model: nn.Module) -> nn.Module:
    """Swap the block GEMMs of a WanModel (or of an OmniModel's base) for
    Int8Linear in place: self / cross attention `q k v o k_img v_img` and
    the FFN. Everything else, the audio adapters included, stays as it
    is. Returns the model."""
    base = getattr(model, "base", model)
    for blk in base.blocks:
        for attn in (blk.self_attn, blk.cross_attn):
            for name in ATTN_GEMMS:
                lin = getattr(attn, name, None)
                if isinstance(lin, nn.Linear):
                    setattr(attn, name, Int8Linear.from_linear(lin))
        for i in (0, 2):
            if isinstance(blk.ffn[i], nn.Linear):
                blk.ffn[i] = Int8Linear.from_linear(blk.ffn[i])
    return model
