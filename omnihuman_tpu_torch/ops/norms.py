"""Normalisation + AdaLN modulation (port of omnihuman_tpu/ops/norms.py).

  - WanRMSNorm (model.py:72-88): x * rsqrt(mean(x^2) + eps) * weight,
    statistics in fp32, output in the input dtype.
  - WanLayerNorm (model.py:91-104): fp32 LayerNorm, optionally affine.
  - AdaLN (model.py:288-296): x * (1 + scale) + shift in fp32.
"""

from __future__ import annotations

from typing import Optional

import torch


def rms_norm(x: torch.Tensor, weight: Optional[torch.Tensor] = None,
             eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm with fp32 statistics, result in x.dtype."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.reciprocal(torch.sqrt(var + eps))
    if weight is not None:
        y = y * weight.float()
    return y.to(x.dtype)


def layer_norm(x: torch.Tensor, weight: Optional[torch.Tensor] = None,
               bias: Optional[torch.Tensor] = None, eps: float = 1e-6,
               out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """LayerNorm with fp32 statistics; output cast to `out_dtype`
    (default: x.dtype)."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.reciprocal(torch.sqrt(var + eps))
    if weight is not None:
        y = y * weight.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype if out_dtype is not None else x.dtype)


def adaln_modulate(x: torch.Tensor, shift: torch.Tensor,
                   scale: torch.Tensor) -> torch.Tensor:
    """x * (1 + scale) + shift, computed in fp32 (model.py:291,327)."""
    return x.float() * (1.0 + scale.float()) + shift.float()
