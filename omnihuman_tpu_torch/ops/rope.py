"""3D factorised rotary position embeddings (port of omnihuman_tpu/ops/rope.py).

The head dimension d is split (d - 4*(d//6), 2*(d//6), 2*(d//6)) across
the (frame, height, width) axes of the latent-token grid; a token at grid
position (fi, hi, wi) is rotated by the concatenated per-axis angles, and
the rotation acts on ADJACENT value pairs (x[2j], x[2j+1]) (reference
wan/modules/model.py:31-69). Angle tables are float64 numpy, computed
once per grid; padded tokens beyond F*H*W get the identity rotation.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch


def rope_dim_split(head_dim: int) -> Tuple[int, int, int]:
    """Per-axis pair counts (f_pairs, h_pairs, w_pairs); sums to head_dim//2."""
    c = head_dim // 2
    m = c // 3
    return c - 2 * m, m, m


@functools.lru_cache(maxsize=32)
def _axis_inv_freq(pairs: int, theta: float) -> np.ndarray:
    dim = 2 * pairs
    return theta ** (-np.arange(0, dim, 2, dtype=np.float64) / dim)


def rope_angles_3d(
    grid: Tuple[int, int, int],
    head_dim: int,
    theta: float = 10000.0,
    seq_len: Optional[int] = None,
    shard_offset: int = 0,
    shard_len: Optional[int] = None,
    time_offset: int = 0,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sin, cos) fp32 tables of shape [L, head_dim//2] for a token grid;
    positions >= F*H*W (up to seq_len) get the identity rotation."""
    f, h, w = grid
    n_tokens = f * h * w
    total = seq_len if seq_len is not None else n_tokens

    fp, hp, wp = rope_dim_split(head_dim)
    f_ang = np.arange(f, dtype=np.float64)[:, None] + float(time_offset)
    f_ang = f_ang * _axis_inv_freq(fp, theta)[None, :]
    h_ang = np.arange(h, dtype=np.float64)[:, None] * _axis_inv_freq(hp, theta)
    w_ang = np.arange(w, dtype=np.float64)[:, None] * _axis_inv_freq(wp, theta)

    ang = np.concatenate([
        np.broadcast_to(f_ang[:, None, None, :], (f, h, w, fp)),
        np.broadcast_to(h_ang[None, :, None, :], (f, h, w, hp)),
        np.broadcast_to(w_ang[None, None, :, :], (f, h, w, wp)),
    ], axis=-1).reshape(n_tokens, head_dim // 2)

    if total > n_tokens:
        ang = np.concatenate(
            [ang, np.zeros((total - n_tokens, head_dim // 2))], axis=0)
    if shard_len is not None:
        ang = ang[shard_offset:shard_offset + shard_len]

    sin = torch.from_numpy(np.sin(ang).astype(np.float32))
    cos = torch.from_numpy(np.cos(ang).astype(np.float32))
    return sin.to(device), cos.to(device)


def apply_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor,
               inverse: bool = False) -> torch.Tensor:
    """Rotate adjacent pairs of x [..., L, N, D] by sin / cos [L, D//2]:
    out[2j] = x[2j] cos - x[2j+1] sin, out[2j+1] = x[2j+1] cos + x[2j] sin,
    in fp32, result in x.dtype. inverse rotates by -angle."""
    xf = x.float().unflatten(-1, (-1, 2))                 # [..., L, N, D/2, 2]
    x0, x1 = xf[..., 0], xf[..., 1]
    s = (-sin if inverse else sin)[:, None, :]            # [L, 1, D/2]
    c = cos[:, None, :]
    out = torch.stack([x0 * c - x1 * s, x1 * c + x0 * s], dim=-1)
    return out.flatten(-2).to(x.dtype)
