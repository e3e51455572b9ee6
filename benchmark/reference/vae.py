"""The Wan 2.1 VAE decoder, streaming, in plain fp32 (reference
wan/modules/vae.py: WanVAE_.decode, Decoder3d, ResidualBlock,
AttentionBlock, Resample, CausalConv3d, RMS_norm).

The latent is de-normalised, passed through `conv2`, and decoded one
latent frame at a time. Every causal conv keeps the last two frames of
its padded input (zeros before the first chunk), which is the reference's
feat_cache arithmetic; the time-upsampling conv passes the first chunk
through and starts its history from zeros (the reference's 'Rep'). The
video is clamped to [-1, 1].
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F

from benchmark.reference.common import attention, fp8_round


def _w(sd, name, fp8):
    w = sd[name].float()
    return fp8_round(w) if fp8 else w


def rms(x, gamma):
    """F.normalize over channels * sqrt(C) * gamma."""
    c = x.shape[1]
    return F.normalize(x, dim=1) * math.sqrt(c) * gamma.float().reshape(
        1, c, *([1] * (x.dim() - 2)))


class _Caches:
    def __init__(self):
        self.store: Dict[str, torch.Tensor] = {}


def causal_conv(sd, name, x, caches: _Caches, fp8: bool):
    """CausalConv3d over one chunk with its 2-frame history; SAME padding
    in space. A 1x1x1 conv has no history."""
    w = _w(sd, name + ".weight", fp8)
    b = sd[name + ".bias"].float()
    kt, kh, kw = w.shape[2:]
    xin = x
    if kt > 1:
        hist = caches.store.get(name)
        if hist is None:
            hist = torch.zeros_like(x[:, :, :1]).expand(
                -1, -1, kt - 1, -1, -1)
        xin = torch.cat([hist, x], dim=2)
        caches.store[name] = xin[:, :, -(kt - 1):]
    if fp8:
        xin = fp8_round(xin)
    return F.conv3d(xin, w, b, padding=(0, (kh - 1) // 2, (kw - 1) // 2))


def residual_block(sd, p, x, caches, fp8):
    h = x
    if p + ".shortcut.weight" in sd:
        h = causal_conv(sd, p + ".shortcut", x, caches, fp8)
    y = F.silu(rms(x, sd[p + ".residual.0.gamma"]))
    y = causal_conv(sd, p + ".residual.2", y, caches, fp8)
    y = F.silu(rms(y, sd[p + ".residual.3.gamma"]))
    y = causal_conv(sd, p + ".residual.6", y, caches, fp8)
    return y + h


def attention_block(sd, p, x, fp8):
    """Single-head attention within each frame, 1x1 projections."""
    b, c, t, h, w = x.shape
    z = rms(x, sd[p + ".norm.gamma"])
    z = z.permute(0, 2, 3, 4, 1).reshape(b * t, h * w, c)
    wq = _w(sd, p + ".to_qkv.weight", fp8)[:, :, 0, 0]
    qkv = (fp8_round(z) if fp8 else z) @ wq.t() + sd[p + ".to_qkv.bias"
                                                    ].float()
    q, k, v = qkv.chunk(3, dim=-1)
    ys = [attention(q[i][:, None], k[i][:, None], v[i][:, None])[:, 0]
          for i in range(b * t)]
    y = torch.stack(ys)
    wp = _w(sd, p + ".proj.weight", fp8)[:, :, 0, 0]
    y = (fp8_round(y) if fp8 else y) @ wp.t() + sd[p + ".proj.bias"].float()
    return x + y.reshape(b, t, h, w, c).permute(0, 4, 1, 2, 3)


def resample_up(sd, p, x, caches, first, temporal, fp8):
    """Time upsampling (3d mode: a channel-doubling causal time conv whose
    two halves interleave as frames 2i, 2i+1; the first chunk passes),
    then nearest 2x and a 3x3 conv halving the channels."""
    if temporal and not first:
        c = x.shape[1]
        y = causal_conv(sd, p + ".time_conv", x, caches, fp8)
        b, _, t, h, w = y.shape
        x = y.reshape(b, 2, c, t, h, w).permute(0, 2, 3, 1, 4, 5).reshape(
            b, c, 2 * t, h, w)
    b, c, t, h, w = x.shape
    z = x.permute(0, 2, 1, 3, 4).reshape(b * t, c, h, w)
    z = F.interpolate(z, scale_factor=2.0, mode="nearest")
    z = F.conv2d(fp8_round(z) if fp8 else z, _w(sd, p + ".resample.1.weight",
                                                   fp8),
                 sd[p + ".resample.1.bias"].float(), padding=1)
    return z.reshape(b, t, z.shape[1], 2 * h, 2 * w).permute(0, 2, 1, 3, 4)


def decoder_layers(v: dict) -> List[tuple]:
    """(kind, module name) in order: conv1, middle (res, attn, res), the
    upsampling levels (res x (num_res_blocks + 1), then a resample but at
    the last level), head."""
    mult = v["dim_mult"]
    tup = list(reversed(v["temporal_downsample"]))
    out = [("conv", "decoder.conv1"), ("res", "decoder.middle.0"),
           ("attn", "decoder.middle.1"), ("res", "decoder.middle.2")]
    j = 0
    for i in range(len(mult)):
        for _ in range(v["num_res_blocks"] + 1):
            out.append(("res", f"decoder.upsamples.{j}"))
            j += 1
        if i != len(mult) - 1:
            out.append(("up3d" if tup[i] else "up2d",
                        f"decoder.upsamples.{j}"))
            j += 1
    out.append(("head", "decoder.head"))
    return out


def decode(sd: dict, v: dict, z: torch.Tensor, fp8: bool = False,
           frames_out=None) -> torch.Tensor:
    """Normalised latent [B, z, T, h, w] -> video [B, 3, 1 + 4 (T-1), 8h,
    8w] fp32 in [-1, 1]. `frames_out(i, chunk)` receives each decoded
    chunk instead of keeping the whole video (None: return it)."""
    mean = torch.tensor(v["latent_mean"], device=z.device).view(1, -1, 1, 1, 1)
    std = torch.tensor(v["latent_std"], device=z.device).view(1, -1, 1, 1, 1)
    x = z.float() * std + mean
    x = F.conv3d(x, _w(sd, "conv2.weight", fp8), sd["conv2.bias"].float())
    caches = _Caches()
    layers = decoder_layers(v)
    outs = []
    for i in range(x.shape[2]):
        h = x[:, :, i:i + 1]
        for kind, name in layers:
            if kind == "conv":
                h = causal_conv(sd, name, h, caches, fp8)
            elif kind == "res":
                h = residual_block(sd, name, h, caches, fp8)
            elif kind == "attn":
                h = attention_block(sd, name, h, fp8)
            elif kind in ("up2d", "up3d"):
                h = resample_up(sd, name, h, caches, i == 0, kind == "up3d",
                                fp8)
            else:
                h = F.silu(rms(h, sd[name + ".0.gamma"]))
                h = causal_conv(sd, name + ".2", h, caches, fp8)
        h = h.clamp(-1.0, 1.0)
        if frames_out is None:
            outs.append(h)
        else:
            frames_out(i, h)
    return torch.cat(outs, dim=2) if frames_out is None else None
