"""Wan 2.1 3D causal video VAE, decode path (port of omnihuman_tpu/models/vae.py).

The decoder of the reference WanVAE (wan/modules/vae.py): causal 3x3x3
convs, two temporal upsamples (channel-doubling time conv + frame
interleave, with the 'Rep' first-frame rule), single-head per-frame
spatial attention in the middle, RMS channel norms, and the latent
de-normalisation. Module names follow the reference (`decoder.*`,
`conv2`), so the decoder part of a Wan2.1_VAE.pth state dict loads with
`load_state_dict`.

Two ways to run it, with the same outputs (JAX vae_decode):
  streaming=False: one causal-conv graph over the whole clip;
  streaming=True:  the first latent frame, then one latent frame per step
                   with 2-frame conv caches: bounded memory for long clips.

Layout is the reference's [B, C, T, H, W] throughout. Convs are
torch.nn.functional conv3d (cuDNN on the card), as the JAX package leaves
this path to XLA; the fused Pallas VAE kernels are opt-in there and come
in a later slice here. The RGB head is a plain causal conv (the JAX
`_head_conv_blocked` is a TPU lane-fill rewrite of the same function).
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from omnihuman_tpu_torch.configs.wan import VAEConfig

# ---------------------------------------------------------------------------
# module tree (reference names)


class RMS_norm(nn.Module):
    """Channel RMS norm's parameter: gamma [C, 1, 1, 1] (video) or
    [C, 1, 1] (images, the attention block)."""

    def __init__(self, dim: int, images: bool = False):
        super().__init__()
        shape = (dim, 1, 1) if images else (dim, 1, 1, 1)
        self.gamma = nn.Parameter(torch.ones(shape))


def _causal_conv(cin, cout, k=(3, 3, 3)):
    return nn.Conv3d(cin, cout, k)


class ResidualBlock(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.residual = nn.Sequential(
            RMS_norm(cin), nn.SiLU(), _causal_conv(cin, cout),
            RMS_norm(cout), nn.SiLU(), nn.Dropout(0.0),
            _causal_conv(cout, cout))
        self.shortcut = (_causal_conv(cin, cout, (1, 1, 1))
                         if cin != cout else nn.Identity())


class AttentionBlock(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.norm = RMS_norm(dim, images=True)
        self.to_qkv = nn.Conv2d(dim, dim * 3, 1)
        self.proj = nn.Conv2d(dim, dim, 1)


class Resample(nn.Module):
    def __init__(self, dim: int, mode: str):
        super().__init__()
        if mode not in ("upsample2d", "upsample3d"):
            raise NotImplementedError(
                f"Resample {mode!r}: the encoder comes in a later slice")
        self.mode = mode
        self.resample = nn.Sequential(nn.Identity(),
                                      nn.Conv2d(dim, dim // 2, 3))
        if mode == "upsample3d":
            self.time_conv = _causal_conv(dim, dim * 2, (3, 1, 1))


def decoder_spec(cfg: VAEConfig) -> List[Tuple]:
    """Static layer list of the decoder (JAX decoder_spec)."""
    dims = [cfg.base_dim * u
            for u in (cfg.dim_mult[-1],) + tuple(reversed(cfg.dim_mult))]
    temporal_up = tuple(reversed(cfg.temporal_downsample))
    spec: List[Tuple] = [("conv_in", cfg.z_dim, dims[0]),
                         ("res", dims[0], dims[0]), ("attn", dims[0]),
                         ("res", dims[0], dims[0])]
    for i, (din, dout) in enumerate(zip(dims[:-1], dims[1:])):
        if i > 0:
            din = din // 2
        for _ in range(cfg.num_res_blocks + 1):
            spec.append(("res", din, dout))
            din = dout
        if i != len(cfg.dim_mult) - 1:
            mode = "upsample3d" if temporal_up[i] else "upsample2d"
            spec.append(("resample", dout, mode))
    spec.append(("head", dout, 3))
    return spec


def _make_layer(item) -> nn.Module:
    kind = item[0]
    if kind == "res":
        return ResidualBlock(item[1], item[2])
    if kind == "attn":
        return AttentionBlock(item[1])
    if kind == "resample":
        return Resample(item[1], item[2])
    raise ValueError(kind)


class Decoder3d(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        spec = decoder_spec(cfg)
        self.conv1 = _causal_conv(spec[0][1], spec[0][2])
        self.middle = nn.Sequential(*[_make_layer(it) for it in spec[1:4]])
        self.upsamples = nn.Sequential(
            *[_make_layer(it) for it in spec[4:-1]])
        cin = spec[-1][1]
        self.head = nn.Sequential(RMS_norm(cin), nn.SiLU(),
                                  _causal_conv(cin, 3))


class WanVAEDecoder(nn.Module):
    """`decoder` + the 1x1x1 latent conv `conv2` of the reference WanVAE_."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        self.decoder = Decoder3d(cfg)
        self.conv2 = _causal_conv(cfg.z_dim, cfg.z_dim, (1, 1, 1))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """JAX init_vae's rule: conv weights and biases uniform in
        +-1/sqrt(fan_in), norms at 1, the attention projection at 0."""
        for m in self.modules():
            if isinstance(m, (nn.Conv3d, nn.Conv2d)):
                a = 1.0 / math.sqrt(math.prod(m.weight.shape[1:]))
                m.weight.uniform_(-a, a, generator=generator)
                m.bias.uniform_(-a, a, generator=generator)
            elif isinstance(m, RMS_norm):
                m.gamma.fill_(1.0)
        for m in self.modules():
            if isinstance(m, AttentionBlock):
                m.proj.weight.zero_()
                m.proj.bias.zero_()


def build_vae_decoder(cfg: VAEConfig, device, dtype: torch.dtype,
                      seed: Optional[int] = 0) -> WanVAEDecoder:
    with torch.device("meta"):
        vae = WanVAEDecoder(cfg)
    vae = vae.to(dtype).to_empty(device=device)
    if seed is not None:
        vae.init_weights(torch.Generator(device=device).manual_seed(seed))
    return vae.eval().requires_grad_(False)


# ---------------------------------------------------------------------------
# primitive layers (x: [B, C, T, H, W])


def _conv3d(x, conv: nn.Conv3d, padding: str = "causal"):
    """padding='causal': zero-pad kt-1 frames at the front, SAME on h/w;
    'valid_t': no time padding (the caller supplies history)."""
    w, b = conv.weight, conv.bias
    kt, kh, kw = w.shape[2:]
    tpad = (kt - 1, 0) if padding == "causal" else (0, 0)
    x = F.pad(x.to(w.dtype), ((kw - 1) // 2, kw // 2, (kh - 1) // 2, kh // 2)
              + tpad)
    if b.dtype == w.dtype:
        return F.conv3d(x, w, b)
    return F.conv3d(x, w) + b.view(1, -1, 1, 1, 1)   # JAX promotes here


def _conv2d_frames(x, conv: nn.Conv2d):
    """Per-frame SAME conv2d on [B, C, T, H, W] (a 1 x kh x kw conv3d)."""
    w, b = conv.weight, conv.bias
    kh, kw = w.shape[2:]
    x = F.pad(x.to(w.dtype), ((kw - 1) // 2, kw // 2, (kh - 1) // 2, kh // 2))
    w3 = w.unsqueeze(2)
    if b.dtype == w.dtype:
        return F.conv3d(x, w3, b)
    return F.conv3d(x, w3) + b.view(1, -1, 1, 1, 1)


def _rms_norm_channel(x, gamma):
    """F.normalize over channels * sqrt(C) * gamma, fp32 statistics
    (reference RMS_norm, vae.py:39-54)."""
    xf = x.float()
    norm = torch.sqrt(xf.square().sum(dim=1, keepdim=True))
    c = x.shape[1]
    y = xf / torch.clamp(norm, min=1e-12) * math.sqrt(c)
    y = y * gamma.float().reshape(1, c, 1, 1, 1)
    return y.to(x.dtype)


def _spatial_attention(p: AttentionBlock, x):
    """Single-head per-frame self-attention (vae.py:223-263), plain torch."""
    b, c, t, h, w = x.shape
    idn = x
    xf = _rms_norm_channel(x, p.norm.gamma)
    xf = xf.permute(0, 2, 3, 4, 1).reshape(b * t, h * w, c)
    wq, bq = p.to_qkv.weight[:, :, 0, 0], p.to_qkv.bias
    qkv = xf.to(wq.dtype) @ wq.t() + bq
    q, k, v = qkv.chunk(3, dim=-1)
    logits = torch.matmul(q.float(), k.float().transpose(1, 2)) * (c ** -0.5)
    attn = torch.softmax(logits, dim=-1).to(v.dtype)
    y = torch.matmul(attn.float(), v.float()).to(v.dtype)
    wp, bp = p.proj.weight[:, :, 0, 0], p.proj.bias
    dt = torch.promote_types(y.dtype, wp.dtype)
    y = y.to(dt) @ wp.to(dt).t() + bp
    y = y.reshape(b, t, h, w, c).permute(0, 4, 1, 2, 3)
    return idn + y.to(x.dtype)


# ---------------------------------------------------------------------------
# cache plumbing


class _CacheIO:
    """Cursor over the ordered per-conv cache list of the streaming decode.

    caches=None: full-sequence mode (plain causal padding). A streaming
    cursor whose list is shorter than the layers reads None past its end,
    which each layer takes as zero history (the first chunk)."""

    def __init__(self, caches: Optional[List[torch.Tensor]]):
        self.caches = caches
        self.i = 0
        self.out: List[torch.Tensor] = []

    @property
    def streaming(self) -> bool:
        return self.caches is not None

    def next(self):
        c = self.caches[self.i] if self.i < len(self.caches) else None
        self.i += 1
        return c

    def put(self, c):
        self.out.append(c)


def _causal_conv_step(conv: nn.Conv3d, x, io: _CacheIO):
    """CausalConv3d with the optional streaming cache (vae.py:17-35)."""
    kt = conv.weight.shape[2]
    if kt == 1:
        return _conv3d(x, conv, padding="valid_t")
    if not io.streaming:
        return _conv3d(x, conv, padding="causal")
    cache = io.next()
    if cache is None:
        cache = x.new_zeros(x.shape[:2] + (kt - 1,) + x.shape[3:])
    xin = torch.cat([cache.to(x.dtype), x], dim=2)
    io.put(xin[:, :, -(kt - 1):])
    return _conv3d(xin, conv, padding="valid_t")


def _residual_block(p: ResidualBlock, x, io: _CacheIO):
    """RMS -> SiLU -> conv3, RMS -> SiLU -> conv3, + shortcut."""
    r = p.residual
    h = x if isinstance(p.shortcut, nn.Identity) else _conv3d(
        x, p.shortcut, padding="valid_t")
    y = F.silu(_rms_norm_channel(x, r[0].gamma))
    y = _causal_conv_step(r[2], y, io)
    y = F.silu(_rms_norm_channel(y, r[3].gamma))
    y = _causal_conv_step(r[6], y, io)
    return y + h


def _upsample3d_time(conv: nn.Conv3d, x, io: _CacheIO, first: bool):
    """Channel-doubling causal time conv + frame interleave (vae.py:79-140).
    Frame 0 passes through with no time conv ('Rep') and zero history."""
    b, c, t, h, w = x.shape

    def conv_interleave(xin):    # [B, C, T', H, W] -> [B, C, 2(T'-2), H, W]
        y = _conv3d(xin, conv, padding="valid_t")            # [B, 2C, t, ..]
        ty = y.shape[2]
        y = y.reshape(b, 2, c, ty, h, w).permute(0, 2, 3, 1, 4, 5)
        return y.reshape(b, c, ty * 2, h, w)

    if not io.streaming:
        head = x[:, :, :1]
        if t == 1:
            return head
        tail_in = F.pad(x[:, :, 1:], (0, 0, 0, 0, 2, 0))
        return torch.cat([head, conv_interleave(tail_in)], dim=2)
    cache = io.next()
    if first:
        io.put(x.new_zeros((b, c, 2, h, w)))
        return x
    xin = torch.cat([cache.to(x.dtype), x], dim=2)
    io.put(xin[:, :, -2:])
    return conv_interleave(xin)


def _resample(p: Resample, x, io: _CacheIO, first: bool):
    if p.mode == "upsample3d":
        x = _upsample3d_time(p.time_conv, x, io, first)
    x = F.interpolate(x, scale_factor=(1, 2, 2), mode="nearest")
    return _conv2d_frames(x, p.resample[1])


def _run_stack(vae: WanVAEDecoder, spec, x, io: _CacheIO, first: bool):
    d = vae.decoder
    layers = [None] + list(d.middle) + list(d.upsamples) + [None]
    for item, layer in zip(spec, layers):
        kind = item[0]
        if kind == "conv_in":
            x = _causal_conv_step(d.conv1, x, io)
        elif kind == "res":
            x = _residual_block(layer, x, io)
        elif kind == "attn":
            x = _spatial_attention(layer, x)
        elif kind == "resample":
            x = _resample(layer, x, io, first)
        elif kind == "head":
            x = F.silu(_rms_norm_channel(x, d.head[0].gamma))
            x = _causal_conv_step(d.head[2], x, io)
    return x


def vae_decode(vae: WanVAEDecoder, z: torch.Tensor, streaming: bool = True,
               clamp: bool = True) -> torch.Tensor:
    """Normalised latent [B, z, Tz, h, w] -> video [B, 3, 1+4(Tz-1), 8h, 8w]
    (reference decode, vae.py:544-566)."""
    cfg = vae.cfg
    spec = decoder_spec(cfg)
    dev = vae.conv2.weight.device
    mean = torch.tensor(cfg.latent_mean, dtype=torch.float32, device=dev)
    std = torch.tensor(cfg.latent_std, dtype=torch.float32, device=dev)
    zt = (z.float() * std.view(1, -1, 1, 1, 1)
          + mean.view(1, -1, 1, 1, 1)).to(z.dtype)
    x = _conv3d(zt, vae.conv2, padding="valid_t")
    tz = x.shape[2]

    if not streaming:
        out = _run_stack(vae, spec, x, _CacheIO(None), first=False)
    else:
        io = _CacheIO([])
        outs = [_run_stack(vae, spec, x[:, :, :1], io, first=True)]
        for i in range(1, tz):
            io = _CacheIO(io.out)
            outs.append(_run_stack(vae, spec, x[:, :, i:i + 1], io,
                                   first=False))
        out = torch.cat(outs, dim=2)
    if clamp:
        out = torch.clamp(out, -1.0, 1.0)
    return out
