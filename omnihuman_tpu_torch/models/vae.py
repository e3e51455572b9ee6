"""Wan 2.1 3D causal video VAE, encoder and decoder (port of
omnihuman_tpu/models/vae.py).

The reference WanVAE_ (wan/modules/vae.py): causal 3x3x3 convs, RMS channel
norms, single-head per-frame spatial attention in the middle blocks; the
encoder downsamples twice in time (stride-2 time conv, frame 0 passed
through) and thrice in space (corner-padded stride-2 conv), the decoder
upsamples twice in time (channel-doubling time conv + frame interleave,
frame 0 passed through) and thrice in space; the latent is normalised by
per-channel statistics. Module names follow the reference (`encoder.*`,
`conv1`, `decoder.*`, `conv2`), so a Wan2.1_VAE.pth state dict loads with
`load_state_dict`.

Two ways to run either direction, with the same outputs (JAX vae_encode /
vae_decode):
  streaming=False: one causal-conv graph over the whole clip;
  streaming=True:  the first frame (latent frame), then 4 frames (one
                   latent frame) per step with conv caches: bounded memory.

`conv_impl` chooses how a streaming pass runs each residual-block conv and
each decoder upsample (JAX `conv_impl`; `streaming=False` ignores it):
  "torch": torch convs (cuDNN on the card), the counterpart of JAX "xla";
  "cuda":  the hand-written Hopper kernels K3 / K4 (ops/vae_kernels.py),
           the counterpart of "pallas"; raises off CUDA;
  "plain": the same fused structure through the kernels' plain versions,
           the counterpart of "pallas_interpret";
  "auto":  "cuda" where K3 / K4 take the whole pass (`auto_conv_impl`:
           CUDA, bf16 weights, every fused conv within the kernels' channel
           rule), else "torch" (the JAX "auto" is XLA everywhere).
The fused paths run in torch.channels_last_3d memory (the logical layout
stays [B, C, T, H, W]): the kernels take channels-last tensors and every
op between them keeps that format; the kernels refuse anything else.

The RGB head is a plain causal conv (the JAX `_head_conv_blocked` is a TPU
lane-fill rewrite of the same function).

`spatial` shards W over a group (JAX `spatial_sharding`, which GSPMD
partitions): every rank runs `vae_decode_shard` / `vae_encode_shard` on
its `shard_bounds` columns and fetches halos itself (parallel/spatial.py).
A 3x3 conv (the causal convs, each K3 call, the head) reads 1 column of
each neighbour, a K4 upsample 1 low-res column (its output loses 2
high-res columns on each side), the encoder's corner downsample 1 column
on the right; 1x1x1 convs and the time-only convs are local. A K3 call
takes the raw halo and activates it itself (a zero column at the image's
edge activates to zero, SAME's padding) and keeps its cache at the
extended width, so the next chunk reads the neighbours' activated
history. The mid-block attention keeps its queries and gathers K and V
over the group. The kernels see only fresh halo-extended buffers in
channels_last_3d memory; their cropped outputs go to torch ops or to the
next exchange, which copies. JAX refuses Pallas under `spatial_sharding`;
here `conv_impl` keeps its meaning.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from omnihuman_tpu_torch.configs.wan import VAEConfig
from omnihuman_tpu_torch.ops import vae_kernels
from omnihuman_tpu_torch.parallel.spatial import (
    VirtualRanks, gather_spatial, group_rank, group_size, halo_exchange,
    shard_bounds)

CONV_IMPLS = ("auto", "torch", "cuda", "plain")

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
    """Up: nearest 2x + 3x3 conv halving the channels; down: corner pad +
    stride-2 3x3 conv; the 3d modes add a time conv (vae.py:66-162)."""

    def __init__(self, dim: int, mode: str):
        super().__init__()
        self.mode = mode
        cout = dim // 2 if mode.startswith("upsample") else dim
        self.resample = nn.Sequential(nn.Identity(), nn.Conv2d(dim, cout, 3))
        if mode == "upsample3d":
            self.time_conv = _causal_conv(dim, dim * 2, (3, 1, 1))
        elif mode == "downsample3d":
            self.time_conv = _causal_conv(dim, dim, (3, 1, 1))


def encoder_spec(cfg: VAEConfig) -> List[Tuple]:
    """Static layer list of the encoder (JAX encoder_spec)."""
    dims = [cfg.base_dim * u for u in (1,) + tuple(cfg.dim_mult)]
    spec: List[Tuple] = [("conv_in", 3, dims[0])]
    scale = 1.0
    for i, (din, dout) in enumerate(zip(dims[:-1], dims[1:])):
        for _ in range(cfg.num_res_blocks):
            spec.append(("res", din, dout))
            if scale in cfg.attn_scales:
                spec.append(("attn", dout))
            din = dout
        if i != len(cfg.dim_mult) - 1:
            mode = ("downsample3d" if cfg.temporal_downsample[i]
                    else "downsample2d")
            spec.append(("resample", dout, mode))
            scale /= 2.0
    out = dims[-1]
    spec += [("res", out, out), ("attn", out), ("res", out, out),
             ("head", out, cfg.z_dim * 2)]
    return spec


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


def _head(cin: int, cout: int) -> nn.Sequential:
    return nn.Sequential(RMS_norm(cin), nn.SiLU(), _causal_conv(cin, cout))


class Encoder3d(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        spec = encoder_spec(cfg)
        self.conv1 = _causal_conv(spec[0][1], spec[0][2])
        self.downsamples = nn.Sequential(
            *[_make_layer(it) for it in spec[1:-4]])
        self.middle = nn.Sequential(*[_make_layer(it) for it in spec[-4:-1]])
        self.head = _head(spec[-1][1], spec[-1][2])

    def layers(self) -> List[nn.Module]:
        """One module per encoder_spec entry."""
        return ([self.conv1] + list(self.downsamples) + list(self.middle)
                + [self.head])


class Decoder3d(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        spec = decoder_spec(cfg)
        self.conv1 = _causal_conv(spec[0][1], spec[0][2])
        self.middle = nn.Sequential(*[_make_layer(it) for it in spec[1:4]])
        self.upsamples = nn.Sequential(
            *[_make_layer(it) for it in spec[4:-1]])
        self.head = _head(spec[-1][1], spec[-1][2])

    def layers(self) -> List[nn.Module]:
        """One module per decoder_spec entry."""
        return ([self.conv1] + list(self.middle) + list(self.upsamples)
                + [self.head])


class WanVAE(nn.Module):
    """The reference WanVAE_: `encoder`, the 1x1x1 latent convs `conv1`
    (after the encoder) and `conv2` (before the decoder), `decoder`."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder3d(cfg)
        self.conv1 = _causal_conv(cfg.z_dim * 2, cfg.z_dim * 2, (1, 1, 1))
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


def build_vae(cfg: VAEConfig, device, dtype: torch.dtype,
              seed: Optional[int] = 0) -> WanVAE:
    with torch.device("meta"):
        vae = WanVAE(cfg)
    vae = vae.to(dtype).to_empty(device=device)
    if seed is not None:
        vae.init_weights(torch.Generator(device=device).manual_seed(seed))
    return vae.eval().requires_grad_(False)


# ---------------------------------------------------------------------------
# primitive layers (x: [B, C, T, H, W])


def _conv3d(x, conv: nn.Conv3d, padding: str = "causal", stride=1,
            halo_w: bool = False):
    """padding='causal': zero-pad kt-1 frames at the front, SAME on h/w;
    'valid_t': no time padding (the caller supplies history). The odd
    spatial kernels pad symmetrically inside the conv, which keeps x's
    memory format. halo_w: x carries its (kw-1)/2 halo columns on each
    side already, so W is not padded (a W shard, `_halo_w`)."""
    w, b = conv.weight, conv.bias
    kt, kh, kw = w.shape[2:]
    x = x.to(w.dtype)
    if padding == "causal" and kt > 1:
        x = F.pad(x, (0, 0, 0, 0, kt - 1, 0))
    pad = (0, (kh - 1) // 2, 0 if halo_w else (kw - 1) // 2)
    if b.dtype == w.dtype:
        return F.conv3d(x, w, b, stride=stride, padding=pad)
    return (F.conv3d(x, w, stride=stride, padding=pad)
            + b.view(1, -1, 1, 1, 1))             # JAX promotes here


def _conv2d_frames(x, conv: nn.Conv2d, stride=1, padding="same",
                   halo_w: bool = False):
    """Per-frame conv2d on [B, C, T, H, W] (a 1 x kh x kw conv3d).
    padding='corner': zero row / column at the bottom / right, then VALID
    (the reference's downsample ZeroPad2d((0, 1, 0, 1))); with halo_w, x
    brings its right column (the neighbour's first, or the zero one at the
    image's edge) itself."""
    w, b = conv.weight, conv.bias
    kh, kw = w.shape[2:]
    x = x.to(w.dtype)
    if padding == "corner":
        x = F.pad(x, (0, 0 if halo_w else 1, 0, 1))
        pad = 0
    else:
        pad = (0, (kh - 1) // 2, (kw - 1) // 2)
    w3 = w.unsqueeze(2)
    st = (1, stride, stride)
    if b.dtype == w.dtype:
        return F.conv3d(x, w3, b, stride=st, padding=pad)
    return F.conv3d(x, w3, stride=st, padding=pad) + b.view(1, -1, 1, 1, 1)


def _rms_norm_channel(x, gamma):
    """F.normalize over channels * sqrt(C) * gamma, fp32 statistics
    (reference RMS_norm, vae.py:39-54)."""
    xf = x.float()
    norm = torch.sqrt(xf.square().sum(dim=1, keepdim=True))
    c = x.shape[1]
    y = xf / torch.clamp(norm, min=1e-12) * math.sqrt(c)
    y = y * gamma.float().reshape(1, c, 1, 1, 1)
    return y.to(x.dtype)


def _spatial_attention(p: AttentionBlock, x, sp=None):
    """Single-head per-frame self-attention (vae.py:223-263), plain torch.
    On a W shard (`sp`) the queries stay local and K and V are gathered
    over the group: every query attends over the whole frame, keys in the
    unsharded (row, column) order."""
    b, c, t, h, w = x.shape
    idn = x
    xf = _rms_norm_channel(x, p.norm.gamma)
    xf = xf.permute(0, 2, 3, 4, 1).reshape(b * t, h * w, c)
    wq, bq = p.to_qkv.weight[:, :, 0, 0], p.to_qkv.bias
    qkv = xf.to(wq.dtype) @ wq.t() + bq
    q, k, v = qkv.chunk(3, dim=-1)
    if sp is not None:
        k, v = (gather_spatial(z.reshape(b * t, h, w, c), 2, sp.group,
                               sp.sizes(w)).reshape(b * t, -1, c)
                for z in (k, v))
    logits = torch.matmul(q.float(), k.float().transpose(1, 2)) * (c ** -0.5)
    attn = torch.softmax(logits, dim=-1).to(v.dtype)
    y = torch.matmul(attn.float(), v.float()).to(v.dtype)
    wp, bp = p.proj.weight[:, :, 0, 0], p.proj.bias
    dt = torch.promote_types(y.dtype, wp.dtype)
    y = y.to(dt) @ wp.to(dt).t() + bp
    y = y.reshape(b, t, h, w, c).permute(0, 4, 1, 2, 3)
    return idn + y.to(x.dtype)


def _channels_last(x) -> bool:
    """Channels innermost in memory, as in channels_last_3d; true also of
    a time slice of such a tensor (a streaming chunk or cache)."""
    return x.stride(1) == 1 and x.shape[1] > 1


def _zero_frames(x, frames: int):
    """Zero history [B, C, frames, H, W] in x's dtype and memory format."""
    b, c, _, h, w = x.shape
    fmt = (torch.channels_last_3d if _channels_last(x)
           else torch.contiguous_format)
    return torch.empty((b, c, frames, h, w), dtype=x.dtype, device=x.device,
                       memory_format=fmt).zero_()


def _interleave_time(y, c: int):
    """[B, 2C, t, H, W] -> [B, C, 2t, H, W]: channel group g of frame i
    becomes frame 2i + g (vae.py:120-126). A channels-last input stays
    channels-last."""
    b, _, t, h, w = y.shape
    if _channels_last(y):
        z = y.permute(0, 2, 3, 4, 1).reshape(b, t, h, w, 2, c)
        z = z.permute(0, 1, 4, 2, 3, 5).contiguous().view(b, 2 * t, h, w, c)
        return z.permute(0, 4, 1, 2, 3)
    y = y.reshape(b, 2, c, t, h, w).permute(0, 2, 3, 1, 4, 5)
    return y.reshape(b, c, 2 * t, h, w)


@dataclasses.dataclass(frozen=True)
class WShard:
    """One rank's place in a W-sharded pass: the `group` the ranks exchange
    halos over (`parallel/spatial.py`) and every rank's number of latent
    columns, in rank order (`shard_bounds`)."""

    group: object
    widths: Tuple[int, ...]

    def sizes(self, w: int) -> List[int]:
        """Every rank's columns at a level where this rank has `w` (the
        pixel levels are 2x, 4x, 8x the latent one)."""
        own = self.widths[group_rank(self.group)]
        return [x * w // own for x in self.widths]


def _halo_w(x, sp: WShard, lo: int = 1, hi: int = 1):
    """x with its W halo from the neighbouring shards (zeros at the image's
    edges) in a fresh buffer of x's memory format: the input of a 3x3 conv
    of a W shard."""
    return halo_exchange(x, 4, lo, hi, sp.group)


def _crop_w(x, n: int):
    """The inner columns of an output computed on a halo-extended input."""
    return x[..., n:x.shape[-1] - n]


# ---------------------------------------------------------------------------
# cache plumbing


class _CacheIO:
    """Cursor over the ordered per-conv cache list of a streaming pass.

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


def _causal_conv_step(conv: nn.Conv3d, x, io: _CacheIO, sp=None):
    """CausalConv3d with the optional streaming cache (vae.py:17-35). On a
    W shard (`sp`) the 3x3 conv reads x with its halo and the cache keeps
    the halo-extended width."""
    kt, kw = conv.weight.shape[2], conv.weight.shape[4]
    if kt == 1:
        return _conv3d(x, conv, padding="valid_t")
    halo = sp is not None and kw > 1
    if halo:
        x = _halo_w(x, sp)
    if not io.streaming:
        return _conv3d(x, conv, padding="causal", halo_w=halo)
    cache = io.next()
    if cache is None:
        cache = _zero_frames(x, kt - 1)
    xin = torch.cat([cache.to(x.dtype), x], dim=2)
    io.put(xin[:, :, -(kt - 1):])
    return _conv3d(xin, conv, padding="valid_t", halo_w=halo)


def _fused_convs(layers: List[nn.Module]):
    """The convs a fused pass runs through K3 / K4: (norm, conv) of each
    residual-block conv, then (None, conv) of each decoder upsample."""
    for layer in layers:
        if isinstance(layer, ResidualBlock):
            r = layer.residual
            yield r[0], r[2]
            yield r[3], r[6]
        elif isinstance(layer, Resample) and \
                layer.mode.startswith("upsample"):
            yield None, layer.resample[1]


def auto_conv_impl(layers: List[nn.Module], dtype: torch.dtype,
                   device) -> str:
    """What conv_impl="auto" picks for a streaming pass over `layers` whose
    weights (the compute dtype: `_conv3d` casts to it) are `dtype`, on
    `device`: "cuda" only where K3 / K4 take every fused conv of the pass
    (a CUDA device, bf16, the kernels' channel rule), else "torch"."""
    if torch.device(device).type != "cuda" or dtype != torch.bfloat16:
        return "torch"
    if all(vae_kernels.kernel_takes_channels(conv.in_channels,
                                             conv.out_channels)
           for _, conv in _fused_convs(layers)):
        return "cuda"
    return "torch"


class _Fused:
    """The fused-kernel path of one streaming pass: the kernel functions
    ("cuda": K3 / K4 on CUDA tensors; "plain": their plain versions) and
    the weights packed once per pass, as JAX `_optimize_decoder_params`
    packs them outside its scan."""

    def __init__(self, impl: str, layers: List[nn.Module]):
        if impl == "cuda":
            self.conv = vae_kernels.fused_act_causal_conv3d
            self.up = vae_kernels.fused_upsample_conv2d
        else:
            self.conv = vae_kernels.fused_act_causal_conv3d_plain
            self.up = vae_kernels.fused_upsample_conv2d_plain
        self.packs: Dict[nn.Module, Tuple] = {}
        for norm, conv in _fused_convs(layers):
            if norm is not None:
                w2 = vae_kernels.pack_conv_weights(
                    conv.weight.permute(2, 3, 4, 1, 0))
                self.packs[conv] = (
                    w2, norm.gamma.float().reshape(-1).contiguous(),
                    conv.bias.float().contiguous(),
                    # K3's K-major copy (the plain version reads w2)
                    vae_kernels.conv_weights_kmajor(w2)
                    if impl == "cuda" else None)
            else:
                w4 = vae_kernels.pack_upsample_weights(
                    conv.weight.permute(2, 3, 1, 0))
                self.packs[conv] = (
                    w4, conv.bias.float().contiguous(),
                    # K4's K-major copy (the plain version reads w4)
                    vae_kernels.upsample_weights_kmajor(w4)
                    if impl == "cuda" else None)


def _residual_block(p: ResidualBlock, x, io: _CacheIO,
                    fused: Optional[_Fused], sp=None):
    """RMS -> SiLU -> conv3, RMS -> SiLU -> conv3, + shortcut. Fused: each
    norm -> SiLU -> causal conv is one K3 call that also returns the new
    cache; the identity skip rides in conv2's epilogue (vae.py:186-221).

    On a W shard (`sp`) each K3 call takes the raw input with its 1-column
    halo and activates the halo itself (a zero column at the image's edge
    activates to zero, SAME's padding); its output's outer columns are
    cropped and its cache keeps the extended width, so the next chunk
    reads the neighbours' activated history."""
    r = p.residual
    identity = isinstance(p.shortcut, nn.Identity)
    h = x if identity else _conv3d(x, p.shortcut, padding="valid_t")
    if fused is not None and io.streaming:
        xe = _halo_w(x, sp) if sp is not None else x
        y = xe
        for i, (norm, conv) in enumerate(((r[0], r[2]), (r[3], r[6]))):
            if sp is not None and i == 1:
                y = _halo_w(_crop_w(y, 1), sp)
            cache = io.next()
            if cache is None:
                cache = _zero_frames(y, 2)
            w2, gamma, bias, wk = fused.packs[conv]
            res = xe if identity and i == 1 else None
            kw = {} if wk is None else {"wk": wk}
            y, cnew = fused.conv(y, cache, gamma, w2, bias, residual=res,
                                 **kw)
            io.put(cnew.to(x.dtype))
        if sp is not None:
            y = _crop_w(y, 1)
        return y if identity else y + h
    y = F.silu(_rms_norm_channel(x, r[0].gamma))
    y = _causal_conv_step(r[2], y, io, sp)
    y = F.silu(_rms_norm_channel(y, r[3].gamma))
    y = _causal_conv_step(r[6], y, io, sp)
    return y + h


def _upsample3d_time(conv: nn.Conv3d, x, io: _CacheIO, first: bool):
    """Channel-doubling causal time conv + frame interleave (vae.py:79-140).
    Frame 0 passes through with no time conv ('Rep') and zero history."""
    c = x.shape[1]
    if not io.streaming:
        head = x[:, :, :1]
        if x.shape[2] == 1:
            return head
        tail_in = F.pad(x[:, :, 1:], (0, 0, 0, 0, 2, 0))
        tail = _interleave_time(_conv3d(tail_in, conv, padding="valid_t"), c)
        return torch.cat([head, tail], dim=2)
    cache = io.next()
    if first:
        io.put(_zero_frames(x, 2))
        return x
    xin = torch.cat([cache.to(x.dtype), x], dim=2)
    io.put(xin[:, :, -2:])
    return _interleave_time(_conv3d(xin, conv, padding="valid_t"), c)


def _downsample3d_time(conv: nn.Conv3d, x, io: _CacheIO, first: bool):
    """Stride-2 time conv of the encoder (vae.py:91-96,146-161); frame 0
    (the first chunk) passes through and is kept as the 1-frame cache."""
    if not io.streaming:
        tail = _conv3d(x, conv, padding="valid_t", stride=(2, 1, 1))
        return torch.cat([x[:, :, :1], tail], dim=2)
    cache = io.next()
    io.put(x[:, :, -1:])
    if first:
        return x
    xin = torch.cat([cache.to(x.dtype), x], dim=2)
    return _conv3d(xin, conv, padding="valid_t", stride=(2, 1, 1))


def _resample(p: Resample, x, io: _CacheIO, first: bool,
              fused: Optional[_Fused], sp=None):
    """The time convs are local to a W shard; the upsample conv (K4 or
    nearest + conv) reads 1 low-res halo column on each side and its
    output loses 2 high-res columns on each side; the corner downsample
    reads 1 column on the right."""
    if p.mode == "upsample3d":
        x = _upsample3d_time(p.time_conv, x, io, first)
    conv = p.resample[1]
    if p.mode.startswith("upsample"):
        if sp is not None:
            x = _halo_w(x, sp)
        if fused is not None:
            w4, bias, wk = fused.packs[conv]
            kw = {} if wk is None else {"wk": wk}
            y = fused.up(x, w4, bias, **kw)
        else:
            x = F.interpolate(x, scale_factor=(1, 2, 2), mode="nearest")
            y = _conv2d_frames(x, conv)
        return y if sp is None else _crop_w(y, 2)
    if sp is not None:
        x = _halo_w(x, sp, lo=0, hi=1)
    x = _conv2d_frames(x, conv, stride=2, padding="corner",
                       halo_w=sp is not None)
    if p.mode == "downsample3d":
        x = _downsample3d_time(p.time_conv, x, io, first)
    return x


def _run_stack(spec, layers, x, io: _CacheIO, first: bool,
               fused: Optional[_Fused], sp=None):
    for item, layer in zip(spec, layers):
        kind = item[0]
        if kind == "conv_in":
            x = _causal_conv_step(layer, x, io, sp)
        elif kind == "res":
            x = _residual_block(layer, x, io, fused, sp)
        elif kind == "attn":
            x = _spatial_attention(layer, x, sp)
        elif kind == "resample":
            x = _resample(layer, x, io, first, fused, sp)
        elif kind == "head":
            x = F.silu(_rms_norm_channel(x, layer[0].gamma))
            x = _causal_conv_step(layer[2], x, io, sp)
    return x


def _resolve(conv_impl: str, streaming: bool, x: torch.Tensor, layers,
             dtype: torch.dtype):
    """The _Fused plan of a pass with weights of `dtype`, or None for the
    torch-conv path."""
    if conv_impl not in CONV_IMPLS:
        raise ValueError(f"unknown conv_impl {conv_impl!r}; expected one of "
                         f"{CONV_IMPLS}")
    if conv_impl == "auto":
        conv_impl = auto_conv_impl(layers, dtype, x.device)
    if not streaming or conv_impl == "torch":
        return None
    if conv_impl == "cuda" and not x.is_cuda:
        raise ValueError(f"conv_impl='cuda' needs a CUDA tensor, got "
                         f"{x.device}")
    return _Fused(conv_impl, layers)


def _stream(spec, layers, x, fused, chunk: int, sp=None):
    """First frame, then `chunk` frames per step, caches carried over."""
    b, c, t, h, w = x.shape
    if fused is not None and x.stride() != (c * t * h * w, 1, h * w * c,
                                            w * c, c):
        # fresh channels-last storage: .contiguous() keeps the stride of a
        # size-1 dim (an HWC image viewed as [1, 3, 1, H, W]), which later
        # ops read as contiguous, and the kernels then refuse the layout
        x = torch.empty_like(x, memory_format=torch.channels_last_3d
                             ).copy_(x)
    io = _CacheIO([])
    outs = [_run_stack(spec, layers, x[:, :, :1], io, True, fused, sp)]
    for i in range(1, x.shape[2], chunk):
        io = _CacheIO(io.out)
        outs.append(_run_stack(spec, layers, x[:, :, i:i + chunk], io, False,
                               fused, sp))
    return torch.cat(outs, dim=2)


def _latent_stats(cfg: VAEConfig, device):
    mean = torch.tensor(cfg.latent_mean, dtype=torch.float32, device=device)
    std = torch.tensor(cfg.latent_std, dtype=torch.float32, device=device)
    return mean.view(1, -1, 1, 1, 1), std.view(1, -1, 1, 1, 1)


def vae_encode(vae: WanVAE, video: torch.Tensor, streaming: bool = True,
               conv_impl: str = "auto", spatial=None) -> torch.Tensor:
    """[B, 3, T, H, W] (T = 1 + 4k) -> normalised latent mean
    [B, z, 1 + k, H/8, W/8] in video's dtype (reference encode,
    vae.py:515-541). `spatial`: the group W is sharded over (JAX
    `spatial_sharding`; `vae_decode`)."""
    if spatial is not None:
        return _sharded(vae_encode_shard, vae, video, spatial, 8, 1,
                        streaming=streaming, conv_impl=conv_impl)
    return vae_encode_shard(vae, video, None, streaming, conv_impl)


def vae_encode_shard(vae: WanVAE, video: torch.Tensor, sp: Optional[WShard],
                     streaming: bool = True,
                     conv_impl: str = "auto") -> torch.Tensor:
    """One rank's encode of its W shard of the video (8 pixel columns per
    latent column of `sp.widths`), halos fetched over `sp.group`; its
    shard of the latent. `sp` None: the whole video."""
    spec, layers = encoder_spec(vae.cfg), vae.encoder.layers()
    fused = _resolve(conv_impl, streaming, video, layers,
                     vae.conv1.weight.dtype)
    if streaming:
        out = _stream(spec, layers, video, fused, chunk=4, sp=sp)
    else:
        out = _run_stack(spec, layers, video, _CacheIO(None), False, None, sp)
    out = _conv3d(out, vae.conv1, padding="valid_t")
    mu = out[:, :vae.cfg.z_dim]
    mean, std = _latent_stats(vae.cfg, video.device)
    return ((mu.float() - mean) / std).to(video.dtype)


def vae_decode(vae: WanVAE, z: torch.Tensor, streaming: bool = True,
               clamp: bool = True, conv_impl: str = "auto",
               spatial=None) -> torch.Tensor:
    """Normalised latent [B, z, Tz, h, w] -> video [B, 3, 1+4(Tz-1), 8h, 8w]
    (reference decode, vae.py:544-566).

    `spatial` (JAX `spatial_sharding`): a process group or 1-D DeviceMesh
    to shard W over, or a `VirtualRanks`. Every rank passes the whole
    latent, decodes its `shard_bounds` columns (`vae_decode_shard`: the
    same kernels as one card, on halo-extended shards) and gets the whole
    video back (an all-gather; the video of virtual ranks is their shards
    side by side). JAX refuses its Pallas kernels under
    `spatial_sharding`; the port shards by hand and keeps `conv_impl`."""
    if spatial is not None:
        return _sharded(vae_decode_shard, vae, z, spatial, 1, 8,
                        streaming=streaming, clamp=clamp, conv_impl=conv_impl)
    return vae_decode_shard(vae, z, None, streaming, clamp, conv_impl)


def vae_decode_shard(vae: WanVAE, z: torch.Tensor, sp: Optional[WShard],
                     streaming: bool = True, clamp: bool = True,
                     conv_impl: str = "auto") -> torch.Tensor:
    """One rank's decode of its W shard of the latent, halos fetched over
    `sp.group`; its shard of the video (8 columns per latent column).
    `sp` None: the whole latent."""
    spec, layers = decoder_spec(vae.cfg), vae.decoder.layers()
    fused = _resolve(conv_impl, streaming, z, layers,
                     vae.conv2.weight.dtype)
    mean, std = _latent_stats(vae.cfg, z.device)
    zt = (z.float() * std + mean).to(z.dtype)
    x = _conv3d(zt, vae.conv2, padding="valid_t")
    if streaming:
        out = _stream(spec, layers, x, fused, chunk=1, sp=sp)
    else:
        out = _run_stack(spec, layers, x, _CacheIO(None), False, None, sp)
    if clamp:
        out = torch.clamp(out, -1.0, 1.0)
    return out


def shard_inputs(x: torch.Tensor, parts: int, per_latent: int):
    """(every rank's latent column count, every rank's W shard of x), x
    with `per_latent` columns per latent column."""
    if x.shape[-1] % per_latent:
        raise ValueError(f"width {x.shape[-1]} is not a multiple of "
                         f"{per_latent}")
    bounds = shard_bounds(x.shape[-1] // per_latent, parts)
    widths = tuple(e - s for s, e in bounds)
    return widths, [x[..., s * per_latent:e * per_latent] for s, e in bounds]


def _sharded(program, vae, x, spatial, per_latent_in: int,
             per_latent_out: int, **kw):
    """`program` (a per-rank decode / encode) over the W shards of the
    whole input x: on virtual ranks all at once, their outputs side by
    side; on a process group this rank's, all-gathered."""
    if isinstance(spatial, VirtualRanks):
        widths, shards = shard_inputs(x, spatial.size, per_latent_in)
        outs = spatial.run(
            lambda g, xs: program(vae, xs, WShard(g, widths), **kw),
            [(xs,) for xs in shards])
        return torch.cat(outs, dim=-1)
    n, r = group_size(spatial), group_rank(spatial)
    widths, shards = shard_inputs(x, n, per_latent_in)
    out = program(vae, shards[r], WShard(spatial, widths), **kw)
    return gather_spatial(out, 4, spatial,
                          [w * per_latent_out for w in widths])
