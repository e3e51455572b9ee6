"""Wav2Vec2 audio encoder (port of omnihuman_tpu/omni/wav2vec.py).

The HF `Wav2Vec2Model` graph at eval (no masking, no dropout,
`last_hidden_state`) with HF parameter names, so a released checkpoint
loads with `load_state_dict` and the JAX converter
`omnihuman_tpu.omni.wav2vec.convert_wav2vec` reads a port state dict
unchanged:
  feature encoder: strided Conv1d stack, GroupNorm(C, C) after the first
  conv ("group", base) or a LayerNorm after every conv ("layer", large),
  exact GELU; feature projection (LayerNorm, Linear); a grouped,
  weight-normed positional conv (`weight_g` [1, 1, K], `weight_v`, the
  norm over all but the kernel axis, floored at 1e-12 as in JAX) with
  GELU; post-LN (base) or pre-LN (large, `do_stable_layer_norm`)
  transformer blocks with dense fp32 attention.

`Wav2Vec2AudioFeatures` turns a waveform into per-video-frame features
[num_frames, dim] like the JAX class (`:370`): linear resampling to 16
kHz, zero-mean unit-variance normalisation, mean over each frame's
tokens, tiled / truncated to `dim`. It runs on the card unless given
`device="cpu"`.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


@dataclass(frozen=True)
class Wav2Vec2Config:
    conv_dim: Tuple[int, ...] = (512,) * 7
    conv_stride: Tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    conv_kernel: Tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_bias: bool = False
    feat_extract_norm: str = "group"      # "group" (base) | "layer" (large)
    hidden: int = 768
    layers: int = 12
    heads: int = 12
    ffn: int = 3072
    do_stable_layer_norm: bool = False    # False: post-LN (base)
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    ln_eps: float = 1e-5

    @property
    def stride_total(self) -> int:
        return math.prod(self.conv_stride)

    def num_tokens(self, num_samples: int) -> int:
        t = num_samples
        for k, s in zip(self.conv_kernel, self.conv_stride):
            t = (t - k) // s + 1
        return t


WAV2VEC2_PRESETS = {
    "base": Wav2Vec2Config(),
    "large": Wav2Vec2Config(hidden=1024, layers=24, heads=16, ffn=4096,
                            feat_extract_norm="layer", conv_bias=True,
                            do_stable_layer_norm=True),
    "tiny-test": Wav2Vec2Config(conv_dim=(32, 32),
                                conv_stride=(5, 2), conv_kernel=(10, 3),
                                hidden=32, layers=2, heads=2, ffn=64,
                                num_conv_pos_embeddings=16,
                                num_conv_pos_embedding_groups=2),
    "tiny-test-stable": Wav2Vec2Config(conv_dim=(32, 32),
                                       conv_stride=(5, 2),
                                       conv_kernel=(10, 3), conv_bias=True,
                                       feat_extract_norm="layer",
                                       hidden=32, layers=2, heads=2, ffn=64,
                                       num_conv_pos_embeddings=16,
                                       num_conv_pos_embedding_groups=2,
                                       do_stable_layer_norm=True),
}

SAMPLE_RATE = 16000


# ---------------------------------------------------------------------------
# modules (HF names)


class ConvLayer(nn.Module):
    def __init__(self, cin: int, cout: int, k: int, stride: int,
                 bias: bool, norm: Optional[str]):
        super().__init__()
        self.conv = nn.Conv1d(cin, cout, k, stride=stride, bias=bias)
        if norm == "group":
            self.layer_norm = nn.GroupNorm(cout, cout, affine=True)
        elif norm == "layer":
            self.layer_norm = nn.LayerNorm(cout)


class FeatureEncoder(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        layers, cin = [], 1
        for i, (cout, k, s) in enumerate(zip(cfg.conv_dim, cfg.conv_kernel,
                                             cfg.conv_stride)):
            norm = ("layer" if cfg.feat_extract_norm == "layer" else
                    "group" if i == 0 else None)
            layers.append(ConvLayer(cin, cout, k, s, cfg.conv_bias, norm))
            cin = cout
        self.conv_layers = nn.ModuleList(layers)


class FeatureProjection(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.layer_norm = nn.LayerNorm(cfg.conv_dim[-1], eps=cfg.ln_eps)
        self.projection = nn.Linear(cfg.conv_dim[-1], cfg.hidden)


class WeightNormConv1d(nn.Module):
    """HF's weight-normed positional conv (torch weight_norm, dim=2)."""

    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        k, g = cfg.num_conv_pos_embeddings, cfg.num_conv_pos_embedding_groups
        self.groups = g
        self.weight_g = nn.Parameter(torch.ones(1, 1, k))
        self.weight_v = nn.Parameter(torch.zeros(cfg.hidden,
                                                 cfg.hidden // g, k))
        self.bias = nn.Parameter(torch.zeros(cfg.hidden))

    def weight(self) -> torch.Tensor:
        v = self.weight_v.float()
        norm = v.square().sum(dim=(0, 1), keepdim=True).sqrt()
        return self.weight_g.float() * v / torch.clamp(norm, min=1e-12)


class PositionalConvEmbedding(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.conv = WeightNormConv1d(cfg)


class Attention(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.q_proj = nn.Linear(dim, dim)
        self.k_proj = nn.Linear(dim, dim)
        self.v_proj = nn.Linear(dim, dim)
        self.out_proj = nn.Linear(dim, dim)


class FeedForward(nn.Module):
    def __init__(self, dim: int, ffn: int):
        super().__init__()
        self.intermediate_dense = nn.Linear(dim, ffn)
        self.output_dense = nn.Linear(ffn, dim)


class EncoderLayer(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.attention = Attention(cfg.hidden)
        self.layer_norm = nn.LayerNorm(cfg.hidden, eps=cfg.ln_eps)
        self.feed_forward = FeedForward(cfg.hidden, cfg.ffn)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden, eps=cfg.ln_eps)


class Encoder(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.pos_conv_embed = PositionalConvEmbedding(cfg)
        self.layer_norm = nn.LayerNorm(cfg.hidden, eps=cfg.ln_eps)
        self.layers = nn.ModuleList([EncoderLayer(cfg)
                                     for _ in range(cfg.layers)])


class Wav2Vec2Model(nn.Module):
    """The HF Wav2Vec2Model module tree (`masked_spec_embed` is kept so a
    released checkpoint loads strictly; eval never uses it)."""

    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.cfg = cfg
        self.feature_extractor = FeatureEncoder(cfg)
        self.feature_projection = FeatureProjection(cfg)
        self.encoder = Encoder(cfg)
        self.masked_spec_embed = nn.Parameter(torch.zeros(cfg.hidden))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Uniform(+-1/sqrt(fan_in)) linears and convs (the JAX init), unit
        norms, and weight_g set to the norm of weight_v."""
        def uni(t, fan_in):
            a = 1.0 / math.sqrt(fan_in)
            t.uniform_(-a, a, generator=generator)

        for m in self.modules():
            if isinstance(m, nn.Linear):
                uni(m.weight, m.in_features)
                uni(m.bias, m.in_features)
            elif isinstance(m, nn.Conv1d):
                uni(m.weight, m.in_channels * m.kernel_size[0])
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, (nn.LayerNorm, nn.GroupNorm)):
                m.weight.fill_(1.0)
                m.bias.zero_()
        pc = self.encoder.pos_conv_embed.conv
        k = pc.weight_v.shape[-1]
        uni(pc.weight_v, pc.weight_v.shape[1] * k)
        pc.weight_g.copy_(pc.weight_v.square().sum(dim=(0, 1), keepdim=True)
                          .sqrt())
        pc.bias.zero_()
        self.masked_spec_embed.uniform_(generator=generator)

    def forward(self, waveform: torch.Tensor) -> torch.Tensor:
        """[B, samples] float32 (normalised) -> [B, T, hidden] fp32."""
        cfg = self.cfg
        h = waveform.float()[:, None]                        # [B, 1, S]
        for i, layer in enumerate(self.feature_extractor.conv_layers):
            c = layer.conv
            h = F.conv1d(h, c.weight.float(),
                         None if c.bias is None else c.bias.float(),
                         stride=c.stride)
            if cfg.feat_extract_norm == "layer":
                h = _layer_norm(h.transpose(1, 2), layer.layer_norm,
                                cfg.ln_eps).transpose(1, 2)
            elif i == 0:       # GroupNorm(C, C): per-channel stats over time
                n = layer.layer_norm
                h = F.group_norm(h, h.shape[1], n.weight.float(),
                                 n.bias.float(), eps=1e-5)
            h = F.gelu(h)
        h = h.transpose(1, 2)                                # [B, T, C]
        fp = self.feature_projection
        h = _lin(fp.projection, _layer_norm(h, fp.layer_norm, cfg.ln_eps))

        pc = self.encoder.pos_conv_embed.conv
        e = F.conv1d(h.transpose(1, 2), pc.weight(), pc.bias.float(),
                     padding=cfg.num_conv_pos_embeddings // 2,
                     groups=pc.groups).transpose(1, 2)
        if cfg.num_conv_pos_embeddings % 2 == 0:
            e = e[:, :-1]
        h = h + F.gelu(e)
        enc = self.encoder
        if not cfg.do_stable_layer_norm:
            h = _layer_norm(h, enc.layer_norm, cfg.ln_eps)
        for blk in enc.layers:
            if cfg.do_stable_layer_norm:          # pre-LN (large)
                h = h + _attention(blk.attention,
                                   _layer_norm(h, blk.layer_norm, cfg.ln_eps),
                                   cfg.heads)
                hn = _layer_norm(h, blk.final_layer_norm, cfg.ln_eps)
                h = h + _ffn(blk.feed_forward, hn)
            else:                                 # post-LN (base)
                h = h + _attention(blk.attention, h, cfg.heads)
                h = _layer_norm(h, blk.layer_norm, cfg.ln_eps)
                h = h + _ffn(blk.feed_forward, h)
                h = _layer_norm(h, blk.final_layer_norm, cfg.ln_eps)
        if cfg.do_stable_layer_norm:
            h = _layer_norm(h, enc.layer_norm, cfg.ln_eps)
        return h


def _lin(lin: nn.Linear, x):
    return F.linear(x, lin.weight.float(), lin.bias.float())


def _layer_norm(x, ln: nn.LayerNorm, eps: float):
    return F.layer_norm(x, x.shape[-1:], ln.weight.float(), ln.bias.float(),
                        eps=eps)


def _ffn(ff: FeedForward, x):
    return _lin(ff.output_dense, F.gelu(_lin(ff.intermediate_dense, x)))


def _attention(p: Attention, x, heads: int):
    """Dense fp32 multi-head attention (JAX `_attention`)."""
    b, t, d = x.shape
    hd = d // heads
    q = _lin(p.q_proj, x) * (hd ** -0.5)
    k, v = _lin(p.k_proj, x), _lin(p.v_proj, x)
    q, k, v = (a.reshape(b, t, heads, hd).transpose(1, 2) for a in (q, k, v))
    a = torch.softmax(q @ k.transpose(-1, -2), dim=-1)
    o = (a @ v).transpose(1, 2).reshape(b, t, d)
    return _lin(p.out_proj, o)


def build_wav2vec(cfg: Wav2Vec2Config, device, seed: Optional[int] = 0
                  ) -> Wav2Vec2Model:
    """An fp32 Wav2Vec2Model on `device`, random from `seed` when given."""
    with torch.device("meta"):
        model = Wav2Vec2Model(cfg)
    model = model.to_empty(device=device)
    if seed is not None:
        model.init_weights(torch.Generator(device=device).manual_seed(seed))
    return model.eval().requires_grad_(False)


# ---------------------------------------------------------------------------
# state dicts


def _strip(state_dict):
    return {k[len("wav2vec2."):] if k.startswith("wav2vec2.") else k: v
            for k, v in state_dict.items()}


def infer_wav2vec_config(state_dict) -> Wav2Vec2Config:
    """The topology of an HF state dict (JAX `infer_wav2vec_config`); the
    positional conv's kernel and groups are read from its weight, where
    JAX assumes the released models' 128 and 16."""
    sd = _port_names(state_dict)
    n_convs = 1 + max(int(k.split(".")[2])
                      for k in sd if k.startswith("feature_extractor."))
    conv_dim, conv_kernel = [], []
    for i in range(n_convs):
        w = sd[f"feature_extractor.conv_layers.{i}.conv.weight"]
        conv_dim.append(w.shape[0])
        conv_kernel.append(w.shape[2])
    layered = "feature_extractor.conv_layers.1.layer_norm.weight" in sd
    n_layers = 1 + max(int(k.split(".")[2])
                       for k in sd if k.startswith("encoder.layers."))
    hidden = sd["feature_projection.projection.weight"].shape[0]
    ffn = sd["encoder.layers.0.feed_forward.intermediate_dense.weight"
             ].shape[0]
    base = WAV2VEC2_PRESETS["base"]
    pos_v = sd["encoder.pos_conv_embed.conv.weight_v"]
    return Wav2Vec2Config(
        num_conv_pos_embeddings=pos_v.shape[2],
        num_conv_pos_embedding_groups=hidden // pos_v.shape[1],
        conv_dim=tuple(conv_dim), conv_kernel=tuple(conv_kernel),
        conv_stride=base.conv_stride[:n_convs],
        conv_bias="feature_extractor.conv_layers.0.conv.bias" in sd,
        feat_extract_norm="layer" if layered else "group",
        hidden=hidden, layers=n_layers, ffn=ffn,
        heads={768: 12, 1024: 16}.get(hidden, max(1, hidden // 64)),
        do_stable_layer_norm=layered)


def _port_names(state_dict):
    """HF keys -> this module tree's: the `wav2vec2.` prefix dropped and
    torch>=2 weight-norm parametrization keys renamed to
    weight_g / weight_v."""
    pc = "encoder.pos_conv_embed.conv"
    rename = {f"{pc}.parametrizations.weight.original0": f"{pc}.weight_g",
              f"{pc}.parametrizations.weight.original1": f"{pc}.weight_v"}
    return {rename.get(k, k): torch.as_tensor(np.asarray(v)) if not
            torch.is_tensor(v) else v for k, v in _strip(state_dict).items()}


def _load_state_dict(path: str):
    """A local torch .pt / .bin state dict, an HF save directory holding
    one, or an .npz (nothing is downloaded)."""
    if os.path.isdir(path):
        for name in ("pytorch_model.bin", "model.pt"):
            cand = os.path.join(path, name)
            if os.path.exists(cand):
                path = cand
                break
    if path.endswith(".npz"):
        return dict(np.load(path))
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return sd


# ---------------------------------------------------------------------------
# waveform -> per-video-frame features


class Wav2Vec2AudioFeatures:
    """Drop-in for `AudioFeatureExtractor`: (waveform, sr, num_frames) ->
    [num_frames, dim] float32, from the Wav2Vec2 encoder's ~50 Hz tokens
    (stride 320 at 16 kHz), each frame the mean over its tokens. The
    encoder is `model`, or loaded from `checkpoint_path` (topology `cfg`,
    else inferred), or random (seed 0) at `preset`."""

    def __init__(self, checkpoint_path: Optional[str] = None,
                 preset: str = "base", dim: int = 1024, fps: float = 16.0,
                 model: Optional[Wav2Vec2Model] = None,
                 cfg: Optional[Wav2Vec2Config] = None, device=None):
        from omnihuman_tpu_torch.pipelines.text2video import resolve_device
        self.dim = dim
        self.fps = fps
        self.device = resolve_device(device)
        if model is not None:
            self.model = model.to(self.device)
        elif checkpoint_path:
            sd = _load_state_dict(checkpoint_path)
            # the head count is not in a state dict: `cfg` gives it where
            # the released sizes' table (768: 12, 1024: 16) does not
            self.model = build_wav2vec(cfg or infer_wav2vec_config(sd),
                                       self.device, seed=None)
            missing, _ = self.model.load_state_dict(_port_names(sd),
                                                    strict=False)
            # heads of a ForCTC checkpoint are ignored; a missing encoder
            # weight is an error (masked_spec_embed is unused at eval)
            if set(missing) - {"masked_spec_embed"}:
                raise KeyError(f"{checkpoint_path}: missing {missing}")
        else:
            self.model = build_wav2vec(WAV2VEC2_PRESETS[preset], self.device,
                                       seed=0)
        self.cfg = self.model.cfg

    @torch.inference_mode()
    def __call__(self, waveform: np.ndarray, sr: int,
                 num_frames: int) -> np.ndarray:
        wav = np.asarray(waveform, np.float32)
        if sr != SAMPLE_RATE:
            n = int(round(len(wav) * SAMPLE_RATE / max(sr, 1)))
            wav = np.interp(np.linspace(0, len(wav) - 1, max(n, 1)),
                            np.arange(len(wav)), wav).astype(np.float32)
        need = int(np.ceil(num_frames / self.fps * SAMPLE_RATE))
        need = max(need, 2 * self.cfg.stride_total + 400)
        if len(wav) < need:
            wav = np.pad(wav, (0, need - len(wav)))
        # HF Wav2Vec2FeatureExtractor do_normalize: zero-mean unit-var
        wav = (wav - wav.mean()) / np.sqrt(wav.var() + 1e-7)
        tok = self.model(torch.from_numpy(wav)[None].to(self.device))[0]
        tok = tok.float().cpu().numpy()                       # [T, hidden]
        tps = SAMPLE_RATE / self.cfg.stride_total / self.fps  # tokens/frame
        out = np.zeros((num_frames, self.dim), np.float32)
        reps = int(np.ceil(self.dim / tok.shape[1]))
        for t in range(num_frames):
            lo, hi = int(t * tps), max(int((t + 1) * tps), int(t * tps) + 1)
            seg = tok[lo:min(hi, len(tok))]
            row = seg.mean(0) if len(seg) else np.zeros(tok.shape[1])
            out[t] = np.tile(row, reps)[:self.dim]
        return out
