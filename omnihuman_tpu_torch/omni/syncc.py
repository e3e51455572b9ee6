"""Sync-C audio-visual embedders, SyncNet-style (port of
omnihuman_tpu/omni/syncc.py).

The reference's Sync-C ran on `torch.randn` placeholders
(Omnihuman/omnihuman-eval.py:97-109). As in the JAX package: an audio
tower over per-frame audio features (two linears, ReLU, mean over the
window) and a visual tower over 5-frame mouth-crop windows (3x3x3 convs,
stride (1, 2, 2), symmetric padding 1, ReLU, global average, a linear),
each L2-normalized; their cosine is the Sync-C confidence. Module names
are the two-tower state dict's (`audio_fc1.weight`, `visual_conv0.weight`
[out, in, kT, kH, kW], ...). Without trained weights the towers are
random from a seed, and the evaluator tags the score as such.

The mouth crop is a fixed lower-centre region of the frame, resized to
crop_size x crop_size with an antialiased bilinear resize (jax.image
.resize "linear" antialiases when it shrinks; F.interpolate with
antialias=True). Runs on the GPU unless the caller asks for the CPU.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


@dataclass(frozen=True)
class SyncCConfig:
    embed_dim: int = 256
    window: int = 5                    # frames per sync window
    crop_size: int = 48                # mouth crop resized to S x S
    visual_channels: Tuple[int, ...] = (32, 64, 128)
    audio_hidden: int = 256
    # mouth region as fractions of (H, W): lower-centre of the frame
    crop_rows: Tuple[float, float] = (0.55, 0.95)
    crop_cols: Tuple[float, float] = (0.30, 0.70)


SYNCC_PRESETS = {
    "default": SyncCConfig(),
    "tiny-test": SyncCConfig(embed_dim=16, crop_size=16,
                             visual_channels=(4, 8), audio_hidden=16),
}


class SyncCModel(nn.Module):
    def __init__(self, cfg: SyncCConfig, audio_dim: int = 1024):
        super().__init__()
        self.cfg = cfg
        self.audio_fc1 = nn.Linear(audio_dim, cfg.audio_hidden)
        self.audio_fc2 = nn.Linear(cfg.audio_hidden, cfg.embed_dim)
        cin = 3
        for i, cout in enumerate(cfg.visual_channels):
            self.add_module(f"visual_conv{i}", nn.Conv3d(
                cin, cout, 3, stride=(1, 2, 2), padding=1))
            cin = cout
        self.visual_fc = nn.Linear(cin, cfg.embed_dim)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """JAX init_syncc's rule: weights and biases U(+-1/sqrt(fan_in))."""
        for m in self.modules():
            if isinstance(m, (nn.Linear, nn.Conv3d)):
                lim = 1.0 / math.sqrt(m.weight[0].numel())
                m.weight.uniform_(-lim, lim, generator=generator)
                m.bias.uniform_(-lim, lim, generator=generator)


def _l2norm(x, eps=1e-8):
    return x / x.norm(dim=-1, keepdim=True).clamp_min(eps)


def syncc_audio_embed(model: SyncCModel, feats: torch.Tensor) -> torch.Tensor:
    """[N, window, D_audio] per-window audio features -> [N, embed_dim]
    L2-normalized embeddings."""
    h = F.relu(model.audio_fc1(feats)).mean(dim=1)      # pool the window
    return _l2norm(model.audio_fc2(h))


def syncc_visual_embed(model: SyncCModel, crops: torch.Tensor
                       ) -> torch.Tensor:
    """[N, window, S, S, 3] mouth-crop windows -> [N, embed_dim]."""
    h = crops.permute(0, 4, 1, 2, 3)                    # [N, 3, w, S, S]
    for i in range(len(model.cfg.visual_channels)):
        h = F.relu(getattr(model, f"visual_conv{i}")(h))
    return _l2norm(model.visual_fc(h.mean(dim=(2, 3, 4))))


def build_syncc(cfg: SyncCConfig, device, audio_dim: int = 1024,
                seed: Optional[int] = 0) -> SyncCModel:
    with torch.device("meta"):
        model = SyncCModel(cfg, audio_dim)
    model = model.to_empty(device=device)
    if seed is not None:
        model.init_weights(torch.Generator(device=device).manual_seed(seed))
    return model.eval().requires_grad_(False)


class SyncCEmbedders:
    """The (audio_embed_fn, visual_embed_fn) pair for `LipSyncEvaluator` /
    `OmniHumanEvaluator` (JAX SyncCEmbedders).

    audio_embed_fn: [T, D_audio] per-frame features -> [N, D] window
    embeddings (stride-1 windows of cfg.window frames).
    visual_embed_fn: [C, T, H, W] video in [-1, 1] -> [N, D] mouth-crop
    window embeddings; the towers share the window count, so the
    evaluator's cosine pairing lines up 1:1."""

    def __init__(self, weights_path: Optional[str] = None,
                 preset: str = "default", audio_dim: int = 1024,
                 seed: int = 0, model: Optional[SyncCModel] = None,
                 cfg: Optional[SyncCConfig] = None, device=None):
        from omnihuman_tpu_torch.pipelines.text2video import resolve_device
        from omnihuman_tpu_torch.utils.convert import (
            load_named, load_torch_state_dict)
        self.cfg = cfg if cfg is not None else SYNCC_PRESETS[preset]
        self.audio_dim = audio_dim
        self.device = resolve_device(device)
        if model is not None:
            self.model = model.to(self.device)
            self.random_init = False
        elif weights_path:
            self.model = build_syncc(self.cfg, self.device, audio_dim,
                                     seed=None)
            load_named(self.model, load_torch_state_dict(weights_path),
                       weights_path)
            self.random_init = False
        else:
            self.model = build_syncc(self.cfg, self.device, audio_dim,
                                     seed=seed)
            self.random_init = True

    def _windows(self, n_frames: int):
        return range(max(n_frames - self.cfg.window + 1, 1))

    @torch.inference_mode()
    def audio_embed_fn(self, audio: np.ndarray) -> np.ndarray:
        a = np.asarray(audio, np.float32)
        if a.ndim == 1:                       # raw scalar envelope etc.
            a = np.tile(a[:, None], (1, self.audio_dim))
        if a.shape[1] != self.audio_dim:      # tile / trim to tower width
            reps = int(np.ceil(self.audio_dim / a.shape[1]))
            a = np.tile(a, (1, reps))[:, :self.audio_dim]
        w = self.cfg.window
        if len(a) < w:
            a = np.pad(a, ((0, w - len(a)), (0, 0)))
        wins = np.stack([a[i:i + w] for i in self._windows(len(a))])
        out = syncc_audio_embed(self.model,
                                torch.from_numpy(wins).to(self.device))
        return out.cpu().numpy()

    @torch.inference_mode()
    def visual_embed_fn(self, video: np.ndarray) -> np.ndarray:
        v = np.asarray(video, np.float32)     # [C, T, H, W]
        c, t, h, wd = v.shape
        r0, r1 = (int(f * h) for f in self.cfg.crop_rows)
        c0, c1 = (int(f * wd) for f in self.cfg.crop_cols)
        crop = v[:, :, max(r0, 0):max(r1, r0 + 1),
                 max(c0, 0):max(c1, c0 + 1)]
        x = torch.from_numpy(np.ascontiguousarray(crop.transpose(1, 0, 2, 3))
                             ).to(self.device)          # [T, C, Hc, Wc]
        if c == 1:
            x = x.expand(-1, 3, -1, -1)
        s = self.cfg.crop_size
        x = F.interpolate(x, size=(s, s), mode="bilinear",
                          align_corners=False, antialias=True)
        x = x.permute(0, 2, 3, 1)                       # [T, S, S, C]
        w = self.cfg.window
        if t < w:
            x = torch.cat([x, x[-1:].expand(w - t, -1, -1, -1)])
        wins = torch.stack([x[i:i + w] for i in self._windows(len(x))])
        return syncc_visual_embed(self.model, wins).cpu().numpy()
