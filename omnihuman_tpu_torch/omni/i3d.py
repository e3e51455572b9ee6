"""I3D (inflated Inception-V1) video features for FVD (port of
omnihuman_tpu/omni/i3d.py).

The reference's FVD "I3D" is a `torch.randn` placeholder
(Omnihuman/omnihuman-eval.py:30-33); the JAX package implements the
Kinetics I3D graph, and this is that graph under the public piergiaj /
pytorch-i3d names (`Conv3d_1a_7x7.conv3d.weight`, `Mixed_3b.b1a.bn.*`,
`logits.conv3d.bias`), so `rgb_imagenet.pt`-style state dicts load as
they are. As in JAX: TF-SAME padding (zeros for the convs, -inf for the
max pools, asymmetric where the total is odd), BatchNorm eps 1e-3 with
the running statistics explicit, features = the global average of
Mixed_5c (1024-d), logits = the 1x1x1 logits conv applied to them.

`I3DVideoFeatures`: [N, C, T, H, W] in [-1, 1] -> [N, 1024], on the GPU
unless the caller asks for the CPU; random from a seed without weights.
The JAX package leaves the network to XLA, so no hand kernel is involved.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# InceptionModule channel plan: name -> (b0, b1a, b1b, b2a, b2b, b3b)
MIXED = (
    ("Mixed_3b", (64, 96, 128, 16, 32, 32)),
    ("Mixed_3c", (128, 128, 192, 32, 96, 64)),
    ("Mixed_4b", (192, 96, 208, 16, 48, 64)),
    ("Mixed_4c", (160, 112, 224, 24, 64, 64)),
    ("Mixed_4d", (128, 128, 256, 24, 64, 64)),
    ("Mixed_4e", (112, 144, 288, 32, 64, 64)),
    ("Mixed_4f", (256, 160, 320, 32, 128, 128)),
    ("Mixed_5b", (256, 160, 320, 32, 128, 128)),
    ("Mixed_5c", (384, 192, 384, 48, 128, 128)),
)


@dataclass(frozen=True)
class I3DConfig:
    num_classes: int = 400
    width_mult: float = 1.0     # tiny-test shrink factor
    bn_eps: float = 1e-3        # piergiaj Unit3D BatchNorm3d eps

    def ch(self, c: int) -> int:
        return max(4, int(round(c * self.width_mult)))


I3D_PRESETS = {
    "kinetics-400": I3DConfig(),
    "tiny-test": I3DConfig(num_classes=11, width_mult=0.125),
}


def _same_pad(x: torch.Tensor, k, s, value: float = 0.0) -> torch.Tensor:
    """TF SAME padding of the last three dims of [B, C, T, H, W]."""
    pad = []
    for size, kk, ss in zip(reversed(x.shape[2:]), reversed(k), reversed(s)):
        total = max((math.ceil(size / ss) - 1) * ss + kk - size, 0)
        pad += [total // 2, total - total // 2]
    return F.pad(x, pad, value=value)


class Unit3D(nn.Module):
    def __init__(self, cin: int, cout: int, k: Tuple[int, int, int],
                 stride=(1, 1, 1), bn: bool = True, bias: bool = False,
                 eps: float = 1e-3):
        super().__init__()
        self.k, self.stride = k, stride
        self.conv3d = nn.Conv3d(cin, cout, k, stride=stride, bias=bias)
        self.bn = nn.BatchNorm3d(cout, eps=eps) if bn else None

    def forward(self, x, relu: bool = True):
        y = self.conv3d(_same_pad(x, self.k, self.stride))
        if self.bn is not None:
            y = self.bn(y)
        return F.relu(y) if relu else y


def _max_pool(x, k, s):
    return F.max_pool3d(_same_pad(x, k, s, -math.inf), k, s)


class InceptionModule(nn.Module):
    def __init__(self, cfg: I3DConfig, cin: int, plan):
        super().__init__()
        b0, b1a, b1b, b2a, b2b, b3b = (cfg.ch(c) for c in plan)
        one, three, e = (1, 1, 1), (3, 3, 3), cfg.bn_eps
        self.b0 = Unit3D(cin, b0, one, eps=e)
        self.b1a = Unit3D(cin, b1a, one, eps=e)
        self.b1b = Unit3D(b1a, b1b, three, eps=e)
        self.b2a = Unit3D(cin, b2a, one, eps=e)
        self.b2b = Unit3D(b2a, b2b, three, eps=e)
        self.b3b = Unit3D(cin, b3b, one, eps=e)
        self.out_channels = b0 + b1b + b2b + b3b

    def forward(self, x):
        return torch.cat([
            self.b0(x), self.b1b(self.b1a(x)), self.b2b(self.b2a(x)),
            self.b3b(_max_pool(x, (3, 3, 3), (1, 1, 1)))], dim=1)


class InceptionI3d(nn.Module):
    """The piergiaj InceptionI3d module tree (no dropout, eval only)."""

    def __init__(self, cfg: I3DConfig):
        super().__init__()
        self.cfg = cfg
        c64, c192, e = cfg.ch(64), cfg.ch(192), cfg.bn_eps
        self.Conv3d_1a_7x7 = Unit3D(3, c64, (7, 7, 7), (2, 2, 2), eps=e)
        self.Conv3d_2b_1x1 = Unit3D(c64, c64, (1, 1, 1), eps=e)
        self.Conv3d_2c_3x3 = Unit3D(c64, c192, (3, 3, 3), eps=e)
        cin = c192
        for name, plan in MIXED:
            m = InceptionModule(cfg, cin, plan)
            self.add_module(name, m)
            cin = m.out_channels
        self.logits = Unit3D(cin, cfg.num_classes, (1, 1, 1), bn=False,
                             bias=True)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """JAX init_i3d's rule: convs N(0, 2 / fan_in), zero biases, unit
        BN statistics."""
        for m in self.modules():
            if isinstance(m, nn.Conv3d):
                m.weight.normal_(0.0, math.sqrt(2.0 / m.weight[0].numel()),
                                 generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm3d):
                m.weight.fill_(1.0)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)


def i3d_forward(model: InceptionI3d, video: torch.Tensor,
                with_logits: bool = False):
    """video [B, 3, T, H, W] in [-1, 1] -> [B, 1024] pooled features (and
    [B, num_classes] logits when `with_logits`). JAX i3d_forward takes
    the same video channels-last."""
    x = model.Conv3d_1a_7x7(video.float())
    x = _max_pool(x, (1, 3, 3), (1, 2, 2))
    x = model.Conv3d_2b_1x1(x)
    x = model.Conv3d_2c_3x3(x)
    x = _max_pool(x, (1, 3, 3), (1, 2, 2))
    for name, _ in MIXED:
        if name == "Mixed_4b":
            x = _max_pool(x, (3, 3, 3), (2, 2, 2))
        elif name == "Mixed_5b":
            x = _max_pool(x, (2, 2, 2), (2, 2, 2))
        x = getattr(model, name)(x)
    feats = x.mean(dim=(2, 3, 4))                          # [B, 1024]
    if not with_logits:
        return feats
    conv = model.logits.conv3d
    return feats, F.linear(feats, conv.weight.flatten(1), conv.bias)


def build_i3d(cfg: I3DConfig, device, seed: Optional[int] = 0
              ) -> InceptionI3d:
    with torch.device("meta"):
        model = InceptionI3d(cfg)
    model = model.to_empty(device=device)
    if seed is not None:
        model.init_weights(torch.Generator(device=device).manual_seed(seed))
    return model.eval().requires_grad_(False)


class I3DVideoFeatures:
    """Temporal FVD features for `omni/evaluate.py` (JAX I3DVideoFeatures):
    [N, C, T, H, W] in [-1, 1] -> [N, 1024]. Weights: `model`, else a
    piergiaj state dict at `weights_path`, else random from `seed`."""

    def __init__(self, weights_path: Optional[str] = None,
                 preset: str = "kinetics-400", seed: int = 0,
                 batch_size: int = 4, model: Optional[InceptionI3d] = None,
                 cfg: Optional[I3DConfig] = None, device=None):
        from omnihuman_tpu_torch.pipelines.text2video import resolve_device
        from omnihuman_tpu_torch.utils.convert import (
            load_named, load_torch_state_dict)
        self.cfg = cfg if cfg is not None else I3D_PRESETS[preset]
        self.batch_size = batch_size
        self.device = resolve_device(device)
        if model is not None:
            self.model = model.to(self.device)
            self.random_init = False
        elif weights_path:
            self.model = build_i3d(self.cfg, self.device, seed=None)
            load_named(self.model, load_torch_state_dict(weights_path),
                       weights_path)
            self.random_init = False
        else:
            self.model = build_i3d(self.cfg, self.device, seed=seed)
            self.random_init = True

    @torch.inference_mode()
    def __call__(self, videos: np.ndarray) -> np.ndarray:
        v = np.asarray(videos, np.float32)
        if v.ndim != 5:
            raise ValueError(f"expected [N, C, T, H, W], got {v.shape}")
        outs = []
        for i in range(0, v.shape[0], self.batch_size):
            chunk = torch.from_numpy(np.ascontiguousarray(
                v[i:i + self.batch_size])).to(self.device)
            outs.append(i3d_forward(self.model, chunk))
        return torch.cat(outs).cpu().numpy()
