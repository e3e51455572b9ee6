"""InceptionV3 features for FID / IS (port of omnihuman_tpu/omni/inception.py).

The reference evaluation used torchmetrics' FrechetInceptionDistance /
InceptionScore (Omnihuman/omnihuman-eval.py:20-28, 160-170): the pool3
(2048-d) features and class logits of InceptionV3. This is that network
under torchvision's module names (`Conv2d_1a_3x3.conv.weight`,
`Mixed_5b.branch1x1.bn.running_mean`, ..., `fc.weight`), so a
torchvision or pytorch-fid state dict (1000 or 1008 classes) loads as it
is; the JAX package's graph is copied: BasicConv2d (conv without bias,
frozen BatchNorm eps 1e-3, ReLU), the Mixed_5b..7c blocks with their
branch-pool average at count_include_pad=False, global average pooling.
Without weights it is random from a seed (He-normal convs): a
content-sensitive proxy, tagged as such by the evaluator.

Input: [N, 3, H, W] in [-1, 1], resized to 299x299 by an antialiased
bilinear resize (jax.image.resize "bilinear" antialiases when it shrinks,
as F.interpolate does with antialias=True). Runs on the GPU unless the
caller asks for the CPU; no hand kernel is involved (the JAX package
leaves the network to XLA).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

_BN_EPS = 1e-3


class BasicConv2d(nn.Module):
    def __init__(self, cin: int, cout: int, kh: int, kw: int,
                 stride: int = 1, pad: bool = False):
        super().__init__()
        padding = ((kh - 1) // 2, (kw - 1) // 2) if pad else 0
        self.conv = nn.Conv2d(cin, cout, (kh, kw), stride=stride,
                              padding=padding, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=_BN_EPS)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def _avg_pool_same(x):
    """3x3 stride-1 SAME average pool, count_include_pad=False."""
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


def _max_pool(x):
    return F.max_pool2d(x, 3, stride=2)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64, 1, 1)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, 5, pad=True)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, 3, pad=True)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, 3, pad=True)
        self.branch_pool = BasicConv2d(cin, pool_features, 1, 1)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avg_pool_same(x))
        return torch.cat([self.branch1x1(x), b5, bd, bp], dim=1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, 3, pad=True)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, _max_pool(x)], dim=1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 192, 1, 1)
        self.branch7x7_1 = BasicConv2d(cin, c7, 1, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, 1, 7, pad=True)
        self.branch7x7_3 = BasicConv2d(c7, 192, 7, 1, pad=True)
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, 1, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, 7, 1, pad=True)
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, 1, 7, pad=True)
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, 7, 1, pad=True)
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, 1, 7, pad=True)
        self.branch_pool = BasicConv2d(cin, 192, 1, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for m in (self.branch7x7dbl_2, self.branch7x7dbl_3,
                  self.branch7x7dbl_4, self.branch7x7dbl_5):
            bd = m(bd)
        bp = self.branch_pool(_avg_pool_same(x))
        return torch.cat([self.branch1x1(x), b7, bd, bp], dim=1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, 1, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, 1, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, 1, 7, pad=True)
        self.branch7x7x3_3 = BasicConv2d(192, 192, 7, 1, pad=True)
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_1(x)
        for m in (self.branch7x7x3_2, self.branch7x7x3_3,
                  self.branch7x7x3_4):
            b7 = m(b7)
        return torch.cat([b3, b7, _max_pool(x)], dim=1)


class InceptionE(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 320, 1, 1)
        self.branch3x3_1 = BasicConv2d(cin, 384, 1, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, 1, 3, pad=True)
        self.branch3x3_2b = BasicConv2d(384, 384, 3, 1, pad=True)
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, 1, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, 3, pad=True)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, 1, 3, pad=True)
        self.branch3x3dbl_3b = BasicConv2d(384, 384, 3, 1, pad=True)
        self.branch_pool = BasicConv2d(cin, 192, 1, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)],
                       1)
        bp = self.branch_pool(_avg_pool_same(x))
        return torch.cat([self.branch1x1(x), b3, bd, bp], dim=1)


class InceptionV3(nn.Module):
    """The FID InceptionV3 under torchvision's names (pt_inception has
    1008 classes, torchvision 1000)."""

    def __init__(self, num_classes: int = 1008):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, 3, pad=True)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280)
        self.Mixed_7c = InceptionE(2048)
        self.fc = nn.Linear(2048, num_classes)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """JAX init_inception's rule: convs N(0, 2 / fan_in), unit BN, fc
        N(0, 0.02) with a zero bias."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.weight[0].numel()
                m.weight.normal_(0.0, math.sqrt(2.0 / fan_in),
                                 generator=generator)
            elif isinstance(m, nn.BatchNorm2d):
                m.weight.fill_(1.0)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
        self.fc.weight.normal_(0.0, 0.02, generator=generator)
        self.fc.bias.zero_()


def inception_forward(model: InceptionV3, images: torch.Tensor,
                      with_logits: bool = False):
    """images [N, 3, H, W] in [-1, 1] -> pool3 features [N, 2048] (and
    logits [N, num_classes] when with_logits)."""
    x = images.float()
    if tuple(x.shape[2:]) != (299, 299):
        x = F.interpolate(x, size=(299, 299), mode="bilinear",
                          align_corners=False, antialias=True)
    x = model.Conv2d_1a_3x3(x)
    x = model.Conv2d_2a_3x3(x)
    x = _max_pool(model.Conv2d_2b_3x3(x))
    x = model.Conv2d_3b_1x1(x)
    x = _max_pool(model.Conv2d_4a_3x3(x))
    for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a", "Mixed_6b",
                 "Mixed_6c", "Mixed_6d", "Mixed_6e", "Mixed_7a", "Mixed_7b",
                 "Mixed_7c"):
        x = getattr(model, name)(x)
    feats = x.mean(dim=(2, 3))                            # [N, 2048]
    if with_logits:
        return feats, model.fc(feats)
    return feats


def build_inception(device, num_classes: int = 1008,
                    seed: Optional[int] = 0) -> InceptionV3:
    with torch.device("meta"):
        model = InceptionV3(num_classes)
    model = model.to_empty(device=device)
    if seed is not None:
        model.init_weights(torch.Generator(device=device).manual_seed(seed))
    return model.eval().requires_grad_(False)


class InceptionFeatures:
    """Batched pool3 features / IS logits for the evaluators (JAX
    InceptionFeatures). weights_path: a torchvision / pytorch-fid state
    dict; None -> random from `seed` (the content-sensitive proxy)."""

    def __init__(self, weights_path: Optional[str] = None, seed: int = 0,
                 batch_size: int = 16, device=None):
        from omnihuman_tpu_torch.pipelines.text2video import resolve_device
        from omnihuman_tpu_torch.utils.convert import (
            load_named, load_torch_state_dict)
        self.device = resolve_device(device)
        if weights_path:
            sd = load_torch_state_dict(weights_path)
            self.model = build_inception(self.device,
                                         sd["fc.weight"].shape[0], seed=None)
            load_named(self.model, sd)
            self.pretrained = True
        else:
            self.model = build_inception(self.device, seed=seed)
            self.pretrained = False
        self.batch_size = batch_size

    @torch.inference_mode()
    def _batched(self, frames: np.ndarray, with_logits: bool):
        outs = []
        for i in range(0, frames.shape[0], self.batch_size):
            chunk = torch.from_numpy(np.ascontiguousarray(
                frames[i:i + self.batch_size])).to(self.device)
            out = inception_forward(self.model, chunk, with_logits)
            outs.append(out[1] if with_logits else out)
        return torch.cat(outs).cpu().numpy()

    def __call__(self, frames: np.ndarray) -> np.ndarray:
        """[N, 3, H, W] in [-1, 1] -> [N, 2048] pool3 features."""
        return self._batched(np.asarray(frames, np.float32), False)

    def logits(self, frames: np.ndarray) -> np.ndarray:
        """[N, 3, H, W] -> [N, num_classes] class logits (for IS)."""
        return self._batched(np.asarray(frames, np.float32), True)

    def video_features(self, videos: np.ndarray) -> np.ndarray:
        """[N, C, T, H, W] -> [N, 4096]: the temporal mean ++ std of the
        per-frame pool3 features (the Inception-based FVD stand-in)."""
        n, c, t = videos.shape[:3]
        flat = np.asarray(videos, np.float32).transpose(
            0, 2, 1, 3, 4).reshape(n * t, c, *videos.shape[3:])
        feats = self(flat).reshape(n, t, -1)
        return np.concatenate([feats.mean(1), feats.std(1)], axis=-1)
