"""CLIP ViT-H/14 image encoder of the i2v pipeline, the visual tower (port
of omnihuman_tpu/models/clip.py).

Reference wan/modules/clip.py:60-542: conv patch embedding without bias,
a cls token and learned positions, pre-norm transformer blocks (fused QKV,
exact GELU MLP), and `use_31_block`: the trunk stops one block short and
returns all 257 tokens ([B, 257, 1280] at 224x224), which the i2v DiT's
`img_emb` projects. `CLIPModel.visual` resizes the first frame to 224x224
(bicubic) and applies the CLIP normalisation. Module names follow the
reference (`visual.*`), so the visual half of a CLIP state dict loads with
`load_state_dict`; the XLM-R text tower is not ported.

Everything runs in fp32, the JAX default compute dtype here. Attention at
head_dim 80 is a dense softmax in torch ops, as in the JAX package, where
the Pallas flash kernel sends a head_dim that is not a multiple of 128 to
XLA (omnihuman_tpu/ops/flash_pallas.py:678-685).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from omnihuman_tpu_torch.configs.wan import CLIPConfig
from omnihuman_tpu_torch.ops.norms import layer_norm

# the CLIP file of a Wan 2.1 i2v checkpoint directory (reference names)
CLIP_CHECKPOINT = "models_clip_open-clip-xlm-roberta-large-vit-huge-14.pth"
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


class SelfAttention(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.to_qkv = nn.Linear(dim, dim * 3)
        self.proj = nn.Linear(dim, dim)


class AttentionBlock(nn.Module):
    def __init__(self, dim: int, mlp_ratio: float):
        super().__init__()
        hidden = int(dim * mlp_ratio)
        self.norm1 = nn.LayerNorm(dim)
        self.attn = SelfAttention(dim)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = nn.Sequential(nn.Linear(dim, hidden), nn.GELU(),
                                 nn.Linear(hidden, dim))


class VisionTransformer(nn.Module):
    def __init__(self, cfg: CLIPConfig):
        super().__init__()
        dim, p = cfg.vision_dim, cfg.patch_size
        n_patches = (cfg.image_size // p) ** 2
        self.patch_embedding = nn.Conv2d(3, dim, p, stride=p, bias=False)
        self.cls_embedding = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embedding = nn.Parameter(torch.zeros(1, n_patches + 1, dim))
        self.pre_norm = nn.LayerNorm(dim)
        self.transformer = nn.Sequential(
            *[AttentionBlock(dim, cfg.vision_mlp_ratio)
              for _ in range(cfg.vision_layers)])
        self.post_norm = nn.LayerNorm(dim)
        self.head = nn.Parameter(torch.zeros(dim, cfg.embed_dim))


class XLMRobertaCLIP(nn.Module):
    """The reference XLMRobertaCLIP's visual tower under `visual`."""

    def __init__(self, cfg: CLIPConfig):
        super().__init__()
        self.cfg = cfg
        self.visual = VisionTransformer(cfg)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """JAX init_clip_vision's rule: normal weights scaled by
        1/sqrt(fan_in) (the embeddings and head by 1/sqrt(dim)), zero
        biases, unit norms."""
        v = self.visual
        gain = 1.0 / math.sqrt(self.cfg.vision_dim)
        for m in v.modules():
            if isinstance(m, nn.Linear):
                m.weight.normal_(0.0, 1.0 / math.sqrt(m.in_features),
                                 generator=generator)
                m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
        for prm in (v.patch_embedding.weight, v.cls_embedding,
                    v.pos_embedding, v.head):
            prm.normal_(0.0, gain, generator=generator)


def build_clip(cfg: CLIPConfig, device, dtype: torch.dtype = torch.float32,
               seed: Optional[int] = 0) -> XLMRobertaCLIP:
    with torch.device("meta"):
        model = XLMRobertaCLIP(cfg)
    model = model.to(dtype).to_empty(device=device)
    if seed is not None:
        model.init_weights(torch.Generator(device=device).manual_seed(seed))
    return model.eval().requires_grad_(False)


def _linear(lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    return F.linear(x, lin.weight, lin.bias)


def _attention(p: SelfAttention, x: torch.Tensor, heads: int) -> torch.Tensor:
    """Fused-QKV self-attention (clip.py:56-91), dense softmax in fp32."""
    b, s, c = x.shape
    d = c // heads
    q, k, v = _linear(p.to_qkv, x).reshape(b, s, 3, heads, d).permute(
        2, 0, 3, 1, 4)                                   # [3, B, N, S, D]
    logits = torch.matmul(q, k.transpose(-1, -2)) * (d ** -0.5)
    y = torch.matmul(torch.softmax(logits, dim=-1), v)   # [B, N, S, D]
    return _linear(p.proj, y.transpose(1, 2).reshape(b, s, c))


def clip_visual_forward(model: XLMRobertaCLIP, images: torch.Tensor,
                        use_31_block: Optional[bool] = None) -> torch.Tensor:
    """[B, 3, 224, 224] (CLIP-normalised) -> [B, 257, vision_dim] tokens
    (use_31_block) or the pooled [B, embed_dim] (JAX clip_visual_forward)."""
    cfg, v = model.cfg, model.visual
    if use_31_block is None:
        use_31_block = cfg.use_31_block
    b, p = images.shape[0], cfg.patch_size
    w = v.patch_embedding.weight
    x = F.conv2d(images.to(w.dtype), w, stride=p)        # [B, dim, g, g]
    x = x.flatten(2).transpose(1, 2)                      # [B, g*g, dim]
    x = torch.cat([v.cls_embedding.expand(b, 1, -1), x], dim=1)
    x = x + v.pos_embedding
    x = layer_norm(x, v.pre_norm.weight, v.pre_norm.bias, eps=1e-5)
    n_blocks = cfg.vision_layers - 1 if use_31_block else cfg.vision_layers
    for blk in list(v.transformer)[:n_blocks]:
        h = layer_norm(x, blk.norm1.weight, blk.norm1.bias, eps=1e-5)
        x = x + _attention(blk.attn, h, cfg.vision_heads)
        h = layer_norm(x, blk.norm2.weight, blk.norm2.bias, eps=1e-5)
        h = F.gelu(_linear(blk.mlp[0], h))
        x = x + _linear(blk.mlp[2], h)
    if use_31_block:
        return x
    x = layer_norm(x, v.post_norm.weight, v.post_norm.bias, eps=1e-5)
    return x[:, 0] @ v.head


def resize_bicubic(x: torch.Tensor, size) -> torch.Tensor:
    """[B, C, H, W] -> [B, C, *size]: jax.image.resize(..., "bicubic")
    (Keys cubic, a = -0.5, antialiased when shrinking), which is
    F.interpolate's antialiased bicubic."""
    return F.interpolate(x, size=tuple(size), mode="bicubic",
                         align_corners=False, antialias=True)


def preprocess_images(images, image_size: int = 224,
                      device=None) -> torch.Tensor:
    """[B, 3, H, W] in [-1, 1] -> CLIP-normalised [B, 3, size, size] fp32
    (bicubic resize like clip.py:529-537)."""
    x = torch.as_tensor(np.asarray(images) if not torch.is_tensor(images)
                        else images, dtype=torch.float32, device=device)
    x = resize_bicubic(x, (image_size, image_size)) * 0.5 + 0.5
    mean = torch.tensor(CLIP_MEAN, device=x.device).view(1, 3, 1, 1)
    std = torch.tensor(CLIP_STD, device=x.device).view(1, 3, 1, 1)
    return (x - mean) / std


class CLIPModel:
    """visual() front end of the i2v pipeline (JAX CLIPModel); `model`
    holds the weights: the visual tower of the CLIP file at
    `checkpoint_path` (reference names, as JAX `convert_clip` reads them;
    the text tower and log_scale are not carried), else random from
    `seed`."""

    def __init__(self, cfg: CLIPConfig, device, seed: Optional[int] = 0,
                 checkpoint_path: Optional[str] = None):
        self.cfg = cfg
        self.model = build_clip(cfg, device, torch.float32,
                                seed=None if checkpoint_path else seed)
        if checkpoint_path:
            from omnihuman_tpu_torch.utils.convert import (
                load_named, load_torch_state_dict)
            load_named(self.model, load_torch_state_dict(checkpoint_path),
                       checkpoint_path)

    @torch.inference_mode()
    def visual(self, videos) -> torch.Tensor:
        """[B, 3, H, W] first frames in [-1, 1] -> [B, 257, 1280]."""
        dev = self.model.visual.pos_embedding.device
        x = preprocess_images(videos, self.cfg.image_size, device=dev)
        return clip_visual_forward(self.model, x, use_31_block=True)
