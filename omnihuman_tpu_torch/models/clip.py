"""XLM-RoBERTa CLIP: the ViT-H/14 image encoder of the i2v pipeline and the
XLM-R text tower (port of omnihuman_tpu/models/clip.py).

Reference wan/modules/clip.py:60-542: conv patch embedding without bias,
a cls token and learned positions, pre-norm transformer blocks (fused QKV,
exact GELU MLP), and `use_31_block`: the trunk stops one block short and
returns all 257 tokens ([B, 257, 1280] at 224x224), which the i2v DiT's
`img_emb` projects. `CLIPModel.visual` resizes the first frame to 224x224
(bicubic) and applies the CLIP normalisation. Module names follow the
reference (`visual.*`), so the visual half of a CLIP state dict loads with
`load_state_dict`.

The XLM-R text tower (`textual.*`, reference xlm_roberta.py:76-144 and
clip.py:303-326, JAX `init_xlm_roberta` / `clip_textual_forward`) is built
only where it is asked for (`XLMRobertaCLIP(cfg, text=True)`): nothing on
the i2v serving path calls it, and at full width it holds 0.56 B
parameters (2.2 GB in fp32). Post-norm blocks with separate q / k / v,
positions `pad_id + cumsum(mask) * mask`, a masked mean pool and a
Linear-GELU-Linear head.

Everything runs in fp32, the JAX default compute dtype here. Attention
(head_dim 80 in the visual tower, 64 in the text tower, the text's padded
keys masked) is a dense softmax in torch ops, as in the JAX package, where
the Pallas flash kernel sends a head_dim that is not a multiple of 128 to
XLA (omnihuman_tpu/ops/flash_pallas.py:678-685) and the padded text takes
the dense path (`clip.py:146-152`).
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


class TextAttention(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.q = nn.Linear(dim, dim)
        self.k = nn.Linear(dim, dim)
        self.v = nn.Linear(dim, dim)
        self.o = nn.Linear(dim, dim)


class TextBlock(nn.Module):
    """Post-norm XLM-R block (xlm_roberta.py AttentionBlock)."""

    def __init__(self, dim: int):
        super().__init__()
        self.attn = TextAttention(dim)
        self.norm1 = nn.LayerNorm(dim)
        self.ffn = nn.Sequential(nn.Linear(dim, dim * 4), nn.GELU(),
                                 nn.Linear(dim * 4, dim))
        self.norm2 = nn.LayerNorm(dim)


class XLMRobertaWithHead(nn.Module):
    def __init__(self, cfg: CLIPConfig):
        super().__init__()
        dim = cfg.text_dim
        mid = (dim + cfg.embed_dim) // 2
        self.token_embedding = nn.Embedding(cfg.vocab_size, dim)
        self.type_embedding = nn.Embedding(cfg.type_size, dim)
        self.pos_embedding = nn.Embedding(cfg.max_text_len, dim)
        self.norm = nn.LayerNorm(dim)
        self.blocks = nn.ModuleList(TextBlock(dim)
                                    for _ in range(cfg.text_layers))
        self.head = nn.Sequential(nn.Linear(dim, mid, bias=False), nn.GELU(),
                                  nn.Linear(mid, cfg.embed_dim, bias=False))


class XLMRobertaCLIP(nn.Module):
    """The reference XLMRobertaCLIP: the visual tower under `visual` and,
    with `text=True`, the XLM-R text tower under `textual`."""

    def __init__(self, cfg: CLIPConfig, text: bool = False):
        super().__init__()
        self.cfg = cfg
        self.visual = VisionTransformer(cfg)
        if text:
            self.textual = XLMRobertaWithHead(cfg)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """JAX init_clip_vision's rule: normal weights scaled by
        1/sqrt(fan_in) (the embeddings and head by 1/sqrt(dim)), zero
        biases, unit norms; the text tower, drawn after the visual one,
        by init_xlm_roberta's: linears the same, embeddings normal(0,
        0.02)."""
        v = self.visual
        gain = 1.0 / math.sqrt(self.cfg.vision_dim)
        for m in v.modules():
            _init_linear_or_norm(m, generator)
        for prm in (v.patch_embedding.weight, v.cls_embedding,
                    v.pos_embedding, v.head):
            prm.normal_(0.0, gain, generator=generator)
        t = getattr(self, "textual", None)
        if t is not None:
            for m in t.modules():
                _init_linear_or_norm(m, generator)
            for emb in (t.token_embedding, t.type_embedding,
                        t.pos_embedding):
                emb.weight.normal_(0.0, 0.02, generator=generator)


def _init_linear_or_norm(m: nn.Module, generator: torch.Generator) -> None:
    if isinstance(m, nn.Linear):
        m.weight.normal_(0.0, 1.0 / math.sqrt(m.in_features),
                         generator=generator)
        if m.bias is not None:
            m.bias.zero_()
    elif isinstance(m, nn.LayerNorm):
        m.weight.fill_(1.0)
        m.bias.zero_()


def build_clip(cfg: CLIPConfig, device, dtype: torch.dtype = torch.float32,
               seed: Optional[int] = 0, text: bool = False) -> XLMRobertaCLIP:
    """CLIP on `device` in `dtype`, random from `seed` (None: uninitialised,
    for a state dict to fill); the text tower only with `text`."""
    with torch.device("meta"):
        model = XLMRobertaCLIP(cfg, text=text)
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
    return _linear(p.proj, _softmax_attend(q, k, v, None).transpose(
        1, 2).reshape(b, s, c))


def _softmax_attend(q, k, v, bias) -> torch.Tensor:
    """softmax(Q K^T / sqrt(d) + bias) V over [B, N, S, D] in fp32."""
    logits = torch.matmul(q, k.transpose(-1, -2)) * (q.shape[-1] ** -0.5)
    if bias is not None:
        logits = logits + bias
    return torch.matmul(torch.softmax(logits, dim=-1), v)


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


def clip_textual_forward(model: XLMRobertaCLIP,
                         ids: torch.Tensor) -> torch.Tensor:
    """[B, L] token ids (pad_id padded) -> [B, embed_dim] (JAX
    clip_textual_forward; XLMRobertaWithHead, clip.py:303-326)."""
    cfg, t = model.cfg, model.textual
    b, s = ids.shape
    heads, c = cfg.text_heads, cfg.text_dim
    mask = (ids != cfg.pad_id).to(torch.int64)
    # out-of-range ids and positions clamp, as JAX's gathers do (a CUDA
    # gather would fault instead)
    pos_ids = (cfg.pad_id + torch.cumsum(mask, dim=1) * mask).clamp(
        max=cfg.max_text_len - 1)
    tok = ids.clamp(0, cfg.vocab_size - 1)
    x = (t.token_embedding.weight[tok] + t.type_embedding.weight[
        torch.zeros_like(ids)] + t.pos_embedding.weight[pos_ids]).float()
    # post-norm: the embedding norm first (xlm_roberta.py:128-131)
    x = layer_norm(x, t.norm.weight, t.norm.bias, eps=1e-5)
    bias = torch.where(mask[:, None, None, :] > 0, 0.0, -1e30)

    def heads_of(y):
        return y.reshape(b, s, heads, c // heads).transpose(1, 2)

    for blk in t.blocks:
        a = blk.attn
        y = _softmax_attend(heads_of(_linear(a.q, x)),
                            heads_of(_linear(a.k, x)),
                            heads_of(_linear(a.v, x)), bias)
        y = _linear(a.o, y.transpose(1, 2).reshape(b, s, c))
        x = layer_norm(x + y, blk.norm1.weight, blk.norm1.bias, eps=1e-5)
        h = _linear(blk.ffn[2], F.gelu(_linear(blk.ffn[0], x)))
        x = layer_norm(x + h, blk.norm2.weight, blk.norm2.bias, eps=1e-5)
    m = mask[:, :, None].float()
    pooled = (x * m).sum(1) / m.sum(1).clamp(min=1.0)
    return F.linear(F.gelu(F.linear(pooled, t.head[0].weight)),
                    t.head[2].weight)


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
    the file's text tower and log_scale stay unread: the i2v path builds
    no text tower), else random from `seed`."""

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
