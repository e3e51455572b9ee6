"""umT5 text encoder (port of omnihuman_tpu/models/t5.py).

Encoder-only umT5 (reference wan/modules/t5.py): relative-position-bucket
attention with per-layer position tables, NO 1/sqrt(d) scaling, softmax in
fp32, gated tanh-GELU FFN, pre-norm blocks x += attn(norm1(x));
x += ffn(norm2(x)) (the corrected block of the JAX package), final RMS
norm and output mask. Module names follow the reference T5Encoder so its
checkpoint loads with `load_state_dict`.

Token ids past the vocabulary are clamped to the last row, as the JAX
gather `token_embedding[ids]` does (the offline hash tokenizer emits ids
up to 256,383 whatever the configured vocabulary).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from omnihuman_tpu_torch.configs.wan import T5Config
from omnihuman_tpu_torch.ops.norms import rms_norm


def relative_position_buckets(lq: int, lk: int, num_buckets: int,
                              max_dist: int,
                              bidirectional: bool = True) -> np.ndarray:
    """Static [Lq, Lk] int32 bucket matrix (reference t5.py:256-275)."""
    rel_pos = np.arange(lk)[None, :] - np.arange(lq)[:, None]
    if bidirectional:
        nb = num_buckets // 2
        rel_buckets = (rel_pos > 0).astype(np.int64) * nb
        rel_pos = np.abs(rel_pos)
    else:
        nb = num_buckets
        rel_buckets = np.zeros_like(rel_pos)
        rel_pos = -np.minimum(rel_pos, 0)

    max_exact = nb // 2
    with np.errstate(divide="ignore"):
        rel_large = max_exact + (
            np.log(np.maximum(rel_pos, 1) / max_exact)
            / math.log(max_dist / max_exact) * (nb - max_exact)
        ).astype(np.int64)
    rel_large = np.minimum(rel_large, nb - 1)
    rel_buckets = rel_buckets + np.where(rel_pos < max_exact, rel_pos,
                                         rel_large)
    return rel_buckets.astype(np.int32)


class T5LayerNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))


class T5Attention(nn.Module):
    def __init__(self, dim: int, dim_attn: int):
        super().__init__()
        self.q = nn.Linear(dim, dim_attn, bias=False)
        self.k = nn.Linear(dim, dim_attn, bias=False)
        self.v = nn.Linear(dim, dim_attn, bias=False)
        self.o = nn.Linear(dim_attn, dim, bias=False)


class T5FeedForward(nn.Module):
    def __init__(self, dim: int, dim_ffn: int):
        super().__init__()
        self.gate = nn.Sequential(nn.Linear(dim, dim_ffn, bias=False),
                                  nn.GELU(approximate="tanh"))
        self.fc1 = nn.Linear(dim, dim_ffn, bias=False)
        self.fc2 = nn.Linear(dim_ffn, dim, bias=False)


class T5RelativeEmbedding(nn.Module):
    def __init__(self, num_buckets: int, num_heads: int):
        super().__init__()
        self.embedding = nn.Embedding(num_buckets, num_heads)


class T5SelfAttention(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.norm1 = T5LayerNorm(cfg.dim)
        self.attn = T5Attention(cfg.dim, cfg.dim_attn)
        self.norm2 = T5LayerNorm(cfg.dim)
        self.ffn = T5FeedForward(cfg.dim, cfg.dim_ffn)
        self.pos_embedding = T5RelativeEmbedding(cfg.num_buckets,
                                                 cfg.num_heads)

    def forward(self, x, mask_bias, buckets, cfg: T5Config,
                cd: torch.dtype) -> torch.Tensor:
        """One encoder block on the fp32 residual x [B, L, dim]. Called as
        a module, so FSDP2's per-block hooks gather its parameters."""
        h = rms_norm(x, self.norm1.weight, eps=1e-6)
        x = x + _t5_attention(self, h, mask_bias, buckets, cfg, cd).float()
        h = rms_norm(x, self.norm2.weight, eps=1e-6)
        hc = h.to(cd)
        ff = (hc @ self.ffn.fc1.weight.to(cd).t()) * _t5_gelu(
            hc @ self.ffn.gate[0].weight.to(cd).t())
        ff = ff @ self.ffn.fc2.weight.to(cd).t()
        return x + ff.float()


def _t5_gelu(x: torch.Tensor) -> torch.Tensor:
    """The reference's tanh-approx GELU (t5.py:46-50)."""
    return 0.5 * x * (1.0 + torch.tanh(
        math.sqrt(2.0 / math.pi) * (x + 0.044715 * torch.pow(x, 3.0))))


def _t5_attention(blk: T5SelfAttention, x, mask_bias, buckets,
                  cfg: T5Config, cd: torch.dtype) -> torch.Tensor:
    b, l, _ = x.shape
    n = cfg.num_heads
    hd = cfg.dim_attn // n
    a = blk.attn
    xc = x.to(cd)
    q = (xc @ a.q.weight.to(cd).t()).reshape(b, l, n, hd)
    k = (xc @ a.k.weight.to(cd).t()).reshape(b, l, n, hd)
    v = (xc @ a.v.weight.to(cd).t()).reshape(b, l, n, hd)
    pos_bias = blk.pos_embedding.embedding.weight[buckets]    # [L, L, N]
    pos_bias = pos_bias.permute(2, 0, 1)[None].float()        # [1, N, L, L]
    logits = torch.einsum("binc,bjnc->bnij", q.float(), k.float())
    logits = logits + pos_bias + mask_bias
    attn = torch.softmax(logits, dim=-1).to(cd)
    y = torch.einsum("bnij,bjnc->binc", attn.float(), v.float())
    y = y.reshape(b, l, n * hd).to(cd)
    return y @ a.o.weight.to(cd).t()


class T5Encoder(nn.Module):
    """umT5 encoder with the reference module tree (t5.py:277-321)."""

    def __init__(self, cfg: T5Config):
        super().__init__()
        self.cfg = cfg
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.dim)
        self.blocks = nn.ModuleList(
            [T5SelfAttention(cfg) for _ in range(cfg.num_layers)])
        self.norm = T5LayerNorm(cfg.dim)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """The JAX init_t5_encoder's scales (reference t5.py:27-43)."""
        cfg = self.cfg
        d, da, dff, n = cfg.dim, cfg.dim_attn, cfg.dim_ffn, cfg.num_heads
        self.token_embedding.weight.normal_(0.0, 1.0, generator=generator)
        self.norm.weight.fill_(1.0)
        for blk in self.blocks:
            blk.norm1.weight.fill_(1.0)
            blk.norm2.weight.fill_(1.0)
            for w, std in ((blk.attn.q.weight, (d * da) ** -0.5),
                           (blk.attn.k.weight, d ** -0.5),
                           (blk.attn.v.weight, d ** -0.5),
                           (blk.attn.o.weight, (n * da) ** -0.5),
                           (blk.pos_embedding.embedding.weight,
                            (2 * cfg.num_buckets * n) ** -0.5),
                           (blk.ffn.gate[0].weight, d ** -0.5),
                           (blk.ffn.fc1.weight, d ** -0.5),
                           (blk.ffn.fc2.weight, dff ** -0.5)):
                w.normal_(0.0, std, generator=generator)

    def forward(self, ids: torch.Tensor, mask: Optional[torch.Tensor],
                compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
        """[B, L] ids (+ [B, L] mask, 1 = valid) -> [B, L, dim] fp32
        (JAX t5_encode)."""
        cfg = self.cfg
        b, l = ids.shape
        dev = self.token_embedding.weight.device
        ids = ids.to(device=dev, dtype=torch.long).clamp(0, cfg.vocab_size - 1)
        x = self.token_embedding.weight[ids].float()
        buckets = torch.from_numpy(relative_position_buckets(
            l, l, cfg.num_buckets, cfg.max_dist, bidirectional=True)
        ).to(device=dev, dtype=torch.long)
        if mask is not None:
            mask = mask.to(dev)
            mask_bias = torch.where(
                mask[:, None, None, :] > 0,
                torch.zeros((), dtype=torch.float32, device=dev),
                torch.full((), -1e30, dtype=torch.float32, device=dev))
        else:
            mask_bias = torch.zeros((b, 1, 1, l), dtype=torch.float32,
                                    device=dev)
        for blk in self.blocks:
            x = blk(x, mask_bias, buckets, cfg, compute_dtype)
        x = rms_norm(x, self.norm.weight, eps=1e-6)
        if mask is not None:
            x = x * (mask[:, :, None] > 0)
        return x


def build_t5_encoder(cfg: T5Config, device, dtype: torch.dtype,
                     seed: Optional[int] = 0) -> T5Encoder:
    """Allocate the encoder straight on `device` in `dtype`; fill it from
    a generator seeded with `seed` when one is given."""
    with torch.device("meta"):
        enc = T5Encoder(cfg)
    enc = enc.to(dtype).to_empty(device=device)
    if seed is not None:
        enc.init_weights(torch.Generator(device=device).manual_seed(seed))
    return enc.eval().requires_grad_(False)


T5_CHECKPOINT = "models_t5_umt5-xxl-enc-bf16.pth"


def load_t5_encoder(cfg: T5Config, ckpt_dir: Optional[str], device,
                    dtype: torch.dtype, seed: int = 0) -> T5Encoder:
    """The encoder of `ckpt_dir`'s umT5 file (reference names, loaded
    strictly) when the directory has one, else a random one from `seed`
    (JAX `T5TextEncoder`'s rule, models/t5.py:199-212)."""
    import os
    path = os.path.join(ckpt_dir, T5_CHECKPOINT) if ckpt_dir else None
    if path and os.path.exists(path):
        from omnihuman_tpu_torch.utils.convert import load_torch_state_dict
        enc = build_t5_encoder(cfg, device, dtype, seed=None)
        enc.load_state_dict(load_torch_state_dict(path), strict=True)
        return enc
    return build_t5_encoder(cfg, device, dtype, seed=seed)


class T5TextEncoder:
    """Tokenizer + umT5 (bf16) with a prompt cache (JAX `models/t5.py:
    T5TextEncoder`), for callers that need text contexts without a
    generation pipeline (the omni trainer). Weights from `ckpt_dir`'s umT5
    file or random from seed 0 (`load_t5_encoder`); captions that recur
    hit the host cache instead of the encoder."""

    CACHE_SIZE = 4096     # prompts kept on the host

    def __init__(self, cfg: T5Config, text_len: int,
                 tokenizer_name: str = "google/umt5-xxl",
                 ckpt_dir: Optional[str] = None, device="cpu"):
        from omnihuman_tpu_torch.models.tokenizers import HuggingfaceTokenizer
        self.device = torch.device(device)
        self.tokenizer = HuggingfaceTokenizer(
            name=tokenizer_name, seq_len=text_len, clean="whitespace")
        self.encoder = load_t5_encoder(cfg, ckpt_dir, self.device,
                                       torch.bfloat16, seed=0)
        self._cache: dict = {}

    def __call__(self, prompts) -> torch.Tensor:
        """[str, ...] -> [B, text_len, dim] fp32 context on the device."""
        return self.encode(prompts)[0]

    @torch.no_grad()
    def encode(self, prompts):
        """[str, ...] -> (context [B, text_len, dim] fp32, lens [B] int32,
        the true token counts), both on the device. The cache is on the
        host, as JAX keeps it."""
        missing = [p for p in dict.fromkeys(prompts) if p not in self._cache]
        if missing:
            ids, mask = self.tokenizer(missing, return_mask=True)
            ctx = self.encoder(torch.from_numpy(ids).to(self.device),
                               torch.from_numpy(mask).to(self.device))
            lens = mask.sum(axis=1).astype(np.int32)
            for p, c, n in zip(missing, ctx.cpu(), lens):
                self._cache[p] = (c, int(n))
            if len(self._cache) > self.CACHE_SIZE:
                keep = set(prompts)
                for p in [p for p in self._cache if p not in keep]:
                    del self._cache[p]
                    if len(self._cache) <= self.CACHE_SIZE:
                        break
        ctx = torch.stack([self._cache[p][0] for p in prompts]).to(
            self.device)
        lens = torch.tensor([self._cache[p][1] for p in prompts],
                            dtype=torch.int32, device=self.device)
        return ctx, lens
