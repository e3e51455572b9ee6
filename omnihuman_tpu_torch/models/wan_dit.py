"""Wan 2.1 DiT denoiser, t2v and i2v (port of omnihuman_tpu/models/wan_dit.py).

3D patch-embed -> N attention blocks (self-attention with 3D RoPE,
cross-attention to the text, AdaLN-modulated FFN) -> AdaLN head ->
unpatchify; velocity prediction for flow matching (reference
wan/modules/model.py:377-612).

The modules carry the reference parameter names, so a Wan 2.1 state dict
loads with `load_state_dict`, and the JAX converter
(omnihuman_tpu/utils/convert.py:convert_wan_dit) reads a port state dict
unchanged. The forward follows the JAX package's rounding points: time /
text MLPs, AdaLN and gates in fp32, matmuls in `policy.compute`, the
residual stream in `policy.residual`. Where the JAX code multiplies
mixed dtypes it promotes (bf16 @ fp32 -> fp32); `_linear` does the same
explicitly.

Training (the JAX `remat` and `collect_layers` arguments): `remat=True`
checkpoints every block with `torch.utils.checkpoint` (non-reentrant), an
int g > 1 groups the blocks in segments of g and checkpoints each segment
on top of the per-block checkpoints (JAX's grouped two-level remat,
`:475-507`); `collect_layers` returns the outputs of the listed blocks
beside the velocity, the APT discriminator's taps (`:508-536`). A Python
loop over the blocks stands in for the JAX scan.

i2v (`model_type="i2v"`, reference WanI2VCrossAttention and MLPProj): the
conditioning y (mask + reference latent) is concatenated to the latent
channels before patchify; `img_emb` projects the CLIP tokens (LayerNorm,
Linear, exact GELU, Linear, LayerNorm, fp32), which are prepended to the
text context; the cross-attention splits them off again, attends to them
through `k_img` / `v_img` / `norm_k_img` with no lengths, and adds that
output to the text attention's. `context_lens` masks the text keys alone,
as the reference does: the JAX package adds `clip_tokens` to it
(wan_dit.py:467-468) and so leaves every text mask 257 keys too long
(ROADMAP queue C); the port does not copy that.

OmniHuman (omni/model.py): `WanModel(cfg, audio_adapters=True)` gives
every block an `audio_attn` adapter (AudioAdapter: LayerNorm, a t2v-style
cross-attention to the audio tokens with no lengths, a scalar gate), run
after the text cross-attention when `body` is given `audio_ctx` (JAX
`_block_forward`, wan_dit.py:291-303). `_linear` takes the int8 serving
weights of ops/quant.py (`Int8Linear`) as well as nn.Linear.

Sequence parallelism (JAX `attn_impl` and `token_sharding`): with
`token_sharding` (the 1-D `mesh["sp"]`), `body` keeps this rank's
contiguous 1/sp of the padded tokens and of the RoPE rows (seq_lens stays
global), the self-attention runs as `attn_impl` "ring" or "ulysses" and
every cross-attention (text, i2v image, audio) as "sp_cross"
(ops/ring_attention.py), and the head output (and any taps) is gathered
over sp before it is returned. The blocks are called as modules
(`WanAttentionBlock.forward`), so FSDP2's per-block hooks
(parallel/partition.py) gather and free their parameters.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from omnihuman_tpu_torch.configs.wan import DTypePolicy, WanModelConfig
from omnihuman_tpu_torch.ops.attention import flash_attention
from omnihuman_tpu_torch.ops.block_norm import add_norm
from omnihuman_tpu_torch.ops.norms import layer_norm
from omnihuman_tpu_torch.ops.qk_norm_rope import qk_norm_rope
from omnihuman_tpu_torch.ops.quant import Int8Linear, int8_linear
from omnihuman_tpu_torch.parallel.partition import gather_tokens, shard_tokens
from omnihuman_tpu_torch.utils.spans import span


def padded_seq_len(n_tokens: int, sp: int = 1) -> int:
    """The token length the DiT runs at (JAX `seq_len_for`): a multiple of
    the sp degree, and for long sequences of lcm(sp, 1024), the block of
    the JAX flash kernel, so both packages see the same token counts (the
    padding is masked through seq_lens)."""
    sp = max(int(sp), 1)
    align = math.lcm(sp, 1024) if n_tokens >= 4096 else sp
    return int(math.ceil(n_tokens / align) * align)


def _linear(lin: nn.Linear, x: torch.Tensor,
            compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x @ W^T + b in `compute_dtype`, or else in the promoted dtype of x
    and W (what `x @ w + b` does in JAX). An Int8Linear runs the W8A8
    product and returns the dtype of x (after the cast to
    `compute_dtype`), as the JAX `_linear` does on int8 weights."""
    if isinstance(lin, Int8Linear):
        return int8_linear(lin, x if compute_dtype is None
                           else x.to(compute_dtype))
    dt = (compute_dtype if compute_dtype is not None
          else torch.promote_types(x.dtype, lin.weight.dtype))
    b = None if lin.bias is None else lin.bias.to(dt)
    return F.linear(x.to(dt), lin.weight.to(dt), b)


def sinusoidal_embedding_1d(dim: int, position: torch.Tensor) -> torch.Tensor:
    """[B] -> [B, dim] fp32, cat(cos, sin) (reference model.py:17-27)."""
    half = dim // 2
    pos = position.to(torch.float32)
    freqs = torch.pow(
        torch.tensor(10000.0, dtype=torch.float32, device=pos.device),
        -torch.arange(half, dtype=torch.float32, device=pos.device) / half)
    sinusoid = pos[:, None] * freqs[None, :]
    return torch.cat([torch.cos(sinusoid), torch.sin(sinusoid)], dim=-1)


class WanRMSNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))


class WanAttention(nn.Module):
    """q/k/v/o projections + qk RMSNorm weights; the i2v cross-attention
    adds the image keys / values `k_img`, `v_img`, `norm_k_img`."""

    def __init__(self, dim: int, i2v: bool = False):
        super().__init__()
        self.q = nn.Linear(dim, dim)
        self.k = nn.Linear(dim, dim)
        self.v = nn.Linear(dim, dim)
        self.o = nn.Linear(dim, dim)
        self.norm_q = WanRMSNorm(dim)
        self.norm_k = WanRMSNorm(dim)
        if i2v:
            self.k_img = nn.Linear(dim, dim)
            self.v_img = nn.Linear(dim, dim)
            self.norm_k_img = WanRMSNorm(dim)


class AudioAdapter(WanAttention):
    """OmniHuman's audio injection in one block (JAX omni/model.py:102):
    `norm` (affine LayerNorm), the q / k / v / o projections with the
    `norm_q` / `norm_k` RMS weights, and a scalar `gate`. The reference
    init zeroes `o` and sets the gate to 1, so the adapter starts as a
    no-op."""

    def __init__(self, dim: int, eps: float):
        super().__init__(dim)
        self.norm = nn.LayerNorm(dim, eps=eps, elementwise_affine=True)
        self.gate = nn.Parameter(torch.ones(()))


class WanAttentionBlock(nn.Module):
    def __init__(self, cfg: WanModelConfig, audio_adapter: bool = False):
        super().__init__()
        dim = cfg.dim
        self.self_attn = WanAttention(dim)
        if cfg.cross_attn_norm:
            self.norm3 = nn.LayerNorm(dim, eps=cfg.eps,
                                      elementwise_affine=True)
        self.cross_attn = WanAttention(dim, i2v=cfg.model_type == "i2v")
        self.ffn = nn.Sequential(nn.Linear(dim, cfg.ffn_dim),
                                 nn.GELU(approximate="tanh"),
                                 nn.Linear(cfg.ffn_dim, dim))
        self.modulation = nn.Parameter(torch.zeros(1, 6, dim))
        if audio_adapter:
            self.audio_attn = AudioAdapter(dim, cfg.eps)

    def forward(self, x, *args, **kwargs):
        """`_block_forward(self, x, ...)`: FSDP2's hooks run around it."""
        return _block_forward(self, x, *args, **kwargs)


class MLPProj(nn.Module):
    """`img_emb`: CLIP tokens [B, 257, clip_embed_dim] -> [B, 257, dim]."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.proj = nn.Sequential(nn.LayerNorm(cin), nn.Linear(cin, cin),
                                  nn.GELU(), nn.Linear(cin, cout),
                                  nn.LayerNorm(cout))


class Head(nn.Module):
    def __init__(self, cfg: WanModelConfig):
        super().__init__()
        self.head = nn.Linear(cfg.dim,
                              math.prod(cfg.patch_size) * cfg.out_dim)
        self.modulation = nn.Parameter(torch.zeros(1, 2, cfg.dim))


def _self_attention(p: WanAttention, x, rope_sin, rope_cos, seq_lens,
                    cfg: WanModelConfig, policy: DTypePolicy,
                    attn_impl: str = "auto"):
    b, s, _ = x.shape
    n, d = cfg.num_heads, cfg.head_dim
    cd = policy.compute
    xc = x.to(cd)
    q, k = qk_norm_rope(_linear(p.q, xc), _linear(p.k, xc), p.norm_q.weight,
                        p.norm_k.weight, rope_sin, rope_cos, eps=cfg.eps)
    v = _linear(p.v, xc)
    y = flash_attention(q.reshape(b, s, n, d), k.reshape(b, s, n, d),
                        v.reshape(b, s, n, d), k_lens=seq_lens,
                        window_size=cfg.window_size, dtype=cd,
                        implementation=attn_impl)
    return _linear(p.o, y.reshape(b, s, n * d).to(cd))


def _cross_attention(p: WanAttention, x, context, context_lens,
                     cfg: WanModelConfig, policy: DTypePolicy,
                     attn_impl: str = "auto"):
    """Queries of x (this rank's token shard under sp) against the whole
    short context: with a sequence-parallel self-attention, "sp_cross"
    (JAX wan_dit.py:209-214)."""
    if attn_impl in ("ring", "ulysses"):
        attn_impl = "sp_cross"
    b, s, _ = x.shape
    n, d = cfg.num_heads, cfg.head_dim
    cd = policy.compute
    xc = x.to(cd)
    ctx = context.to(cd)
    i2v = cfg.model_type == "i2v"
    if i2v:                       # image tokens first (model.py:211-229)
        ti = cfg.clip_tokens
        ctx_img, ctx = ctx[:, :ti], ctx[:, ti:]
    lc = ctx.shape[1]
    q, k = qk_norm_rope(_linear(p.q, xc), _linear(p.k, ctx), p.norm_q.weight,
                        p.norm_k.weight, eps=cfg.eps)
    q = q.reshape(b, s, n, d)
    v = _linear(p.v, ctx)
    y = flash_attention(q, k.reshape(b, lc, n, d), v.reshape(b, lc, n, d),
                        k_lens=context_lens, dtype=cd,
                        implementation=attn_impl)
    if i2v:
        k_img, _ = qk_norm_rope(_linear(p.k_img, ctx_img), None,
                                p.norm_k_img.weight, eps=cfg.eps)
        v_img = _linear(p.v_img, ctx_img)
        y = y + flash_attention(q, k_img.reshape(b, ti, n, d),
                                v_img.reshape(b, ti, n, d), dtype=cd,
                                implementation=attn_impl)
    return _linear(p.o, y.reshape(b, s, n * d).to(cd))


def _block_forward(blk: WanAttentionBlock, x, e0, context, context_lens,
                   rope_sin, rope_cos, seq_lens, cfg: WanModelConfig,
                   policy: DTypePolicy, audio_ctx=None,
                   attn_impl: str = "auto"):
    """One transformer block (reference model.py:279-330); x in
    policy.residual, e0 [B, 6, dim] fp32. With `audio_ctx` [B, La, dim]
    and an adapter in the block, the gated audio cross-attention follows
    the text cross-attention (JAX wan_dit.py:291-303). Each residual site
    (the gated add, then the LayerNorm and its affine or AdaLN
    modulation) is one `add_norm` (ops/block_norm.py), whose `h` comes in
    policy.compute, where the next product rounds it."""
    with span("block", layer=blk.layer):
        f32 = torch.float32
        e = blk.modulation.to(f32) + e0                          # [B, 6, dim]
        sa_shift, sa_scale, sa_gate, ff_shift, ff_scale, ff_gate = (
            e[:, i:i + 1] for i in range(6))
        site = dict(eps=cfg.eps, h_dtype=policy.compute)

        _, h = add_norm(x, shift=sa_shift, scale=sa_scale, **site)
        with span("self_attn"):
            y = _self_attention(blk.self_attn, h, rope_sin, rope_cos, seq_lens,
                                cfg, policy, attn_impl)

        if cfg.cross_attn_norm:
            x, h = add_norm(x, y, sa_gate, weight=blk.norm3.weight,
                            bias=blk.norm3.bias, **site)
        else:
            x, _ = add_norm(x, y, sa_gate, norm=False)
            h = x
        with span("cross_attn"):
            y = _cross_attention(blk.cross_attn, h, context, context_lens, cfg,
                                 policy, attn_impl)

        ap = getattr(blk, "audio_attn", None)
        if audio_ctx is not None and ap is not None:
            x, h = add_norm(x, y, weight=ap.norm.weight, bias=ap.norm.bias,
                            **site)
            # the t2v branch even on an i2v base: no image tokens in audio
            t2v = dataclasses.replace(cfg, model_type="t2v")
            with span("audio_attn"):
                y = _cross_attention(ap, h, audio_ctx, None, t2v, policy,
                                     attn_impl)
            x, h = add_norm(x, y, ap.gate.to(f32), round_inner=False,
                            shift=ff_shift, scale=ff_scale, **site)
        else:
            x, h = add_norm(x, y, shift=ff_shift, scale=ff_scale, **site)

        with span("ffn"):
            h = _linear(blk.ffn[0], h)
            h = F.gelu(h, approximate="tanh")
            h = _linear(blk.ffn[2], h)
        x, _ = add_norm(x, h, ff_gate, norm=False)
        return x


class WanModel(nn.Module):
    """The t2v / i2v DiT with the reference module tree
    (model.py:377-489)."""

    def __init__(self, cfg: WanModelConfig, audio_adapters: bool = False):
        super().__init__()
        if cfg.model_type not in ("t2v", "i2v"):
            raise ValueError(f"unknown model_type {cfg.model_type!r}")
        self.cfg = cfg
        dim = cfg.dim
        self.patch_embedding = nn.Conv3d(cfg.in_dim, dim,
                                         kernel_size=cfg.patch_size,
                                         stride=cfg.patch_size)
        self.text_embedding = nn.Sequential(
            nn.Linear(cfg.text_dim, dim), nn.GELU(approximate="tanh"),
            nn.Linear(dim, dim))
        self.time_embedding = nn.Sequential(
            nn.Linear(cfg.freq_dim, dim), nn.SiLU(), nn.Linear(dim, dim))
        self.time_projection = nn.Sequential(nn.SiLU(),
                                             nn.Linear(dim, dim * 6))
        self.blocks = nn.ModuleList(
            [WanAttentionBlock(cfg, audio_adapter=audio_adapters)
             for _ in range(cfg.num_layers)])
        for i, blk in enumerate(self.blocks):
            blk.layer = i                 # the `block` span's attribute
        self.head = Head(cfg)
        if cfg.model_type == "i2v":
            self.img_emb = MLPProj(cfg.clip_embed_dim, dim)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Reference init_weights (model.py:590-612): xavier-uniform
        linears (img_emb's too) and patch embedding, normal(0.02) text /
        time embeddings, zero head, unit-normal / sqrt(dim) modulation
        tables, unit norms."""
        def xavier(w):
            fan_out, fan_in = w.shape[0], math.prod(w.shape[1:])
            a = math.sqrt(6.0 / (fan_in + fan_out))
            w.uniform_(-a, a, generator=generator)

        for m in self.modules():
            if isinstance(m, nn.Linear):
                xavier(m.weight)
                m.bias.zero_()
            elif isinstance(m, (WanRMSNorm, nn.LayerNorm)):
                m.weight.fill_(1.0)
                if getattr(m, "bias", None) is not None:
                    m.bias.zero_()
        xavier(self.patch_embedding.weight)
        self.patch_embedding.bias.zero_()
        for seq in (self.text_embedding, self.time_embedding):
            for m in seq:
                if isinstance(m, nn.Linear):
                    m.weight.normal_(0.0, 0.02, generator=generator)
        dim = self.cfg.dim
        for blk in self.blocks:
            blk.modulation.normal_(0.0, dim ** -0.5, generator=generator)
        self.head.modulation.normal_(0.0, dim ** -0.5, generator=generator)
        self.head.head.weight.zero_()
        self.head.head.bias.zero_()

    # -- forward pieces -----------------------------------------------------

    def patchify(self, x: torch.Tensor, policy: DTypePolicy) -> torch.Tensor:
        """[B, C, F, H, W] -> [B, L, dim] fp32: the stride == kernel Conv3d
        as one GEMM over (c, pt, ph, pw)-ordered patch vectors."""
        b, c, f, h, w = x.shape
        pt, ph, pw = self.cfg.patch_size
        x = x.reshape(b, c, f // pt, pt, h // ph, ph, w // pw, pw)
        x = x.permute(0, 2, 4, 6, 1, 3, 5, 7)
        x = x.reshape(b, (f // pt) * (h // ph) * (w // pw), c * pt * ph * pw)
        pe = self.patch_embedding
        dt = torch.promote_types(policy.compute, pe.weight.dtype)
        y = F.linear(x.to(policy.compute).to(dt),
                     pe.weight.reshape(pe.weight.shape[0], -1).to(dt),
                     pe.bias.to(dt))
        return y.to(torch.float32)

    def unpatchify(self, x: torch.Tensor, grid) -> torch.Tensor:
        """[B, L, prod(patch)*out] -> [B, out, F, H, W] (model.py:565-588)."""
        b = x.shape[0]
        f, h, w = grid
        pt, ph, pw = self.cfg.patch_size
        c = self.cfg.out_dim
        x = x[:, :f * h * w].reshape(b, f, h, w, pt, ph, pw, c)
        x = x.permute(0, 7, 1, 4, 2, 5, 3, 6)
        return x.reshape(b, c, f * pt, h * ph, w * pw)

    def body(self, tokens, t, context, *, seq_len: int, rope_sin, rope_cos,
             n_tokens: int, context_lens=None, clip_fea=None,
             policy: DTypePolicy = DTypePolicy(), remat=False,
             collect_layers: Optional[Sequence[int]] = None,
             audio_ctx=None, attn_impl: str = "auto", token_sharding=None):
        """The DiT trunk on built tokens (JAX dit_body): pad to seq_len,
        time / text (and, with clip_fea, image) embeddings, blocks (with
        `audio_ctx` [B, La, dim], the audio adapters), modulated head.
        Returns (out [B, seq_len, prod(patch)*out_dim], taps), taps being
        {layer: [B, seq_len, dim] in policy.residual} for collect_layers.
        `token_sharding` (the 1-D sp mesh): the blocks and the head run on
        this rank's 1/sp of the tokens, and the outputs are gathered."""
        cfg, f32 = self.cfg, torch.float32
        b = tokens.shape[0]
        if n_tokens > seq_len:
            raise ValueError(f"{n_tokens} tokens > seq_len {seq_len}")
        x = tokens.to(policy.residual)
        if n_tokens < seq_len:
            x = F.pad(x, (0, 0, 0, seq_len - n_tokens))
        if rope_sin.shape[0] < seq_len:
            pad = seq_len - rope_sin.shape[0]
            rope_sin = F.pad(rope_sin, (0, 0, 0, pad))
            rope_cos = F.pad(rope_cos, (0, 0, 0, pad), value=1.0)
        seq_lens = torch.full((b,), n_tokens, dtype=torch.int32,
                              device=x.device)
        x = shard_tokens(x, token_sharding)
        rope_sin = shard_tokens(rope_sin, token_sharding, dim=0)
        rope_cos = shard_tokens(rope_cos, token_sharding, dim=0)

        # time path, fp32 (model.py:526-528)
        e = sinusoidal_embedding_1d(cfg.freq_dim, t)
        e = _linear(self.time_embedding[0], e, f32)
        e = F.silu(e)
        e = _linear(self.time_embedding[2], e)                # [B, dim]
        e0 = _linear(self.time_projection[1], F.silu(e))
        e0 = e0.reshape(b, 6, cfg.dim)

        # text context MLP, fp32 (model.py:534)
        ctx = _linear(self.text_embedding[0], context, f32)
        ctx = F.gelu(ctx, approximate="tanh")
        ctx = _linear(self.text_embedding[2], ctx)

        if clip_fea is not None:    # i2v image tokens, fp32 (model.py:536)
            pr = self.img_emb.proj
            ci = layer_norm(clip_fea, pr[0].weight, pr[0].bias,
                            out_dtype=f32)
            ci = F.gelu(_linear(pr[1], ci))
            ci = _linear(pr[3], ci)
            ci = layer_norm(ci, pr[4].weight, pr[4].bias, out_dtype=f32)
            ctx = torch.cat([ci, ctx], dim=1)

        x, taps = self._blocks(x, (e0, ctx, context_lens, rope_sin,
                                   rope_cos, seq_lens, cfg, policy,
                                   audio_ctx, attn_impl),
                               remat, collect_layers)

        # head: fp32, two-chunk modulation (model.py:332-359)
        he = self.head.modulation.to(f32) + e[:, None]        # [B, 2, dim]
        h = layer_norm(x, eps=cfg.eps, out_dtype=f32)
        h = h * (1.0 + he[:, 1:2]) + he[:, 0:1]
        out = gather_tokens(_linear(self.head.head, h), token_sharding)
        taps = {i: gather_tokens(v, token_sharding) for i, v in taps.items()}
        return out, taps

    def _blocks(self, x, args, remat, collect_layers):
        """The block loop: plain, per-block checkpointed, grouped, or
        tapped. Checkpointing applies only while autograd records."""
        grouped = (isinstance(remat, int) and not isinstance(remat, bool)
                   and remat > 1 and not collect_layers)
        if grouped and self.cfg.num_layers % remat != 0:
            raise ValueError(f"remat group {remat} must divide num_layers "
                             f"{self.cfg.num_layers}")
        ckpt = bool(remat) and torch.is_grad_enabled()

        def block(i, h):
            if ckpt:
                return torch.utils.checkpoint.checkpoint(
                    self.blocks[i], h, *args, use_reentrant=False)
            return self.blocks[i](h, *args)

        taps: Dict[int, torch.Tensor] = {}
        if grouped:
            def group(first, h):
                for i in range(first, first + remat):
                    h = block(i, h)
                return h

            for first in range(0, self.cfg.num_layers, remat):
                if ckpt:
                    x = torch.utils.checkpoint.checkpoint(
                        group, first, x, use_reentrant=False)
                else:
                    x = group(first, x)
            return x, taps
        wanted = set(int(i) for i in collect_layers or ())
        for i in range(self.cfg.num_layers):
            x = block(i, x)
            if i in wanted:
                taps[i] = x
        return x, taps

    def forward(self, x, t, context, *, seq_len: int, rope_sin, rope_cos,
                context_lens=None, clip_fea=None, y=None,
                policy: DTypePolicy = DTypePolicy(),
                remat=False, collect_layers: Optional[Sequence[int]] = None,
                attn_impl: str = "auto", token_sharding=None):
        """Velocity v = model(x_t, t, context) (JAX wan_model_forward):
        x [B, out_dim, F, H, W], t [B], context [B, Lc, text_dim]; i2v adds
        clip_fea [B, 257, clip_embed_dim] and y [B, in_dim - out_dim, F, H,
        W], concatenated to x on the channels ->
        [B, out_dim, F, H, W] fp32, or (v, {layer: [B, seq_len, dim]})
        when `collect_layers` is given. `remat`: False, True (per block) or
        an int group size (grouped two-level; ignored with
        collect_layers, as in JAX). `attn_impl` / `token_sharding`: the
        sequence-parallel plan (`body`)."""
        if y is not None:           # i2v: mask + reference latent
            x = torch.cat([x, y.to(x.dtype)], dim=1)
        pt, ph, pw = self.cfg.patch_size
        grid = (x.shape[2] // pt, x.shape[3] // ph, x.shape[4] // pw)
        n_tokens = grid[0] * grid[1] * grid[2]
        tokens = self.patchify(x, policy)
        out, taps = self.body(tokens, t, context, seq_len=seq_len,
                              rope_sin=rope_sin, rope_cos=rope_cos,
                              n_tokens=n_tokens, context_lens=context_lens,
                              clip_fea=clip_fea, policy=policy, remat=remat,
                              collect_layers=collect_layers,
                              attn_impl=attn_impl,
                              token_sharding=token_sharding)
        v = self.unpatchify(out, grid).to(torch.float32)
        return (v, taps) if collect_layers is not None else v


def build_wan_model(cfg: WanModelConfig, device, dtype: torch.dtype,
                    seed: Optional[int] = 0,
                    trainable: bool = False) -> WanModel:
    """Allocate the DiT straight on `device` in `dtype` (no host copy) and,
    when `seed` is given, fill it by the reference init from a generator
    seeded with it. Frozen for serving unless `trainable`."""
    with torch.device("meta"):
        model = WanModel(cfg)
    model = model.to(dtype).to_empty(device=device)
    if seed is not None:
        gen = torch.Generator(device=device).manual_seed(seed)
        model.init_weights(gen)
    if trainable:
        return model.train().requires_grad_(True)
    return model.eval().requires_grad_(False)
