"""OmniHuman conditioned DiT (port of omnihuman_tpu/omni/model.py).

The Wan DiT with four conditions (reference README.md:117-154):
  - audio: features [B, T, audio_dim] -> MLP (Linear, SiLU, Linear) ->
    adjacent-frame concat and merge -> tokens for the zero-init gated
    audio cross-attention in every block (models/wan_dit.py AudioAdapter);
  - pose: heatmaps [B, K, F, 2h, 2w] -> the pose guider (three causal
    Conv3d, K -> 128 -> 256 -> dim/4, strides 1, (1,2,2), (1,2,2), fp32)
    -> one feature per DiT patch, tiled over the patch and projected by
    `pose_proj` to a delta ADDED to the video tokens;
  - reference: the VAE latent of the reference image, patch-embedded by
    the same embedding and PACKED after the video tokens;
  - motion: the last latent frames of the previous window, packed the same
    way (long video, README.md:150-154);
  - text: the unchanged Wan cross-attention;
plus a temporal embedding [1, num_frames, dim] added per latent frame.

RoPE time layout of the packed sequence: reference at t = 0, motion at
t = 1..M, video at t = M+1.. (video at 0.. when neither is packed). The
packed length is padded by the DiT's `padded_seq_len` rule; the pad rows
get the identity rotation and are masked. Only the video tokens are
unpatchified.

Condition dropout (`cond_mask`, training) is a multiplicative [B] mask
per condition, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from omnihuman_tpu_torch.configs.wan import DTypePolicy, WanModelConfig
from omnihuman_tpu_torch.models.wan_dit import (
    WanModel, _linear, padded_seq_len)
from omnihuman_tpu_torch.ops.rope import rope_angles_3d


@dataclasses.dataclass(frozen=True)
class OmniModelConfig:
    """Omni-conditions dimensions (JAX OmniModelConfig)."""

    base: WanModelConfig = WanModelConfig()
    audio_dim: int = 1024          # audio feature width
    num_keypoints: int = 308       # Sapiens-308
    num_frames: int = 49           # latent frames of the temporal embedding
    pose_hidden: Tuple[int, int] = (128, 256)

    @property
    def dim(self) -> int:
        return self.base.dim


class OmniConditions(nn.Module):
    """The condition encoders (JAX `init_omni_conditions`)."""

    def __init__(self, cfg: OmniModelConfig):
        super().__init__()
        dim = cfg.dim
        h1, h2 = cfg.pose_hidden
        c4 = dim // 4
        _, ph, pw = cfg.base.patch_size
        self.audio_fc1 = nn.Linear(cfg.audio_dim, dim)
        self.audio_fc2 = nn.Linear(dim, dim)
        self.audio_merge = nn.Linear(2 * dim, dim)
        self.pose_conv1 = nn.Conv3d(cfg.num_keypoints, h1, 3)
        self.pose_conv2 = nn.Conv3d(h1, h2, 3, stride=(1, 2, 2))
        self.pose_conv3 = nn.Conv3d(h2, c4, 3, stride=(1, 2, 2))
        self.pose_proj = nn.Linear(c4 * ph * pw, dim)
        self.temporal_embed = nn.Parameter(torch.zeros(1, cfg.num_frames,
                                                       dim))


class OmniModel(nn.Module):
    """`base`: the WanModel with an audio adapter in every block; `cond`:
    the condition encoders (the JAX params' "base" / "cond")."""

    def __init__(self, cfg: OmniModelConfig):
        super().__init__()
        self.cfg = cfg
        self.base = WanModel(cfg.base, audio_adapters=True)
        self.cond = OmniConditions(cfg)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """The JAX init: the base by the reference rule, each adapter with
        xavier q / k / v, a zero `o` and a gate of 1; xavier audio MLP,
        uniform(+-1/sqrt(27 cin)) pose convs, zero `pose_proj`, and a
        unit-normal / sqrt(dim) temporal embedding."""
        self.base.init_weights(generator)
        for blk in self.base.blocks:
            blk.audio_attn.o.weight.zero_()
            blk.audio_attn.o.bias.zero_()
            blk.audio_attn.gate.fill_(1.0)
        c = self.cond
        for lin in (c.audio_fc1, c.audio_fc2, c.audio_merge):
            fan_out, fan_in = lin.weight.shape
            a = math.sqrt(6.0 / (fan_in + fan_out))
            lin.weight.uniform_(-a, a, generator=generator)
            lin.bias.zero_()
        for conv in (c.pose_conv1, c.pose_conv2, c.pose_conv3):
            a = 1.0 / math.sqrt(conv.in_channels * 27)
            conv.weight.uniform_(-a, a, generator=generator)
            conv.bias.uniform_(-a, a, generator=generator)
        c.pose_proj.weight.zero_()
        c.pose_proj.bias.zero_()
        c.temporal_embed.normal_(0.0, self.cfg.dim ** -0.5,
                                 generator=generator)


def build_omni_model(cfg: OmniModelConfig, device, dtype: torch.dtype,
                     seed: Optional[int] = 0) -> OmniModel:
    """Allocate the omni model straight on `device` in `dtype` and, when
    `seed` is given, fill it by the JAX init from a generator seeded with
    it. Frozen for serving."""
    with torch.device("meta"):
        model = OmniModel(cfg)
    model = model.to(dtype).to_empty(device=device)
    if seed is not None:
        model.init_weights(torch.Generator(device=device).manual_seed(seed))
    return model.eval().requires_grad_(False)


# ---------------------------------------------------------------------------
# condition encoders


def process_audio(cond: OmniConditions, audio: torch.Tensor) -> torch.Tensor:
    """[B, T, audio_dim] -> [B, T, dim] fp32 tokens: the MLP in fp32, then
    each frame concatenated with the next and merged back to dim. The
    last frame pairs with the first (the JAX package's `jnp.roll`, copied
    on purpose)."""
    f32 = torch.float32
    x = F.silu(_linear(cond.audio_fc1, audio, f32))
    x = _linear(cond.audio_fc2, x)
    if x.shape[1] > 1:
        pairs = torch.cat([x, torch.roll(x, -1, dims=1)], dim=-1)
        x = _linear(cond.audio_merge, pairs)
    return x


def _guider_conv(x, conv: nn.Conv3d):
    """Causal 3x3x3 conv in fp32: two zero frames in front, SAME on h / w
    (JAX vae._conv3d, padding 'causal'), then ReLU."""
    x = F.pad(x, (0, 0, 0, 0, 2, 0))
    y = F.conv3d(x, conv.weight.float(), conv.bias.float(),
                 stride=conv.stride, padding=(0, 1, 1))
    return F.relu(y)


def process_pose(cond: OmniConditions, pose: torch.Tensor,
                 patch_size: Tuple[int, int, int]) -> torch.Tensor:
    """[B, K, F, 2h, 2w] heatmaps -> per-patch token deltas [B, F*h'*w',
    dim] fp32: the guider (fp32) reduces 4x spatially to one cell per DiT
    patch, the cell's features are tiled over the patch's ph*pw positions
    and projected by `pose_proj`."""
    x = pose.to(torch.float32)
    for conv in (cond.pose_conv1, cond.pose_conv2, cond.pose_conv3):
        x = _guider_conv(x, conv)
    b, c, f, h, w = x.shape
    _, ph, pw = patch_size
    x = x.permute(0, 2, 3, 4, 1).reshape(b, f * h * w, c)
    return _linear(cond.pose_proj, x.repeat(1, 1, ph * pw))


# ---------------------------------------------------------------------------
# forward


def omni_model_forward(
    model: OmniModel,
    x: torch.Tensor,                   # [B, C, F, H, W] noisy latents
    t: torch.Tensor,                   # [B]
    context: torch.Tensor,             # [B, Lc, text_dim]
    *,
    audio: Optional[torch.Tensor] = None,          # [B, Ta, audio_dim]
    pose: Optional[torch.Tensor] = None,           # [B, K, F, 2h, 2w]
    ref_latent: Optional[torch.Tensor] = None,     # [B, C, 1, H, W]
    motion_latent: Optional[torch.Tensor] = None,  # [B, C, M, H, W]
    cond_mask: Optional[Dict[str, torch.Tensor]] = None,
    context_lens: Optional[torch.Tensor] = None,
    policy: DTypePolicy = DTypePolicy(),
) -> torch.Tensor:
    """Velocity [B, out_dim, F, H, W] fp32 with the omni conditions
    (JAX `omni_model_forward`). `cond_mask`: {"audio" / "pose" /
    "reference": [B] in {0, 1}}."""
    cfg = model.cfg
    base_cfg = cfg.base
    base, cond = model.base, model.cond
    b, _, f, h, w = x.shape
    pt, ph, pw = base_cfg.patch_size
    grid = (f // pt, h // ph, w // pw)
    n_video = grid[0] * grid[1] * grid[2]
    dev = x.device
    if grid[0] > cfg.num_frames:
        raise ValueError(
            f"{grid[0]} latent frames in the window, but the temporal "
            f"embedding has num_frames={cfg.num_frames} rows")

    def mask_of(name):
        if cond_mask is None or name not in cond_mask:
            return None
        return cond_mask[name].reshape(b, 1, 1).to(torch.float32)

    # video tokens (+ pose delta + temporal embedding per latent frame)
    tokens = base.patchify(x, policy)                      # [B, Lv, dim]
    if pose is not None:
        pd = process_pose(cond, pose, base_cfg.patch_size)
        m = mask_of("pose")
        if m is not None:
            pd = pd * m
        tokens = tokens + pd.to(tokens.dtype)
    te = cond.temporal_embed[:, :grid[0]].to(torch.float32)
    tokens = tokens + te.repeat_interleave(grid[1] * grid[2], dim=1)

    # motion, then reference tokens, packed after the video tokens
    extra, tables = [], []
    m_frames = 0
    if motion_latent is not None:
        m_frames = motion_latent.shape[2] // pt
        extra.append(base.patchify(motion_latent, policy))
        tables.append(rope_angles_3d((m_frames, grid[1], grid[2]),
                                     base_cfg.head_dim, time_offset=1,
                                     device=dev))
    if ref_latent is not None:
        ref_tokens = base.patchify(ref_latent, policy)
        m = mask_of("reference")
        if m is not None:
            ref_tokens = ref_tokens * m
        extra.append(ref_tokens)
        tables.append(rope_angles_3d(
            (ref_latent.shape[2] // pt, grid[1], grid[2]),
            base_cfg.head_dim, time_offset=0, device=dev))
    if extra:
        sin_v, cos_v = rope_angles_3d(grid, base_cfg.head_dim,
                                      time_offset=1 + m_frames, device=dev)
        tokens = torch.cat([tokens] + extra, dim=1)
        rope_sin = torch.cat([sin_v] + [s for s, _ in tables], dim=0)
        rope_cos = torch.cat([cos_v] + [c for _, c in tables], dim=0)
    else:
        rope_sin, rope_cos = rope_angles_3d(grid, base_cfg.head_dim,
                                            device=dev)
    n_packed = tokens.shape[1]

    audio_ctx = None
    if audio is not None:
        audio_ctx = process_audio(cond, audio)
        m = mask_of("audio")
        if m is not None:
            audio_ctx = audio_ctx * m

    out, _ = base.body(tokens, t, context, seq_len=padded_seq_len(n_packed),
                       rope_sin=rope_sin, rope_cos=rope_cos,
                       n_tokens=n_packed, context_lens=context_lens,
                       policy=policy, audio_ctx=audio_ctx)
    return base.unpatchify(out[:, :n_video], grid).to(torch.float32)
