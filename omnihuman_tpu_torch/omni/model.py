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
t = 1..M, video at t = M+1.. (video at 0.. when neither is packed); the
tables are built once per geometry and kept on the model. The packed
length is padded by the DiT's `padded_seq_len` rule; the pad rows get
the identity rotation and are masked. Only the video tokens are
unpatchified.

Condition dropout (`cond_mask`, training) is a multiplicative [B] mask
per condition, as in the JAX package.

Spans (utils/spans.py): `pose_guider` (`process_pose`), `audio_proj`
(`process_audio`) and `pack` (the motion and reference patchify, the
RoPE tables, the concatenation; its attributes `tokens` packed, `pad`
rows that `padded_seq_len` adds, `audio_tokens`).
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
from omnihuman_tpu_torch.parallel.mesh import current_mesh, sp_degree
from omnihuman_tpu_torch.parallel.spatial import gather_spatial, halo_exchange
from omnihuman_tpu_torch.utils.spans import span


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
        self.rope_tables: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}

    def forward(self, x, t, context, **kwargs):
        """`omni_model_forward(self, x, t, context, **kwargs)`."""
        return _omni_forward(self, x, t, context, **kwargs)

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
                     seed: Optional[int] = 0,
                     trainable: bool = False) -> OmniModel:
    """Allocate the omni model straight on `device` in `dtype` and, when
    `seed` is given, fill it by the JAX init from a generator seeded with
    it. Frozen for serving unless `trainable`."""
    with torch.device("meta"):
        model = OmniModel(cfg)
    model = model.to(dtype).to_empty(device=device)
    if seed is not None:
        model.init_weights(torch.Generator(device=device).manual_seed(seed))
    if trainable:
        return model.train().requires_grad_(True)
    return model.eval().requires_grad_(False)


def load_base_dit(model: OmniModel, dit_state_dict) -> None:
    """Load a Wan DiT state dict (reference names) into the omni model's
    base (JAX `init_omni_model(base_params=...)`): every DiT key must
    match, and only the audio adapters, which a DiT checkpoint lacks, keep
    their init."""
    missing, unexpected = model.base.load_state_dict(dit_state_dict,
                                                     strict=False)
    stray = [k for k in missing if ".audio_attn." not in k]
    if unexpected or stray:
        raise ValueError(f"DiT state dict does not fit the omni base: "
                         f"missing {stray[:5]}, unexpected {unexpected[:5]}")


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


def _guider_conv(x, conv: nn.Conv3d, spatial=None):
    """Causal 3x3x3 conv in fp32: two zero frames in front, SAME on h / w
    (JAX vae._conv3d, padding 'causal'), then ReLU. On an H shard
    (`spatial`) x takes its H halo instead of H's padding: 1 row on each
    side at stride 1, 1 row above at stride 2 (output row i reads rows
    2i-1 .. 2i+1, and a shard starts on an even row)."""
    x = F.pad(x, (0, 0, 0, 0, 2, 0))
    pad_h = 1
    if spatial is not None:
        x = halo_exchange(x, 3, 1, 1 if conv.stride[1] == 1 else 0, spatial)
        pad_h = 0
    y = F.conv3d(x, conv.weight.float(), conv.bias.float(),
                 stride=conv.stride, padding=(0, pad_h, 1))
    return F.relu(y)


def process_pose(cond: OmniConditions, pose: torch.Tensor,
                 patch_size: Tuple[int, int, int],
                 spatial=None) -> torch.Tensor:
    """[B, K, F, 2h, 2w] heatmaps -> per-patch token deltas [B, F*h'*w',
    dim] fp32: the guider (fp32) reduces 4x spatially to one cell per DiT
    patch, the cell's features are tiled over the patch's ph*pw positions
    and projected by `pose_proj`.

    `spatial`: the group (an sp `DeviceMesh`, a process group or a
    `VirtualRanks` rank, parallel/spatial.py) whose ranks each hold
    `pose`'s rows H/n .. of the heatmaps (`TrainMeshPlan.put_batch`; H a
    multiple of 4n). The guider's convs take H halos, and its output,
    dim/4 channels at the patch grid, is gathered over the group (its
    backward sums the ranks' gradients, the mesh's sp convention) before
    the token path."""
    x = pose.to(torch.float32)
    for conv in (cond.pose_conv1, cond.pose_conv2, cond.pose_conv3):
        x = _guider_conv(x, conv, spatial)
    if spatial is not None:
        x = gather_spatial(x, 3, spatial)
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
    remat=True,
    seq_align: Optional[int] = None,
    pose_sharding=None,
) -> torch.Tensor:
    """Velocity [B, out_dim, F, H, W] fp32 with the omni conditions
    (JAX `omni_model_forward`). `cond_mask`: {"audio" / "pose" /
    "reference": [B] in {0, 1}}. `remat`: False, True (per block, the JAX
    default) or an int group size, as `WanModel.body` takes it; it acts
    only while autograd records. Under a current mesh, the
    sequence-parallel plan of `WanModel.body`; `seq_align`: what the
    packed length is padded to a multiple of (`padded_seq_len`), by
    default the current mesh's sp degree. `pose_sharding`: the group whose
    ranks each hold an H shard of `pose` (`process_pose`), or None for the
    whole heatmaps. The call goes through the model's `__call__`
    (`OmniModel.forward`), so FSDP2's root hooks gather the parameters
    outside the blocks."""
    return model(x, t, context, audio=audio, pose=pose,
                 ref_latent=ref_latent, motion_latent=motion_latent,
                 cond_mask=cond_mask, context_lens=context_lens,
                 policy=policy, remat=remat, seq_align=seq_align,
                 pose_sharding=pose_sharding)


def _packed_rope(model: OmniModel, grid, m_frames: Optional[int],
                 r_frames: Optional[int], device):
    """(sin, cos) [n_packed, head_dim / 2] of the packed sequence (video,
    motion, reference; the time layout of the module docstring), m_frames /
    r_frames None where that part is absent. Built once per geometry and
    kept in `model.rope_tables` (at most 8): `rope_angles_3d` computes in
    float64 numpy and uploads from pageable memory, which waits for the
    card, and every forward of a window asks for the same tables."""
    key = (grid, m_frames, r_frames, device)
    cache = model.rope_tables
    if key not in cache:
        hd = model.cfg.base.head_dim
        rest = tuple(grid[1:])
        if m_frames is None and r_frames is None:
            tables = rope_angles_3d(grid, hd, device=device)
        else:
            parts = [rope_angles_3d(grid, hd, time_offset=1 + (m_frames or 0),
                                    device=device)]
            if m_frames is not None:
                parts.append(rope_angles_3d((m_frames,) + rest, hd,
                                            time_offset=1, device=device))
            if r_frames is not None:
                parts.append(rope_angles_3d((r_frames,) + rest, hd,
                                            time_offset=0, device=device))
            tables = tuple(torch.cat([p[i] for p in parts], dim=0)
                           for i in (0, 1))
        if len(cache) >= 8:
            cache.clear()
        cache[key] = tables
    return cache[key]


def _omni_forward(model: OmniModel, x, t, context, *, audio=None, pose=None,
                  ref_latent=None, motion_latent=None, cond_mask=None,
                  context_lens=None, policy: DTypePolicy = DTypePolicy(),
                  remat=True, seq_align: Optional[int] = None,
                  pose_sharding=None):
    """`omni_model_forward`'s computation (`OmniModel.forward`)."""
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
        with span("pose_guider"):
            pd = process_pose(cond, pose, base_cfg.patch_size,
                              pose_sharding)
        m = mask_of("pose")
        if m is not None:
            pd = pd * m
        tokens = tokens + pd.to(tokens.dtype)
    te = cond.temporal_embed[:, :grid[0]].to(torch.float32)
    tokens = tokens + te.repeat_interleave(grid[1] * grid[2], dim=1)

    # motion, then reference tokens, packed after the video tokens
    m_frames = None if motion_latent is None else motion_latent.shape[2] // pt
    r_frames = None if ref_latent is None else ref_latent.shape[2] // pt
    n_packed = n_video + ((m_frames or 0) + (r_frames or 0)) * (
        grid[1] * grid[2])
    if seq_align is None:
        seq_align = sp_degree(current_mesh())
    seq_len = padded_seq_len(n_packed, seq_align)
    with span("pack", tokens=n_packed, pad=seq_len - n_packed,
              audio_tokens=0 if audio is None else audio.shape[1]):
        extra = []
        if motion_latent is not None:
            extra.append(base.patchify(motion_latent, policy))
        if ref_latent is not None:
            ref_tokens = base.patchify(ref_latent, policy)
            m = mask_of("reference")
            if m is not None:
                ref_tokens = ref_tokens * m
            extra.append(ref_tokens)
        if extra:
            tokens = torch.cat([tokens] + extra, dim=1)
        rope_sin, rope_cos = _packed_rope(model, grid, m_frames, r_frames,
                                          dev)

    audio_ctx = None
    if audio is not None:
        with span("audio_proj"):
            audio_ctx = process_audio(cond, audio)
        m = mask_of("audio")
        if m is not None:
            audio_ctx = audio_ctx * m

    out, _ = base.body(tokens, t, context, seq_len=seq_len,
                       rope_sin=rope_sin, rope_cos=rope_cos,
                       n_tokens=n_packed, context_lens=context_lens,
                       policy=policy, remat=remat, audio_ctx=audio_ctx)
    return base.unpatchify(out[:, :n_video], grid).to(torch.float32)
