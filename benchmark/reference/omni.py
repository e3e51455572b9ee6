"""OmniHuman's conditioned Wan DiT, one sample, in plain fp32.

OmniHuman-1 (Lin et al., arXiv:2502.01061): the omni-conditions scheme,
as the reference repository builds it (johndpope/OmniHuman-1-hack,
README:117-154, Omnihuman/omni_config.yaml) over the Wan 2.1 DiT
(wan/modules/model.py, `reference/dit.py`, whose helpers this file
imports). Per sample:
  - video tokens: the patch embedding of the noisy latent, plus the pose
    delta (the pose guider: three causal 3x3x3 Conv3d with ReLU, K -> 128
    -> 256 -> dim/4, strides 1, (1,2,2), (1,2,2), in fp32; each cell of its
    output, one per DiT patch, repeated over the patch's ph*pw positions
    and projected by `pose_proj`), plus the temporal embedding's row of
    each latent frame;
  - packing: the motion frames' tokens (the previous window's last latent
    frames), then the reference latent's, patch-embedded by the same
    embedding, after the video tokens; 3D RoPE with the time axis
    offset: reference at t = 0, motion at t = 1..M, video at t = M+1..
    (at 0.. when neither is packed);
  - audio tokens: the features through Linear, SiLU, Linear, then each
    frame concatenated with the next and merged back to dim;
  - blocks: Wan's, with a gated audio cross-attention after the text
    cross-attention: an affine LayerNorm, q / k / v / o with q / k RMSNorm
    over every audio token (no lengths), the output times a scalar gate;
  - the head over the video tokens alone.

The valid tokens only (no padding), the text keys cut to the sample's
length, every weight cast to fp32 where it is used, attention in blocks
of queries (`common.attention`), RoPE angles in float64.

Departures from the published description, each the program's too:
  - the audio merge pairs the last frame with the first (a roll), where
    the description pairs each frame with the next and says nothing of
    the last;
  - with motion frames but no reference, t = 0 stays empty (motion at
    1..M), where the description always has a reference;
  - the adapter's `o` and gate and `pose_proj` are whatever the weights
    hold: the reference repository zero-initialises `o` and `pose_proj`,
    which makes audio and pose no-ops until trained.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from benchmark.reference import dit as ref_dit
from benchmark.reference.common import (
    Linear, attention, gelu_tanh, layer_norm)

BASE = "base."
COND = "cond."


def rope_angles(d: int, f: int, h: int, w: int, offset: int,
                device) -> torch.Tensor:
    """[f*h*w, d/2] float64 RoPE angles of a grid whose frames sit at
    t = offset..offset+f-1."""
    return ref_dit.rope_angles(d, offset + f, h, w, device)[offset * h * w:]


def patch_embed(sd: dict, m: dict, x: torch.Tensor) -> torch.Tensor:
    """[C, F, H, W] -> [F/pt * H/ph * W/pw, dim]: the stride == kernel
    Conv3d as one matmul over (c, pt, ph, pw)-ordered patches."""
    c, f, h, w = x.shape
    pt, ph, pw = m["patch_size"]
    gf, gh, gw = f // pt, h // ph, w // pw
    patches = x.float().reshape(c, gf, pt, gh, ph, gw, pw).permute(
        1, 3, 5, 0, 2, 4, 6).reshape(gf * gh * gw, c * pt * ph * pw)
    pe = sd[BASE + "patch_embedding.weight"].reshape(m["dim"], -1)
    return Linear()(patches, pe, sd[BASE + "patch_embedding.bias"])


def pose_delta(sd: dict, m: dict, pose: torch.Tensor) -> torch.Tensor:
    """Heatmaps [K, F, 2h, 2w] -> the video tokens' deltas [F*h/ph*w/pw,
    dim] (fp32 throughout)."""
    x = pose.float()[None]
    for i, s in ((1, 1), (2, 2), (3, 2)):
        x = F.pad(x, (1, 1, 1, 1, 2, 0))        # causal in time, SAME h / w
        x = F.relu(F.conv3d(x, sd[f"{COND}pose_conv{i}.weight"].float(),
                            sd[f"{COND}pose_conv{i}.bias"].float(),
                            stride=(1, s, s)))
    cells = x[0].permute(1, 2, 3, 0).reshape(-1, x.shape[1])
    _, ph, pw = m["patch_size"]
    return Linear()(cells.repeat(1, ph * pw), sd[COND + "pose_proj.weight"],
                    sd[COND + "pose_proj.bias"])


def audio_tokens(sd: dict, audio: torch.Tensor) -> torch.Tensor:
    """Features [T, audio_dim] -> tokens [T, dim]."""
    lin = Linear()
    x = F.silu(lin(audio, sd[COND + "audio_fc1.weight"],
                   sd[COND + "audio_fc1.bias"]))
    x = lin(x, sd[COND + "audio_fc2.weight"], sd[COND + "audio_fc2.bias"])
    if x.shape[0] > 1:
        pairs = torch.cat([x, torch.roll(x, -1, dims=0)], dim=-1)
        x = lin(pairs, sd[COND + "audio_merge.weight"],
                sd[COND + "audio_merge.bias"])
    return x


def _block(xs, p, sd, ctx, audio_ctx, ang, e0, m, lin, attn):
    """One block (Wan's WanAttentionBlock with the audio adapter after the
    text cross-attention)."""
    dim, eps = m["dim"], m["eps"]
    mod = sd[p + "modulation"].float().reshape(6, dim) + e0
    hx = layer_norm(xs, eps=eps) * (1 + mod[1]) + mod[0]
    xs = xs + ref_dit._self_attn(sd, p + "self_attn.", hx, ang, m, lin,
                                 attn) * mod[2]
    hx = layer_norm(xs, sd[p + "norm3.weight"], sd[p + "norm3.bias"], eps)
    xs = xs + ref_dit._cross_attn(sd, p + "cross_attn.", hx, ctx, None, m,
                                  lin, attn)
    if audio_ctx is not None:
        a = p + "audio_attn."
        hx = layer_norm(xs, sd[a + "norm.weight"], sd[a + "norm.bias"], eps)
        xs = xs + ref_dit._cross_attn(sd, a, hx, audio_ctx, None, m, lin,
                                      attn) * sd[a + "gate"].float()
    hx = layer_norm(xs, eps=eps) * (1 + mod[4]) + mod[3]
    hx = lin(hx, sd[p + "ffn.0.weight"], sd[p + "ffn.0.bias"])
    hx = lin(gelu_tanh(hx), sd[p + "ffn.2.weight"], sd[p + "ffn.2.bias"])
    return xs + hx * mod[5]


def omni_forward(sd: dict, m: dict, x: torch.Tensor, t: float,
                 context: torch.Tensor, text_len: int,
                 audio: Optional[torch.Tensor] = None,
                 pose: Optional[torch.Tensor] = None,
                 ref_latent: Optional[torch.Tensor] = None,
                 motion_latent: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """Velocity [out_dim, F, H, W] fp32 of one sample: x [C, F, H, W] at
    timestep t, context [>= text_len, text_dim] (its first text_len rows
    valid); the conditions, each optional: audio [T, audio_dim], pose
    heatmaps [K, F, 2H, 2W], ref_latent [C, 1, H, W], motion_latent [C, M,
    H, W]. `sd`: the omni model's weights under its parameter names
    (`base.` the DiT with its adapters, `cond.` the condition encoders);
    `m`: the DiT's sizes."""
    lin = Linear()
    dim, heads = m["dim"], m["num_heads"]
    d = dim // heads
    pt, ph, pw = m["patch_size"]
    _, f, h, w = x.shape
    gf, gh, gw = f // pt, h // ph, w // pw

    xs = patch_embed(sd, m, x)
    if pose is not None:
        xs = xs + pose_delta(sd, m, pose)
    te = sd[COND + "temporal_embed"].float()[0, :gf]
    xs = xs + te.repeat_interleave(gh * gw, dim=0)

    mf = 0 if motion_latent is None else motion_latent.shape[1] // pt
    packed = motion_latent is not None or ref_latent is not None
    parts = [xs]
    angs = [rope_angles(d, gf, gh, gw, 1 + mf if packed else 0, x.device)]
    if motion_latent is not None:
        parts.append(patch_embed(sd, m, motion_latent))
        angs.append(rope_angles(d, mf, gh, gw, 1, x.device))
    if ref_latent is not None:
        parts.append(patch_embed(sd, m, ref_latent))
        angs.append(rope_angles(d, ref_latent.shape[1] // pt, gh, gw, 0,
                                x.device))
    xs = torch.cat(parts)
    ang = torch.cat(angs)

    tt = torch.tensor([t], dtype=torch.float32, device=x.device)
    e = lin(ref_dit.sinusoidal_embedding(m["freq_dim"], tt),
            sd[BASE + "time_embedding.0.weight"],
            sd[BASE + "time_embedding.0.bias"])
    e = lin(F.silu(e), sd[BASE + "time_embedding.2.weight"],
            sd[BASE + "time_embedding.2.bias"])
    e0 = lin(F.silu(e), sd[BASE + "time_projection.1.weight"],
             sd[BASE + "time_projection.1.bias"]).reshape(6, dim)

    ctx = lin(context[:text_len].float(), sd[BASE + "text_embedding.0.weight"],
              sd[BASE + "text_embedding.0.bias"])
    ctx = lin(gelu_tanh(ctx), sd[BASE + "text_embedding.2.weight"],
              sd[BASE + "text_embedding.2.bias"])
    audio_ctx = None if audio is None else audio_tokens(sd, audio)

    for i in range(m["num_layers"]):
        xs = _block(xs, f"{BASE}blocks.{i}.", sd, ctx, audio_ctx, ang, e0, m,
                    lin, attention)

    n_video = gf * gh * gw
    he = sd[BASE + "head.modulation"].float().reshape(2, dim) + e
    out = layer_norm(xs[:n_video], eps=m["eps"]) * (1 + he[1]) + he[0]
    out = lin(out, sd[BASE + "head.head.weight"], sd[BASE + "head.head.bias"])
    co = m["out_dim"]
    out = out.reshape(gf, gh, gw, pt, ph, pw, co).permute(6, 0, 3, 1, 4, 2, 5)
    return out.reshape(co, gf * pt, gh * ph, gw * pw)
