"""The Wan 2.1 DiT, t2v and i2v, in plain fp32 (reference
wan/modules/model.py: WanModel, WanAttentionBlock, the t2v and i2v
cross-attentions, MLPProj, Head, rope_apply, sinusoidal_embedding_1d).

`sd` is the state dict under the reference parameter names, as the
benchmark made it (bf16 on the card); every weight is cast to fp32 where
it is used, one layer at a time. One sample at a time: the valid tokens
only (the padding the program adds is masked there and absent here), the
text keys cut to the sample's length.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from benchmark.reference.common import (
    Linear, attention, attention_grad, gelu_tanh, layer_norm, rms_norm)


def first_frame_mask(frame_num: int, lat_h: int, lat_w: int,
                     device) -> torch.Tensor:
    """The i2v conditioning mask [4, F_lat, h, w]: the first frame known,
    repeated 4 times, then every 4 frames folded into one latent frame
    (reference image2video.py)."""
    msk = torch.zeros((frame_num + 3, lat_h, lat_w), device=device)
    msk[:4] = 1.0
    return msk.reshape(-1, 4, lat_h, lat_w).transpose(0, 1)


def sinusoidal_embedding(dim: int, t: torch.Tensor) -> torch.Tensor:
    """[B] -> [B, dim]: cat(cos, sin) of t * 10000^(-j / (dim/2)), float64
    as the reference computes it, returned in fp32."""
    half = dim // 2
    freqs = torch.pow(torch.tensor(10000.0, dtype=torch.float64,
                                   device=t.device),
                      -torch.arange(half, dtype=torch.float64,
                                    device=t.device) / half)
    s = torch.outer(t.double(), freqs)
    return torch.cat([torch.cos(s), torch.sin(s)], dim=1).float()


def rope_angles(d: int, f: int, h: int, w: int, device,
                theta: float = 10000.0) -> torch.Tensor:
    """[f*h*w, d/2] float64 angles of the 3-axis RoPE: the head dim split
    (d - 4(d//6), 2(d//6), 2(d//6)) over (frame, row, column)."""
    def axis(dim, n):
        inv = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float64),
                              torch.arange(0, dim, 2, dtype=torch.float64)
                              / dim)
        return torch.outer(torch.arange(n, dtype=torch.float64), inv)

    a_f = axis(d - 4 * (d // 6), f)
    a_h = axis(2 * (d // 6), h)
    a_w = axis(2 * (d // 6), w)
    ang = torch.cat([
        a_f[:, None, None, :].expand(f, h, w, -1),
        a_h[None, :, None, :].expand(f, h, w, -1),
        a_w[None, None, :, :].expand(f, h, w, -1)], dim=-1)
    return ang.reshape(f * h * w, d // 2).to(device)


def rope_apply(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    """x [L, N, D]: adjacent pairs as complex numbers times e^(i angle),
    in float64 (reference rope_apply)."""
    l, n, d = x.shape
    xc = torch.view_as_complex(x.double().reshape(l, n, d // 2, 2))
    rot = torch.polar(torch.ones_like(ang), ang)[:, None, :]
    return torch.view_as_real(xc * rot).reshape(l, n, d).float()


def _self_attn(sd, p, x, ang, m, lin, attn):
    n = m["num_heads"]
    d = m["dim"] // n
    q = rms_norm(lin(x, sd[p + "q.weight"], sd[p + "q.bias"]),
                 sd[p + "norm_q.weight"], m["eps"])
    k = rms_norm(lin(x, sd[p + "k.weight"], sd[p + "k.bias"]),
                 sd[p + "norm_k.weight"], m["eps"])
    v = lin(x, sd[p + "v.weight"], sd[p + "v.bias"])
    l = x.shape[0]
    q = rope_apply(q.reshape(l, n, d), ang)
    k = rope_apply(k.reshape(l, n, d), ang)
    y = attn(q, k, v.reshape(l, n, d)).reshape(l, n * d)
    return lin(y, sd[p + "o.weight"], sd[p + "o.bias"])


def _cross_attn(sd, p, x, ctx, ctx_img, m, lin, attn):
    n = m["num_heads"]
    d = m["dim"] // n
    l = x.shape[0]
    q = rms_norm(lin(x, sd[p + "q.weight"], sd[p + "q.bias"]),
                 sd[p + "norm_q.weight"], m["eps"]).reshape(l, n, d)
    k = rms_norm(lin(ctx, sd[p + "k.weight"], sd[p + "k.bias"]),
                 sd[p + "norm_k.weight"], m["eps"])
    v = lin(ctx, sd[p + "v.weight"], sd[p + "v.bias"])
    lc = ctx.shape[0]
    y = attn(q, k.reshape(lc, n, d), v.reshape(lc, n, d))
    if ctx_img is not None:
        ki = rms_norm(lin(ctx_img, sd[p + "k_img.weight"],
                          sd[p + "k_img.bias"]),
                      sd[p + "norm_k_img.weight"], m["eps"])
        vi = lin(ctx_img, sd[p + "v_img.weight"], sd[p + "v_img.bias"])
        li = ctx_img.shape[0]
        y = y + attn(q, ki.reshape(li, n, d), vi.reshape(li, n, d))
    return lin(y.reshape(l, n * d), sd[p + "o.weight"], sd[p + "o.bias"])


def _block(xs, sd, p, ctx, ctx_img, ang, e0, m, lin, attn):
    """One attention block (reference WanAttentionBlock.forward)."""
    dim, eps = m["dim"], m["eps"]
    mod = sd[p + "modulation"].float().reshape(6, dim) + e0
    hx = layer_norm(xs, eps=eps) * (1 + mod[1]) + mod[0]
    xs = xs + _self_attn(sd, p + "self_attn.", hx, ang, m, lin,
                         attn) * mod[2]
    hx = layer_norm(xs, sd[p + "norm3.weight"], sd[p + "norm3.bias"], eps)
    xs = xs + _cross_attn(sd, p + "cross_attn.", hx, ctx, ctx_img, m, lin,
                          attn)
    hx = layer_norm(xs, eps=eps) * (1 + mod[4]) + mod[3]
    hx = lin(hx, sd[p + "ffn.0.weight"], sd[p + "ffn.0.bias"])
    hx = lin(gelu_tanh(hx), sd[p + "ffn.2.weight"], sd[p + "ffn.2.bias"])
    return xs + hx * mod[5]


def dit_forward(sd: dict, m: dict, x: torch.Tensor, t: float,
                context: torch.Tensor, text_len: int,
                y: Optional[torch.Tensor] = None,
                clip_fea: Optional[torch.Tensor] = None,
                fp8: bool = False, train: bool = False) -> torch.Tensor:
    """Velocity of one sample: x [C, F, H, W] at timestep t, context
    [>= text_len, text_dim] (its first text_len rows valid); i2v: y
    [C', F, H, W] (mask + reference latent) and clip_fea [257, clip_dim].
    Returns [out_dim, F, H, W] fp32. `train`: for autograd, every block
    and every block of attention queries checkpointed. `fp8`: the
    training control, the operands of the GEMMs and (with `train`) of the
    attention products in fp8."""
    lin = Linear(fp8)
    dim = m["dim"]
    if y is not None:
        x = torch.cat([x.float(), y.float()], dim=0)
    c, f, h, w = x.shape
    pt, ph, pw = m["patch_size"]
    gf, gh, gw = f // pt, h // ph, w // pw
    l = gf * gh * gw
    # patch embedding: the stride == kernel Conv3d as one matmul over
    # (c, pt, ph, pw)-ordered patches
    patches = x.float().reshape(c, gf, pt, gh, ph, gw, pw).permute(
        1, 3, 5, 0, 2, 4, 6).reshape(l, c * pt * ph * pw)
    pe = sd["patch_embedding.weight"].reshape(dim, -1)
    xs = Linear()(patches, pe, sd["patch_embedding.bias"])

    # time embedding (fp32 as the reference's amp region)
    tt = torch.tensor([t], dtype=torch.float32, device=x.device)
    e = Linear()(sinusoidal_embedding(m["freq_dim"], tt),
                 sd["time_embedding.0.weight"], sd["time_embedding.0.bias"])
    e = Linear()(F.silu(e), sd["time_embedding.2.weight"],
                 sd["time_embedding.2.bias"])
    e0 = Linear()(F.silu(e), sd["time_projection.1.weight"],
                  sd["time_projection.1.bias"]).reshape(6, dim)

    ctx = lin(context[:text_len].float(), sd["text_embedding.0.weight"],
              sd["text_embedding.0.bias"])
    ctx = lin(gelu_tanh(ctx), sd["text_embedding.2.weight"],
              sd["text_embedding.2.bias"])
    ctx_img = None
    if clip_fea is not None:
        ci = layer_norm(clip_fea, sd["img_emb.proj.0.weight"],
                        sd["img_emb.proj.0.bias"], eps=1e-5)
        ci = lin(ci, sd["img_emb.proj.1.weight"], sd["img_emb.proj.1.bias"])
        ci = lin(F.gelu(ci), sd["img_emb.proj.3.weight"],
                 sd["img_emb.proj.3.bias"])
        ctx_img = layer_norm(ci, sd["img_emb.proj.4.weight"],
                             sd["img_emb.proj.4.bias"], eps=1e-5)

    ang = rope_angles(dim // m["num_heads"], gf, gh, gw, x.device)
    attn = functools.partial(attention_grad, fp8=fp8) if train else attention
    for i in range(m["num_layers"]):
        args = (sd, f"blocks.{i}.", ctx, ctx_img, ang, e0, m, lin, attn)
        if train:
            xs = torch.utils.checkpoint.checkpoint(_block, xs, *args,
                                                   use_reentrant=False)
        else:
            xs = _block(xs, *args)

    he = sd["head.modulation"].float().reshape(2, dim) + e
    out = layer_norm(xs, eps=m["eps"]) * (1 + he[1]) + he[0]
    out = Linear()(out, sd["head.head.weight"], sd["head.head.bias"])
    co = m["out_dim"]
    out = out.reshape(gf, gh, gw, pt, ph, pw, co).permute(6, 0, 3, 1, 4, 2, 5)
    return out.reshape(co, gf * pt, gh * ph, gw * pw)

