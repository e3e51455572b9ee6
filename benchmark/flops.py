"""Operations and bytes from shapes: the kernels' roofline bounds and the
models' own arithmetic.

The kernel bounds are the least time an H100 SXM could take for a call:
the larger of its operations over the bf16 tensor-core peak and its bytes
(each input read once, each output written once) over the HBM peak. The
model counts (`*_flops`) are the models' arithmetic whatever kernel runs
it: 2 x the multiply-adds of every matmul for the tokens it sees, plus
attention at 4 x head_dim per (query, valid key, head). Where work depends
on the data they count what the inputs need: valid keys, valid tokens.
"""

from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple

PEAK_BF16_FLOPS = 989e12      # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12          # H100 SXM HBM3


def _bound(flops: float, nbytes: float) -> Tuple[float, str]:
    """(seconds, "operations" | "bytes") of the larger bound."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


# -- kernel bounds ------------------------------------------------------------

def attention_bound(b: int, lq: int, n: int, d: int,
                    k_valid: Sequence[int]) -> Tuple[float, str]:
    """K1, one forward call: Q read and O written once, the valid K / V
    rows read once (bf16); 4 * D FLOP per (query, valid key, head)."""
    keys = sum(k_valid)
    flops = 4.0 * n * lq * d * keys
    nbytes = 2.0 * (2 * b * lq * n * d + 2 * keys * n * d)
    return _bound(flops, nbytes)


def backward_bound(q_rows: int, k_rows: int, pairs: int, n: int,
                   d: int) -> Tuple[float, str]:
    """K2, one backward call: five matmuls (S and dP once, dV, dK, dQ) of
    2 * D FLOP per (query, visible key) pair and head; q, dO, k, v read
    and dq, dk, dv written once (bf16), plus the fp32 LSE and delta."""
    flops = 2.0 * 5 * n * d * pairs
    nbytes = 2.0 * n * d * (3 * q_rows + 4 * k_rows) + 8.0 * q_rows * n
    return _bound(flops, nbytes)


def vae_conv_bound(b: int, t: int, h: int, w: int, cin: int, cout: int,
                   residual: bool) -> Tuple[float, str]:
    """K3, one fused norm + SiLU + causal 3x3x3 conv call (its pre-pass
    included): 2 * 27 * Cin * Cout per output position; x, the 2-frame
    cache (read, and the new one written), the weights and the output
    (and the residual) once."""
    n_out, hw = b * t * h * w, b * h * w
    flops = 2.0 * 27 * cin * cout * n_out
    nbytes = 2.0 * (n_out * cin + 2 * 2 * hw * cin + 27 * cin * cout
                    + n_out * cout * (2 if residual else 1)) \
        + 4.0 * (cin + cout)
    return _bound(flops, nbytes)


def vae_upsample_bound(b: int, t: int, h: int, w: int, cin: int,
                       cout: int) -> Tuple[float, str]:
    """K4, one nearest-2x upsample + 3x3 conv call at low-res (h, w):
    2 * 16 * Cin * Cout per low-res position (the 4 output parities each
    see a 2x2 footprint); x, the weights and the 4x output once."""
    n_in = b * t * h * w
    flops = 2.0 * 4 * 4 * cin * cout * n_in
    nbytes = 2.0 * (n_in * cin + 16 * cin * cout + 4 * n_in * cout) \
        + 4.0 * cout
    return _bound(flops, nbytes)


# -- the DiT ------------------------------------------------------------------

def dit_k1_calls(m: dict, b: int, lq: int, n_tokens: int,
                 text_lens: Sequence[int]) -> List[tuple]:
    """(b, lq, k_valid) of every K1 call of one DiT forward: per block the
    self-attention over the valid tokens, the text cross-attention over
    each sample's valid text keys and, for i2v, the image cross-attention
    over the CLIP tokens. `m`: the model sizes (WanModelConfig fields)."""
    calls = []
    for _ in range(m["num_layers"]):
        calls.append((b, lq, [n_tokens] * b))
        calls.append((b, lq, list(text_lens)))
        if m["model_type"] == "i2v":
            calls.append((b, lq, [m["clip_tokens"]] * b))
    return calls


def dit_k1_bound_s(m: dict, b: int, lq: int, n_tokens: int,
                   text_lens: Sequence[int]) -> float:
    """Seconds of K1 bound in one DiT forward."""
    n, d = m["num_heads"], m["dim"] // m["num_heads"]
    return sum(attention_bound(bb, q, n, d, kv)[0]
               for bb, q, kv in dit_k1_calls(m, b, lq, n_tokens, text_lens))


def dit_forward_flops(m: dict, b: int, n_tokens: int,
                      text_lens: Sequence[int]) -> float:
    """Model FLOPs of one DiT forward of b samples with n_tokens valid
    latent tokens each and text_lens[i] valid text tokens."""
    dim, ffn, pdim = m["dim"], m["ffn_dim"], 4 * m["in_dim"]
    text_tokens = sum(text_lens)
    per_token = (4 * dim * dim          # self q, k, v, o
                 + 2 * dim * dim        # cross q, o
                 + 2 * dim * ffn)       # FFN
    macs = b * n_tokens * per_token * m["num_layers"]
    macs += text_tokens * 2 * dim * dim * m["num_layers"]   # cross k, v
    attn = 4.0 * dim * n_tokens * (b * n_tokens + text_tokens)
    if m["model_type"] == "i2v":
        ci, ce = m["clip_tokens"], m["clip_embed_dim"]
        macs += b * ci * 2 * dim * dim * m["num_layers"]    # k_img, v_img
        macs += b * ci * (ce * ce + ce * dim)               # img_emb
        attn += 4.0 * dim * n_tokens * b * ci
    attn *= m["num_layers"]
    macs += b * n_tokens * (pdim * dim + dim * 4 * m["out_dim"])  # patch, head
    macs += text_tokens * (m["text_dim"] * dim + dim * dim)  # text MLP
    macs += b * (m["freq_dim"] * dim + dim * dim + dim * 6 * dim)  # time
    return 2.0 * macs + attn


# -- umT5 ---------------------------------------------------------------------

def t5_encode_flops(t: dict, valid_tokens: Iterable[int]) -> float:
    """Model FLOPs of umT5 over each prompt's valid tokens: the q, k, v, o
    projections, the gated FFN and attention among the valid tokens."""
    dim, da, dff = t["dim"], t["dim_attn"], t["dim_ffn"]
    total = 0.0
    for n in valid_tokens:
        macs = n * (4 * dim * da + 3 * dim * dff)
        total += t["num_layers"] * (2.0 * macs + 4.0 * da * n * n)
    return total


# -- the VAE decoder ----------------------------------------------------------

def decoder_levels(v: dict) -> List[dict]:
    """The decoder's layer list (the Wan 2.1 decoder): one dict per layer,
    {"kind", "cin", "cout", "scale" (spatial factor over the latent),
    "tscale" (1, 2 or 4: time factor of the streaming step)}."""
    mult = v["dim_mult"]
    dims = [v["base_dim"] * u for u in (mult[-1],) + tuple(reversed(mult))]
    tup = tuple(reversed(v["temporal_downsample"]))
    out = [dict(kind="conv_in", cin=v["z_dim"], cout=dims[0], scale=1,
                tscale=1),
           dict(kind="res", cin=dims[0], cout=dims[0], scale=1, tscale=1),
           dict(kind="attn", cin=dims[0], cout=dims[0], scale=1, tscale=1),
           dict(kind="res", cin=dims[0], cout=dims[0], scale=1, tscale=1)]
    scale, tscale = 1, 1
    for i, (din, dout) in enumerate(zip(dims[:-1], dims[1:])):
        if i > 0:
            din //= 2
        for _ in range(v["num_res_blocks"] + 1):
            out.append(dict(kind="res", cin=din, cout=dout, scale=scale,
                            tscale=tscale))
            din = dout
        if i != len(mult) - 1:
            out.append(dict(kind="up", cin=dout, cout=dout // 2,
                            scale=scale, tscale=tscale,
                            temporal=bool(tup[i])))
            scale *= 2
            if tup[i]:
                tscale *= 2
    out.append(dict(kind="head", cin=dout, cout=3, scale=scale,
                    tscale=tscale))
    return out


def decoder_chunks(latent_frames: int) -> List[bool]:
    """The streaming decode's steps: the first latent frame, then one per
    step; True marks the first."""
    return [True] + [False] * (latent_frames - 1)


def vae_decode_calls(v: dict, b: int, latent_frames: int, h: int, w: int):
    """(K3 calls, K4 calls) of one streaming decode of b clips of a
    [z, latent_frames, h, w] latent: K3 (b, t, H, W, cin, cout, residual)
    per residual-block conv, K4 (b, t, H, W, cin, cout) per upsample at
    its low-res input."""
    k3, k4 = [], []
    for first in decoder_chunks(latent_frames):
        for lay in decoder_levels(v):
            t = 1 if first else lay["tscale"]
            hh, ww = h * lay["scale"], w * lay["scale"]
            if lay["kind"] == "res":
                k3.append((b, t, hh, ww, lay["cin"], lay["cout"], False))
                k3.append((b, t, hh, ww, lay["cout"], lay["cout"],
                           lay["cin"] == lay["cout"]))
            elif lay["kind"] == "up":
                tt = t * 2 if (lay["temporal"] and not first) else t
                k4.append((b, tt, hh, ww, lay["cin"], lay["cout"]))
    return k3, k4


def vae_decode_bounds_s(v: dict, b: int, latent_frames: int, h: int,
                        w: int) -> Tuple[float, float]:
    """Seconds of K3 and of K4 bound in one streaming decode."""
    k3, k4 = vae_decode_calls(v, b, latent_frames, h, w)
    return (sum(vae_conv_bound(*c)[0] for c in k3),
            sum(vae_upsample_bound(*c)[0] for c in k4))


def vae_decode_flops(v: dict, b: int, latent_frames: int, h: int,
                     w: int) -> float:
    """Model FLOPs of one streaming decode: every conv at 2 * k * Cin *
    Cout per output position (causal 3x3x3: k = 27, time conv 3x1x1: 3,
    upsample 3x3 at high res: 9, 1x1x1 shortcut and latent conv: 1), plus
    the middle attention (1x1 q, k, v, proj and 4 * C per query-key pair
    within each frame)."""
    total = 0.0
    z = v["z_dim"]
    for first in decoder_chunks(latent_frames):
        total += 2.0 * z * z * b * h * w                  # conv2 (1x1x1)
        for lay in decoder_levels(v):
            t = 1 if first else lay["tscale"]
            hh, ww = h * lay["scale"], w * lay["scale"]
            pos = b * t * hh * ww
            cin, cout = lay["cin"], lay["cout"]
            if lay["kind"] in ("conv_in", "head"):
                total += 2.0 * 27 * cin * cout * pos
            elif lay["kind"] == "res":
                total += 2.0 * 27 * (cin * cout + cout * cout) * pos
                if cin != cout:
                    total += 2.0 * cin * cout * pos
            elif lay["kind"] == "attn":
                total += 2.0 * 4 * cin * cin * pos
                total += 4.0 * cin * (hh * ww) * pos
            elif lay["kind"] == "up":
                if lay["temporal"] and not first:
                    total += 2.0 * 3 * cin * 2 * cin * pos
                    pos *= 2
                total += 2.0 * 9 * cin * cout * pos * 4
    return total


# -- training -----------------------------------------------------------------

def training_flops(forward_flops: float) -> float:
    """A training step's model FLOPs: the forward and a backward counted as
    twice the forward; rematerialised forwards are not useful work."""
    return 3.0 * forward_flops
