"""Driver `one_step_request`: one closed-loop stream of one-step
(Seaweed-APT) requests, back to back, one unit a request:
`SeaweedWanAPTGenerator.generate_batch` of the traffic's prompts (umT5
resident on the card, one DiT forward at t = T, the streaming VAE decode
through K3 / K4).

The weights of the DiT, umT5 and the VAE are drawn from the seed and
given to the port's `WanT2V`; every request's prompts (words drawn from
the traffic's list) and request seed are drawn from the run's seed.

`correct`: one request drawn from the seed among those the window
finished (a reservoir of one) is held against the reference: umT5's
output over each prompt's valid tokens, the latent (noise - v, the noise
worked out again from the request seed) and the decoded videos.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from benchmark import flops, weights
from benchmark.drivers import common
from benchmark.harness import sync
from benchmark.reference import dit as ref_dit
from benchmark.reference import t5 as ref_t5
from benchmark.reference import vae as ref_vae
from benchmark.reference.common import (
    fp32_exact, rel_l2, worst_frame_rel)


@dataclasses.dataclass
class Request:
    prompts: List[str]
    seed: int
    tokens: List[int]


@dataclasses.dataclass
class State:
    gen: object              # the port's SeaweedWanAPTGenerator
    sd_dit: dict
    sd_t5: dict
    sd_vae: dict
    conf: dict
    traffic: dict
    rng: np.random.Generator
    pick: np.random.Generator
    sample: dict = None      # the reservoir's request and its outputs
    seen: int = 0
    hooks: list = None
    capture: dict = None


def make_request(rng: np.random.Generator, tf: dict) -> Request:
    """`batch` prompts of words from the traffic's list, each with a
    drawn number of tokens (its words and the eos), and a request seed."""
    lo, hi = tf["prompt_tokens"]
    words = tf["words"]
    prompts, tokens = [], []
    for _ in range(tf["batch"]):
        n = int(rng.integers(lo, hi + 1))
        prompts.append(" ".join(words[int(i)] for i in
                                rng.integers(0, len(words), size=n - 1)))
        tokens.append(n)
    return Request(prompts, int(rng.integers(0, 2 ** 31)), tokens)


def clip_noise(seed: int, index: int, shape, device) -> torch.Tensor:
    """The noise of clip `index` of a request: the one-step generator's
    rule, a generator seeded with seed * 1,000,003 + index."""
    gen = torch.Generator(device=device).manual_seed(
        (int(seed) * 1_000_003 + int(index)) % (2 ** 63))
    return torch.randn(tuple(shape), generator=gen, device=device)


def setup(ctx):
    from omnihuman_tpu_torch.models.t5 import T5Encoder
    from omnihuman_tpu_torch.models.vae import WanVAE
    from omnihuman_tpu_torch.pipelines.text2video import WanT2V
    from omnihuman_tpu_torch.pipelines.wan_inference import (
        SeaweedWanAPTGenerator)

    conf, tf, dev = ctx.cell.config, ctx.cell.traffic, ctx.device
    cfg = common.port_config(conf)
    # the control: the DiT on the program's own int8 path
    precision = "int8" if ctx.control else conf["precision"]
    pipe = WanT2V(cfg, init_seed=0, param_dtype=torch.bfloat16,
                  precision=precision, device=dev)
    # the benchmark's weights in place of the pipeline's own
    model, sd_dit = common.make_dit(conf["model"], cfg.model, ctx.seed, dev)
    if ctx.control:
        from omnihuman_tpu_torch.ops.quant import quantize_wan_model
        quantize_wan_model(model)
    pipe.model = model
    with torch.device("meta"):
        t5, vae = T5Encoder(cfg.t5), WanVAE(cfg.vae)
    sd_t5 = weights.make_weights(weights.shapes_of(t5),
                                 common.salted(ctx.seed, 10), dev,
                                 torch.bfloat16)
    sd_vae = weights.make_weights(weights.shapes_of(vae),
                                  common.salted(ctx.seed, 20), dev,
                                  torch.bfloat16)
    pipe._t5 = weights.load_into(t5, sd_t5).eval().requires_grad_(False)
    pipe.vae = weights.load_into(vae, sd_vae).eval().requires_grad_(False)
    gen = SeaweedWanAPTGenerator(pipe)
    st = State(gen, sd_dit, sd_t5, sd_vae, conf, tf,
               np.random.default_rng(ctx.seed),
               np.random.default_rng(common.salted(ctx.seed, 1)))
    st.capture = {}
    st.hooks = [pipe._t5.register_forward_hook(
                    lambda mod, a, out: st.capture.__setitem__("ctx", out)),
                model.register_forward_hook(
                    lambda mod, a, out: st.capture.__setitem__("v", out))]
    # warm-up: a request of each text bucket the traffic reaches
    warm = np.random.default_rng(common.salted(ctx.seed, 2))
    for tokens in tf["warmup_tokens"]:
        req = make_request(warm, dict(tf, prompt_tokens=[tokens, tokens]))
        _generate(st, req)
    return st


def _generate(st: State, req: Request):
    w, h = st.traffic["size"]
    return st.gen.generate_batch(req.prompts, size=(w, h),
                                 frame_num=st.traffic["frame_num"],
                                 seed=req.seed)


def request_work(conf: dict, tf: dict, tokens: List[int]) -> dict:
    """Model FLOPs and kernel bounds of one request."""
    m, v = conf["model"], conf["vae"]
    w, h = tf["size"]
    sf, sh, sw = conf["vae_stride"]
    f, lh, lw = (tf["frame_num"] - 1) // sf + 1, h // sh, w // sw
    from omnihuman_tpu_torch.models.wan_dit import padded_seq_len
    pt, ph, pw = m["patch_size"]
    n_tokens = (f // pt) * (lh // ph) * (lw // pw)
    seq_len = padded_seq_len(n_tokens)
    b = len(tokens)
    k3, k4 = flops.vae_decode_bounds_s(v, b, f, lh, lw)
    return {"flops": (flops.t5_encode_flops(conf["t5"], tokens)
                      + flops.dit_forward_flops(m, b, n_tokens, tokens)
                      + flops.vae_decode_flops(v, b, f, lh, lw)),
            "bounds_s": {"K1": flops.dit_k1_bound_s(m, b, seq_len,
                                                    n_tokens, tokens),
                         "K3": k3, "K4": k4}}


@torch.no_grad()
def unit(st: State, i: int) -> dict:
    """One request. The reservoir keeps request i with probability
    1 / (i + 1), drawn before it runs, so the kept one is uniform over
    the requests the window finished."""
    req = make_request(st.rng, st.traffic)
    keep = st.pick.random() < 1.0 / (st.seen + 1)
    st.seen += 1
    video = _generate(st, req)
    sync(video.device)
    if keep:
        st.sample = dict(req=req, video=video, ctx=st.capture["ctx"],
                         v=st.capture["v"])
    st.capture.clear()
    rec = request_work(st.conf, st.traffic, req.tokens)
    rec["stages"] = {k: st.gen.timings[k]
                     for k in ("text_encode_s", "dit_s", "vae_decode_s")}
    return rec


def release(st: State) -> None:
    for hk in st.hooks:
        hk.remove()
    st.gen = None


def check(st: State, ctx) -> dict:
    """context: umT5's output rows of both prompts; latent (noise - v,
    relative to v) and video (the worst of its frames) of one clip drawn
    from the seed. The control (`ctx.control`), each stage at the
    precision below its own: the DiT on the program's own int8 path (set
    up so) for the latent; for umT5 and the VAE, which have none, the
    reference with fp8 operands in the program's place (the decode of
    the reference's own latent)."""
    conf, tf = st.conf, st.traffic
    m, t5c, v = conf["model"], conf["t5"], conf["vae"]
    req, dev = st.sample["req"], st.sample["video"].device
    w, h = tf["size"]
    sf, sh, sw = conf["vae_stride"]
    lat = (v["z_dim"], (tf["frame_num"] - 1) // sf + 1, h // sh, w // sw)
    out = {"context": 0.0, "latent": 0.0, "video": 0.0}
    with torch.no_grad(), fp32_exact():
        ids, mask = ref_t5.tokenize(req.prompts, m["text_len"])
        ctx_ref = ref_t5.encode(st.sd_t5, t5c, ids, mask, dev)
        ctx_got = (ref_t5.encode(st.sd_t5, t5c, ids, mask, dev, fp8=True)
                   if ctx.control else
                   [st.sample["ctx"][b, :len(c)] for b, c in
                    enumerate(ctx_ref)])
        for c_got, c_ref in zip(ctx_got, ctx_ref):
            out["context"] = max(out["context"], rel_l2(c_got, c_ref))
        # one clip of the request, drawn from the seed: the reference
        # (a DiT forward and an fp32 decode a clip) is shorter by half
        b = int(np.random.default_rng(common.salted(ctx.seed, 7)).integers(
            0, len(ctx_ref)))
        c = ctx_ref[b]
        t = float(conf["num_train_timesteps"])
        noise = clip_noise(req.seed, b, lat, dev)
        v_ref = ref_dit.dit_forward(st.sd_dit, m, noise, t, c, len(c))
        out["latent"] = worst_frame_rel(noise - st.sample["v"][b].float(),
                                     noise - v_ref, v_ref)
        lat_ref = noise - v_ref
        del v_ref
        vid_got = (ref_vae.decode(st.sd_vae, v, lat_ref[None], fp8=True)[0]
                   if ctx.control else st.sample["video"][b])

        def judge(i, chunk):      # chunk: [1, 3, frames, H, W] of step i
            f0 = 0 if i == 0 else 1 + 4 * (i - 1)
            got = vid_got[:, f0:f0 + chunk.shape[2]].float()
            for f in range(chunk.shape[2]):
                out["video"] = max(out["video"], rel_l2(got[:, f],
                                                        chunk[0, :, f]))
        ref_vae.decode(st.sd_vae, v, lat_ref[None], frames_out=judge)
    return out
