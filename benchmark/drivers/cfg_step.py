"""Driver `cfg_step`: the denoise loop of `text2video.sample`, one unit a
step: `cfg_model_step` (the fused cond / uncond DiT forward and the
guidance) then the solver's `step`, from step 0 of the schedule.

A seed is one request: the noise, the prompt's and the negative prompt's
contexts (umT5's output shape, lengths drawn from the traffic's range,
trimmed by `WanT2V.text_context`) and, for i2v, the first-frame mask with
a drawn reference latent (`y`) and drawn CLIP features. The weights are
drawn from the seed too.

`correct` holds the DiT's cond and uncond velocities of the window's
first step against the reference from the same inputs, and, where the
traffic asks for it, those of its last step from the program's own input
latent; then the guidance and the solver's update alone, at the first
and the last step, from the program's own velocities and history.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from benchmark import flops
from benchmark.drivers import common
from benchmark.harness import sync
from benchmark.reference import dit as ref_dit
from benchmark.reference import unipc as ref_unipc
from benchmark.reference.common import fp32_exact, worst_frame_rel


@dataclasses.dataclass
class State:
    model: object
    sd: dict
    m: dict
    traffic: dict
    inputs: dict          # noise, contexts, lens, y, clip_fea (the seed's)
    step_args: dict       # what cfg_model_step takes beside x and t
    solver: object
    x: torch.Tensor = None
    sol_state: dict = None
    k: int = 0            # schedule index of the next step
    first: dict = None    # the window's first step (see `unit`)
    last: dict = None     # the window's latest step
    unit_rec: dict = None
    capture: list = None  # the DiT's outputs of the step running
    hook: object = None


def setup(ctx):
    from omnihuman_tpu_torch.models.wan_dit import padded_seq_len
    from omnihuman_tpu_torch.ops.rope import rope_angles_3d
    from omnihuman_tpu_torch.pipelines.text2video import (
        WanT2V, serving_policy)
    from omnihuman_tpu_torch.samplers.fm_solvers import get_solver

    conf, tf, dev = ctx.cell.config, ctx.cell.traffic, ctx.device
    cfg = common.port_config(conf)
    m = conf["model"]
    model, sd = common.make_dit(m, cfg.model, ctx.seed, dev)
    precision = conf["precision"]
    if ctx.control:
        # the control: the program on its own lower-precision path
        from omnihuman_tpu_torch.ops.quant import quantize_wan_model
        quantize_wan_model(model)
        precision = "int8"
    policy = serving_policy(cfg, precision)

    rng = np.random.default_rng(ctx.seed)
    gen = common.device_gen(ctx.seed, dev, 1)
    w, h = tf["size"]
    sf, sh, sw = conf["vae_stride"]
    lat = (conf["vae"]["z_dim"], (tf["frame_num"] - 1) // sf + 1,
           h // sh, w // sw)
    noise = torch.randn((1,) + lat, generator=gen, device=dev)
    lo, hi = tf["prompt_tokens"]
    ctx_c, n_c = common.text_context(rng, gen, lo, hi, m["text_len"],
                                     m["text_dim"], dev)
    ctx_n, n_n = common.text_context(rng, gen, lo, hi, m["text_len"],
                                     m["text_dim"], dev)
    y = clip = None
    if m["model_type"] == "i2v":
        msk = ref_dit.first_frame_mask(tf["frame_num"], lat[2], lat[3], dev)
        ref_lat = torch.randn(lat, generator=gen, device=dev)
        y = torch.cat([msk, ref_lat], dim=0)[None]
        clip = torch.randn((1, m["clip_tokens"], m["clip_embed_dim"]),
                           generator=gen, device=dev)
    lens = torch.tensor([n_c, n_n], dtype=torch.int32, device=dev)
    # the pipeline's trimming of given contexts to a 128-token bucket
    pipe = WanT2V.__new__(WanT2V)
    pipe.device, pipe.config = dev, cfg
    c1, c0, lens = pipe.text_context("", "", ctx_c[None], ctx_n[None], lens,
                                     {})
    pt, ph, pw = m["patch_size"]
    grid = (lat[1] // pt, lat[2] // ph, lat[3] // pw)
    n_tokens = grid[0] * grid[1] * grid[2]
    seq_len = padded_seq_len(n_tokens, 1)
    sin, cos = rope_angles_3d(grid, m["dim"] // m["num_heads"],
                              seq_len=seq_len, device=dev)
    solver = get_solver(tf["solver"], tf["steps"], float(tf["shift"]),
                        conf["num_train_timesteps"])
    step_args = dict(ctx2=torch.cat([c1, c0], dim=0), rope_sin=sin,
                     rope_cos=cos, ctx_lens=lens, policy=policy,
                     seq_len=seq_len, guide_scale=float(tf["guide_scale"]),
                     cfg_mode=tf["cfg_mode"], y=y, clip_fea=clip)
    text_lens = [n_c, n_n]
    fwd = flops.dit_forward_flops(m, 2, n_tokens, text_lens)
    k1 = flops.dit_k1_bound_s(m, 2, seq_len, n_tokens, text_lens)
    st = State(model, sd, m, tf,
               dict(noise=noise, ctx=ctx_c, ctx_null=ctx_n, lens=text_lens,
                    y=y, clip=clip),
               step_args, solver,
               unit_rec={"flops": fwd, "bounds_s": {"K1": k1}})
    st.capture = []
    st.hook = model.register_forward_hook(
        lambda mod, args, out: st.capture.append(out))
    # warm-up: one step of this request's shapes, then back to step 0
    _step(st, noise, solver.init_state(noise), 0)
    restart(st)
    return st


def restart(st: State) -> None:
    st.x = st.inputs["noise"]
    st.sol_state = st.solver.init_state(st.x)
    st.k = 0


def _step(st: State, x, sol_state, k):
    from omnihuman_tpu_torch.pipelines.text2video import cfg_model_step
    a = st.step_args
    t = float(np.float32(st.solver.timesteps[k]))
    v = cfg_model_step(st.model, x, t, a["ctx2"], a["rope_sin"],
                       a["rope_cos"], a["ctx_lens"], policy=a["policy"],
                       seq_len=a["seq_len"], guide_scale=a["guide_scale"],
                       cfg_mode=a["cfg_mode"], y=a["y"],
                       clip_fea=a["clip_fea"])
    x_out, new_state = st.solver.step(sol_state, v, x, k)
    return v, x_out, new_state


@torch.no_grad()
def unit(st: State, i: int) -> dict:
    """One denoise step; the schedule starts again after its last step."""
    if st.k == st.traffic["steps"]:
        restart(st)
    x_in, s_in, k = st.x, st.sol_state, st.k
    st.capture.clear()
    _, st.x, st.sol_state = _step(st, x_in, s_in, k)
    st.k += 1
    # the step's input, its cond / uncond velocities (the DiT's outputs,
    # one fused call or two), the solver's history and the new latent
    st.last = dict(k=k, x_in=x_in, raw=torch.cat(st.capture),
                   hist=s_in["hist"], prev=s_in["last_sample"], x_out=st.x)
    if i == 0:
        st.first = st.last
    sync(x_in.device)
    return st.unit_rec


def release(st: State) -> None:
    """Drop the program (its weights stay: they are the benchmark's)."""
    st.hook.remove()
    st.model = None
    st.step_args = None


def check(st: State, ctx) -> dict:
    """The numbers compared with their limits (lower is better): `dit_*`
    the cond or the uncond velocity (one drawn from the seed: the check
    is shorter by half), the worst of the frames;
    `guide_solver` the guidance and the UniPC update alone, the worse of
    the first and the last step. The control (`ctx.control`): the program
    on its own int8 path (set up so) for the DiT; for the guidance and
    the solver, the reference's stage in bf16."""
    inp, tf, m = st.inputs, st.traffic, st.m
    tab = ref_unipc.plan(tf["steps"], float(tf["shift"]))
    ts = ref_unipc.timesteps(tf["steps"], float(tf["shift"]))
    g = float(tf["guide_scale"])
    y = None if inp["y"] is None else inp["y"][0]
    clip = None if inp["clip"] is None else inp["clip"][0]

    pick = np.random.default_rng(common.salted(ctx.seed, 7))
    texts = ((inp["ctx"], inp["lens"][0]), (inp["ctx_null"], inp["lens"][1]))

    def dit_gap(rec):
        """One of the step's two velocities, drawn from the seed (cond or
        uncond), against the reference's at the step's input."""
        i = int(pick.integers(0, 2))
        x, t = rec["x_in"][0], float(np.float32(ts[rec["k"]]))
        c, n = texts[i]
        want = ref_dit.dit_forward(st.sd, m, x, t, c, n, y, clip)
        return worst_frame_rel(rec["raw"][i], want)

    def stage(rec, dtype):
        raw = rec["raw"].to(dtype)
        v = raw[1:] + g * (raw[:1] - raw[1:])
        return ref_unipc.step(tab, rec["k"], rec["x_in"], v, rec["hist"],
                              rec["prev"], dtype=dtype)[0].float()

    out = {}
    with torch.no_grad(), fp32_exact():
        out["dit_first"] = dit_gap(st.first)
        if tf.get("check_last_forward", False):
            out["dit_last"] = dit_gap(st.last)
        gaps = []
        for rec in (st.first, st.last):
            want = stage(rec, torch.float32)
            got = stage(rec, torch.bfloat16) if ctx.control else rec["x_out"]
            gaps.append(worst_frame_rel(got[0].float(), want[0],
                                        (want - rec["x_in"])[0]))
        out["guide_solver"] = max(gaps)
    return out
