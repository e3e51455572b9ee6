"""Driver `omni_window_step`: OmniHuman's denoise loop over one window,
one unit a step: `pipelines/omni.py:omni_cfg_step` (the conditional
forward with audio, pose, reference and motion, the unconditional one,
the annealed guidance, the DPM++ update), from step 0 of the schedule.

A seed is one window of a request, with the geometry of every window of
a clip but the first: the noise, the motion frames (the previous
window's last latent frames) and the reference latent drawn in shape,
audio features of wav2vec's width (one a latent frame), pose heatmaps
made by the port's heatmap function from keypoints drawn from the seed,
and the prompt's and the negative prompt's contexts (umT5's output shape,
lengths drawn from the traffic's range, trimmed by the pipeline's
`text_context`). The weights are drawn from the seed too.

`correct` holds the conditional velocity of the window's first and last
step and the unconditional one of its first step against
`reference/omni.py` from the program's own input latent, then the
guidance and the DPM++ update alone, at the first and the last step,
against `reference/dpmpp.py` from the program's own velocities and
history.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from benchmark import flops_omni
from benchmark.drivers import common
from benchmark.harness import sync
from benchmark.reference import dpmpp as ref_dpm
from benchmark.reference import omni as ref_omni
from benchmark.reference.common import fp32_exact, worst_frame_rel


@dataclasses.dataclass
class State:
    model: object
    sd: dict
    m: dict
    traffic: dict
    inputs: dict          # the seed's noise, contexts, lens, conditions
    step_args: dict       # what omni_cfg_step takes beside x, state, i
    solver: object
    x: torch.Tensor = None
    sol_state: dict = None
    k: int = 0            # schedule index of the next step
    first: dict = None    # the window's first step (see `unit`)
    last: dict = None     # the window's latest step
    unit_rec: dict = None
    capture: list = None  # the DiT's outputs of the step running
    hook: object = None


def omni_config(conf: dict, base):
    """The OmniModelConfig the pipeline serves (`OmniHuman`: the defaults
    with the file's `num_frames` rows), after checking that its sizes are
    the file's `omni` group."""
    from omnihuman_tpu_torch.omni.model import OmniModelConfig
    want = conf["omni"]
    ocfg = OmniModelConfig(base=base, num_frames=want["num_frames"])
    have = dataclasses.asdict(ocfg)
    for k, v in want.items():
        got = have[k]
        got = list(got) if isinstance(got, tuple) else got
        if got != v:
            raise ValueError(f"OmniModelConfig.{k} is {got} in the port, "
                             f"{v} in the cell's file")
    return ocfg


def make_omni(ocfg, seed: int, device):
    """(the port's OmniModel with seeded bf16 weights, the weights by
    parameter name): `benchmark/weights.py`'s draw, with the DiT's AdaLN
    outlier channels."""
    from benchmark import weights
    from omnihuman_tpu_torch.omni.model import OmniModel
    with torch.device("meta"):
        model = OmniModel(ocfg)
    shapes = weights.shapes_of(model)
    # the adapters' scalar gates take 8 elements of the flat buffer (the
    # same N(0, 1) leaf, its first element used), so that every leaf after
    # them starts on 16 bytes, as block_norm's launcher requires
    scalars = [n for n, s in shapes.items() if s == ()]
    sd = weights.make_weights(dict(shapes, **{n: (8,) for n in scalars}),
                              seed, device, torch.bfloat16)
    sd.update({n: sd[n][0] for n in scalars})
    # the tables are views of sd's tensors: the outliers land in both
    weights.adaln_outliers({k[len(ref_omni.BASE):]: v for k, v in sd.items()
                            if k.startswith(ref_omni.BASE)},
                           common.salted(seed, 5))
    model = weights.load_into(model, sd)
    return model.eval().requires_grad_(False), sd


def pose_heatmaps(rng, keypoints: int, frames: int, h2: int, w2: int,
                  device) -> torch.Tensor:
    """[K, frames, h2, w2] heatmaps of keypoints drawn from rng (a pose
    that moves a little from frame to frame, a share under the confidence
    threshold), made as the pipeline makes them
    (`native.gaussian_heatmaps`)."""
    from omnihuman_tpu_torch import native
    base = rng.uniform(0.1, 0.9, size=(keypoints, 2))
    walk = np.cumsum(rng.normal(0.0, 0.01, size=(frames, keypoints, 2)),
                     axis=0)
    conf = np.broadcast_to(rng.uniform(0.0, 1.0, size=(keypoints, 1)),
                           (frames, keypoints, 1))
    kps = np.concatenate([np.clip(base + walk, 0.0, 0.999), conf],
                         axis=-1).astype(np.float32)
    hm = native.gaussian_heatmaps(kps, (h2, w2))
    return torch.from_numpy(np.ascontiguousarray(
        hm.transpose(1, 0, 2, 3))).to(device)


def setup(ctx):
    from omnihuman_tpu_torch.models.wan_dit import padded_seq_len
    from omnihuman_tpu_torch.pipelines.omni import OmniHuman
    from omnihuman_tpu_torch.pipelines.text2video import serving_policy
    from omnihuman_tpu_torch.samplers.fm_solvers import get_solver

    conf, tf, dev = ctx.cell.config, ctx.cell.traffic, ctx.device
    cfg = common.port_config(conf)
    ocfg = omni_config(conf, cfg.model)
    m = conf["model"]
    model, sd = make_omni(ocfg, ctx.seed, dev)
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
    z = conf["vae"]["z_dim"]
    f_lat = (tf["frame_num"] - 1) // sf + 1
    lat_h, lat_w = h // sh, w // sw
    noise = torch.randn((1, z, f_lat, lat_h, lat_w), generator=gen,
                        device=dev)
    motion = torch.randn((1, z, tf["motion_frames"], lat_h, lat_w),
                         generator=gen, device=dev)
    ref_lat = torch.randn((1, z, 1, lat_h, lat_w), generator=gen, device=dev)
    audio = torch.randn((1, f_lat, ocfg.audio_dim), generator=gen,
                        device=dev)
    pose = pose_heatmaps(rng, ocfg.num_keypoints, f_lat, 2 * lat_h,
                         2 * lat_w, dev)[None]
    lo, hi = tf["prompt_tokens"]
    ctx_c, n_c = common.text_context(rng, gen, lo, hi, m["text_len"],
                                     m["text_dim"], dev)
    ctx_n, n_n = common.text_context(rng, gen, lo, hi, m["text_len"],
                                     m["text_dim"], dev)
    lens = torch.tensor([n_c, n_n], dtype=torch.int32, device=dev)
    # the pipeline's trimming of given contexts to a 128-token bucket
    pipe = OmniHuman.__new__(OmniHuman)
    pipe.device, pipe.config = dev, cfg
    c1, c0, lens = pipe.text_context("", "", ctx_c[None], ctx_n[None], lens,
                                     {})
    solver = get_solver(tf["solver"], tf["steps"], float(tf["shift"]),
                        conf["num_train_timesteps"])
    step_args = dict(context=c1, context_null=c0,
                     cfg_scale=float(tf["cfg_scale"]), policy=policy,
                     audio=audio, pose=pose, ref_latent=ref_lat,
                     motion_latent=motion, context_lens=lens[:1],
                     null_lens=lens[1:])

    pt, ph, pw = m["patch_size"]
    hw = (lat_h // ph) * (lat_w // pw)
    n_video = (f_lat // pt) * hw
    n_extra = (tf["motion_frames"] // pt + 1) * hw
    seq = (padded_seq_len(n_video + n_extra), padded_seq_len(n_video))
    text_lens = [n_c, n_n]
    st = State(model, sd, m, tf,
               dict(noise=noise, ctx=ctx_c, ctx_null=ctx_n, lens=text_lens,
                    audio=audio, pose=pose, ref=ref_lat, motion=motion),
               step_args, solver,
               unit_rec={
                   "flops": flops_omni.step_flops(
                       conf["omni"], m, n_video, n_extra, text_lens, f_lat,
                       (f_lat, 2 * lat_h, 2 * lat_w)),
                   "bounds_s": {"K1": flops_omni.step_k1_bound_s(
                       m, seq, n_video, n_extra, text_lens, f_lat)}})
    st.capture = []
    st.hook = model.register_forward_hook(
        lambda mod, args, out: st.capture.append(out))
    # warm-up: one step of this window's shapes, then back to step 0
    _step(st, noise, solver.init_state(noise), 0)
    restart(st)
    return st


def restart(st: State) -> None:
    st.x = st.inputs["noise"]
    st.sol_state = st.solver.init_state(st.x)
    st.k = 0


def _step(st: State, x, sol_state, k):
    from omnihuman_tpu_torch.pipelines.omni import omni_cfg_step
    return omni_cfg_step(st.model, x, sol_state, k, st.solver,
                         **st.step_args)


@torch.no_grad()
def unit(st: State, i: int) -> dict:
    """One denoise step; the schedule starts again after its last step."""
    if st.k == st.traffic["steps"]:
        restart(st)
    x_in, s_in, k = st.x, st.sol_state, st.k
    st.capture.clear()
    st.x, st.sol_state = _step(st, x_in, s_in, k)
    st.k += 1
    # the step's input, its cond / uncond velocities (the DiT's two
    # outputs), the previous x0 prediction and the new latent
    st.last = dict(k=k, x_in=x_in, raw=list(st.capture),
                   x0_prev=s_in["hist"][-1], x_out=st.x)
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
    """The numbers compared with their limits (lower is better), each the
    worst of the frames: `dit_first` / `dit_last` the conditional
    velocity at the window's first / last step, `uncond_first` the
    unconditional one at its first step; `guide_solver` the guidance and
    the DPM++ update alone, the worse of the first and the last step,
    against the update's size. The control (`ctx.control`): the program
    on its own int8 path (set up so) for the DiT; for the guidance and
    the solver, the reference's stage in bf16."""
    inp, tf, m = st.inputs, st.traffic, st.m
    steps, shift = tf["steps"], float(tf["shift"])
    ts = ref_dpm.timesteps(steps, shift)
    conds = dict(audio=inp["audio"][0], pose=inp["pose"][0],
                 ref_latent=inp["ref"][0], motion_latent=inp["motion"][0])

    def dit_gap(rec, cond: bool):
        t = float(np.float32(ts[rec["k"]]))
        if cond:
            want = ref_omni.omni_forward(st.sd, m, rec["x_in"][0], t,
                                         inp["ctx"], inp["lens"][0], **conds)
        else:
            want = ref_omni.omni_forward(st.sd, m, rec["x_in"][0], t,
                                         inp["ctx_null"], inp["lens"][1])
        return worst_frame_rel(rec["raw"][0 if cond else 1][0], want)

    def stage(rec, dtype):
        v_c, v_u = rec["raw"]
        scale = ref_dpm.cfg_scale(rec["k"], steps, float(tf["cfg_scale"]))
        v = ref_dpm.guide(v_c, v_u, scale, dtype)
        return ref_dpm.step(rec["k"], steps, shift, rec["x_in"], v,
                            rec["x0_prev"], dtype)

    out = {}
    with torch.no_grad(), fp32_exact():
        out["dit_first"] = dit_gap(st.first, True)
        if tf.get("check_last_forward", False):
            out["dit_last"] = dit_gap(st.last, True)
        out["uncond_first"] = dit_gap(st.first, False)
        gaps = []
        for rec in (st.first, st.last):
            want = stage(rec, torch.float64)
            got = (stage(rec, torch.bfloat16) if ctx.control
                   else rec["x_out"])
            gaps.append(worst_frame_rel(got[0].double(), want[0],
                                        (want - rec["x_in"].double())[0]))
        out["guide_solver"] = max(gaps)
    return out
