"""Driver `distill_step`: Seaweed-APT's consistency-distillation training,
one unit a step of `apt.distill.distill_train_step` (the student's
forward at t = T_max with per-block remat, the MSE against the teacher's
velocity, the backward through K2, AdamW and the EMA), as
`cli.train_distill` builds it: bf16 parameters, moments and EMA, the
configuration's policy (bf16 compute, fp32 residual), `make_optimizer`.

Set-up builds the one training state, drives it through its first
steps (the window's own call and feed, a fresh batch drawn from the seed
each) and hands it to the window. `correct` follows those first steps in
the reference: each step's loss, the first gradient as the optimizer
took it (from its first moment after step 1) and the parameters' change
after them, leaf by leaf.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from benchmark import flops
from benchmark.drivers import common
from benchmark.harness import sync
from benchmark.reference import distill as ref_distill
from benchmark.reference.common import fp32_exact


@dataclasses.dataclass
class State:
    state: object            # the port's DistillState
    opt: object
    geometry: dict
    policy: object
    traffic: dict
    m: dict
    gen: torch.Generator
    lat: tuple
    unit_rec: dict
    first: list = None       # the first steps' batches and losses
    p0: dict = None          # parameters before step 1 (host)
    mu1: dict = None         # first moments after step 1 (host)
    p_after: dict = None     # parameters after the first steps (host)
    timing: dict = None


def _batch(st: State, dev) -> dict:
    m = st.m
    return {"noise": torch.randn((1,) + st.lat, generator=st.gen,
                                 device=dev),
            "context": torch.randn((1, m["text_len"], m["text_dim"]),
                                   generator=st.gen, device=dev),
            "v_teacher": torch.randn((1,) + st.lat, generator=st.gen,
                                     device=dev)}


def _host(tensors: dict) -> dict:
    return {n: t.detach().to("cpu", copy=True) for n, t in tensors.items()}


def setup(ctx):
    from omnihuman_tpu_torch.apt.distill import (
        init_distill_state, make_optimizer, trainable_params)
    from omnihuman_tpu_torch.apt.generate import latent_rope

    conf, tf, dev = ctx.cell.config, ctx.cell.traffic, ctx.device
    cfg = common.port_config(conf)
    m = conf["model"]
    model, _ = common.make_dit(m, cfg.model, ctx.seed, dev, trainable=True)
    w, h = tf["size"]
    sf, sh, sw = conf["vae_stride"]
    lat = (conf["vae"]["z_dim"], (tf["frame_num"] - 1) // sf + 1,
           h // sh, w // sw)
    opt = make_optimizer(lr=tf["lr"])
    geometry = latent_rope(cfg.model, lat, dev)
    pt, ph, pw = m["patch_size"]
    n_tokens = (lat[1] // pt) * (lat[2] // ph) * (lat[3] // pw)
    seq_len = geometry["seq_len"]
    n, d = m["num_heads"], m["dim"] // m["num_heads"]
    fwd = flops.dit_forward_flops(m, 1, n_tokens, [m["text_len"]])
    k1 = 2 * flops.dit_k1_bound_s(m, 1, seq_len, n_tokens, [m["text_len"]])
    k2 = m["num_layers"] * (
        flops.backward_bound(seq_len, seq_len, seq_len * n_tokens, n, d)[0]
        + flops.backward_bound(seq_len, m["text_len"],
                               seq_len * m["text_len"], n, d)[0])
    st = State(None, opt, geometry, cfg.policy, tf, m,
               common.device_gen(ctx.seed, dev, 3), lat,
               {"flops": flops.training_flops(fwd),
                "bounds_s": {"K1": k1, "K2": k2}})
    st.state = init_distill_state(model, opt)
    st.p0 = _host(trainable_params(model))
    st.first = []
    for i in range(tf["check_steps"]):
        batch = _batch(st, dev)
        metrics = _step(st, batch)
        st.first.append(dict(batch=batch, loss=float(metrics["loss"])))
        if i == 0:
            st.mu1 = _host(st.state.opt_state["mu"])
    st.p_after = _host(trainable_params(model))
    if ctx.trace:
        _time_optimizer(st)
    return st


def _step(st: State, batch: dict) -> dict:
    from omnihuman_tpu_torch.apt.distill import distill_train_step
    st.state, metrics = distill_train_step(
        st.state, batch, optimizer=st.opt, policy=st.policy,
        ema_decay=st.traffic["ema_decay"], remat=st.traffic["remat"],
        **st.geometry)
    return metrics


def _time_optimizer(st: State) -> None:
    """Host seconds around AdamW and the EMA, synchronised on both sides:
    the optimizer's `step` starts the clock, the EMA's end stops it."""
    from omnihuman_tpu_torch.apt import distill
    inner_step, inner_ema = st.opt.step, distill.ema_update
    st.timing = {}

    def opt_step(params, grads, state):
        sync(next(iter(params.values())).device)
        st.timing["t0"] = time.perf_counter()
        inner_step(params, grads, state)

    def ema_update(ema, params, decay=0.995):
        inner_ema(ema, params, decay)
        sync(next(iter(params.values())).device)
        st.timing["optimizer_s"] = time.perf_counter() - st.timing["t0"]

    st.opt.step = opt_step
    distill.ema_update = ema_update
    st.timing["restore"] = lambda: setattr(distill, "ema_update", inner_ema)


def unit(st: State, i: int) -> dict:
    dev = st.gen.device
    _step(st, _batch(st, dev))
    sync(dev)
    rec = dict(st.unit_rec)
    if st.timing is not None:
        rec["stages"] = {"optimizer_s": st.timing["optimizer_s"]}
    return rec


def release(st: State) -> None:
    if st.timing is not None:
        st.timing["restore"]()
    st.state = None
    st.opt = None


def _leaf_gaps(got: dict, want: dict, keep) -> float:
    """The worst leaf's |got - want| against the larger of want and the
    median leaf's want (some leaves are all but still)."""
    med = float(np.median([want[n] for n in keep]))
    gaps = [abs(got[n] - want[n]) / max(want[n], med) if max(want[n], med)
            else (0.0 if got[n] == 0 else float("inf")) for n in keep]
    return max(gaps)


def check(st: State, ctx) -> dict:
    """loss: the first steps' worst relative gap; grad: the step-1
    gradient's norm, leaf by leaf; change: the norm of each leaf's change
    over the first steps. Leaves whose reference gradient is under a
    thousandth of the median leaf's move by round-off alone and are left
    out. With `ctx.control` the reference with fp8 GEMM operands stands
    in the program's place."""
    tf = st.traffic
    hp = dict(lr=tf["lr"], b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01,
              grad_clip=1.0)
    dev = st.gen.device
    batches = [f["batch"] for f in st.first]
    p0 = {n: t.to(dev) for n, t in st.p0.items()}
    with fp32_exact():
        ref = ref_distill.train(p0, st.m, batches, hp)
        if ctx.control:
            got = ref_distill.train(p0, st.m, batches, hp, fp8=True)
            loss = got["loss"]
            grad = got["grad_norm"]
            after = got["params"]
        else:
            loss = [f["loss"] for f in st.first]
            grad = {n: float(torch.linalg.vector_norm(t.to(dev).float()))
                    / (1 - hp["b1"]) for n, t in st.mu1.items()}
            after = {n: t.to(dev) for n, t in st.p_after.items()}
    raw = ref["raw_grad_norm"]
    med = float(np.median(list(raw.values())))
    keep = [n for n, g in raw.items() if g >= 1e-3 * med]

    def change(params):
        return {n: float(torch.linalg.vector_norm(
            params[n].float() - p0[n].float())) for n in keep}

    return {"loss": max(abs(a - b) / abs(b) for a, b in
                        zip(loss, ref["loss"])),
            "grad": _leaf_gaps(grad, ref["grad_norm"], keep),
            "change": _leaf_gaps(change(after), change(ref["params"]),
                                 keep)}
