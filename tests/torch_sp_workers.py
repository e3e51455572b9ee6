"""Multi-process gloo runs of the port's sequence-parallel / FSDP code for
tests/test_torch_{ring_attention,mesh,sp_model,sp_grad,sp_train,sp_cli,
sp_spatial}.py.

`Ranks(world, case, payload, tmp_path)` starts `world` processes (one
`torch.multiprocessing` spawn), each joining a gloo group through a
`file://` store under tmp_path (no TCP port, so parallel test workers
cannot collide), running `CASES[case](payload)` and saving what it
returns; `.results()` gives the list of every rank's results. This
module imports torch and the port only, so the children start fast.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

DEADLINE_S = 240


def _entry(rank, world, store, case, payload_path, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    try:
        payload = torch.load(payload_path, weights_only=False)
        out = CASES[case](payload)
        torch.save(out, os.path.join(out_dir, f"out{rank}.pt"))
    finally:
        dist.destroy_process_group()


class Ranks:
    """`world` running processes of CASES[case](payload); `results()`
    waits for them and returns every rank's result. Starting them before
    the JAX side computes its reference lets the two overlap."""

    def __init__(self, world: int, case: str, payload, tmp_path):
        self.world, self.case, self.dir = world, case, str(tmp_path)
        payload_path = os.path.join(self.dir, "payload.pt")
        torch.save(payload, payload_path)
        self.ctx = mp.spawn(_entry, args=(
            world, os.path.join(self.dir, "store"), case, payload_path,
            self.dir), nprocs=world, join=False)
        self.t_end = time.monotonic() + DEADLINE_S

    def results(self):
        while not self.ctx.join(timeout=5):
            if time.monotonic() > self.t_end:
                for p in self.ctx.processes:
                    p.kill()
                raise TimeoutError(f"{self.case}: ranks still running "
                                   f"after {DEADLINE_S} s")
        return [torch.load(os.path.join(self.dir, f"out{r}.pt"),
                           weights_only=False) for r in range(self.world)]


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# tests/test_torch_ring_attention.py: every attention case on sp 4


def attention_cases(p):
    from omnihuman_tpu_torch.ops.ring_attention import (
        ring_attention, sp_cross_attention, ulysses_attention)
    from omnihuman_tpu_torch.parallel import (
        MeshConfig, create_mesh, use_mesh)
    from omnihuman_tpu_torch.parallel.partition import shard_tokens
    from omnihuman_tpu_torch.ops.attention import flash_attention
    mesh = create_mesh(MeshConfig(1, 1, 4))
    sp = mesh["sp"]
    f32 = torch.float32

    def local(name):
        return shard_tokens(_t(p[name]), sp)

    q, k, v = local("q"), local("k"), local("v")
    lens = _t(p["lens"])
    out = {}
    for impl in ("flash", "dense"):
        for tag, kw in p["ring_masks"].items():
            out[f"ring_{impl}_{tag}"] = ring_attention(
                q, k, v, mesh, seq_lens=lens, compute_dtype=f32, impl=impl,
                **kw)
    qh, kh, vh = local("qh"), local("kh"), local("vh")
    for impl in ("flash", "dense"):
        out[f"ulysses_{impl}"] = ulysses_attention(
            qh, kh, vh, mesh, seq_lens=lens, compute_dtype=f32, impl=impl)
    kc, vc, kl = _t(p["kc"]), _t(p["vc"]), _t(p["klens"])
    for tag, kw in p["cross_masks"].items():
        out[f"sp_cross_{tag}"] = sp_cross_attention(
            q, kc, vc, mesh, k_lens=kl, compute_dtype=f32, **kw)
    # the dispatcher: q_scale before the ring, sp_cross by name
    with use_mesh(mesh):
        out["dispatch_ring_qscale"] = flash_attention(
            q, k, v, k_lens=lens, q_scale=0.5, dtype=f32,
            implementation="ring")
        out["dispatch_sp_cross"] = flash_attention(
            q, kc, vc, k_lens=kl, dtype=f32, implementation="sp_cross")
    return out


# ---------------------------------------------------------------------------
# tests/test_torch_sp_model.py: the DiT under sp 4, omni under sp 2


def dit_cases(p):
    from omnihuman_tpu_torch.configs.wan import DTypePolicy
    from omnihuman_tpu_torch.models.wan_dit import build_wan_model
    from omnihuman_tpu_torch.ops.rope import rope_angles_3d
    from omnihuman_tpu_torch.omni.model import build_omni_model
    from omnihuman_tpu_torch.parallel import (
        MeshConfig, create_mesh, use_mesh)
    from omnihuman_tpu_torch.pipelines.omni import omni_generate
    f32 = DTypePolicy(compute=torch.float32)
    out = {}
    mesh = create_mesh(MeshConfig(1, 1, 4))
    for kind in ("t2v", "i2v"):
        d = p[kind]
        model = build_wan_model(d["cfg"], "cpu", torch.float32, seed=None)
        model.load_state_dict(d["sd"])
        sin, cos = rope_angles_3d(d["grid"], d["cfg"].head_dim,
                                  seq_len=d["seq_len"])
        kw = dict(seq_len=d["seq_len"], rope_sin=sin, rope_cos=cos,
                  policy=f32, context_lens=d.get("lens"),
                  y=None if "y" not in d else _t(d["y"]),
                  clip_fea=None if "clip" not in d else _t(d["clip"]))
        for impl in ("ring", "ulysses"):
            with torch.no_grad(), use_mesh(mesh, sp_route=impl):
                out[f"{kind}_{impl}"] = model(
                    _t(d["x"]), _t(d["t"]), _t(d["ctx"]), **kw)
    o = p["omni"]
    model = build_omni_model(o["cfg"], "cpu", torch.float32, seed=None)
    model.load_state_dict(o["sd"])
    mesh2 = create_mesh(MeshConfig(2, 1, 2))
    out["omni_sp2"] = omni_generate(
        model, _t(o["noise"]), _t(o["ctx"]), _t(o["ctx_null"]), policy=f32,
        audio=_t(o["audio"]), pose=_t(o["pose"]),
        ref_latent=_t(o["ref_latent"]), context_lens=_t(o["lens"]),
        null_lens=_t(o["nlens"]), mesh=mesh2, **o["kw"])
    return out


# ---------------------------------------------------------------------------
# tests/test_torch_mesh.py: FSDP2 placement, WanT2V on (1, 2, 2), the CLIs


def mesh_cases(p):
    from omnihuman_tpu_torch.configs.wan import DTypePolicy, TINY_TEST
    from omnihuman_tpu_torch.models.wan_dit import build_wan_model
    from omnihuman_tpu_torch.ops.rope import rope_angles_3d
    from omnihuman_tpu_torch.models.t5 import build_t5_encoder
    from omnihuman_tpu_torch.parallel import (
        MeshConfig, create_mesh, infer_param_specs, shard_params, use_mesh)
    from omnihuman_tpu_torch.parallel.mesh import self_attention_route
    from omnihuman_tpu_torch.pipelines.text2video import WanT2V, sample
    from torch.distributed.tensor import DTensor
    out = {}
    cfg = dataclasses.replace(TINY_TEST,
                              policy=DTypePolicy(compute=torch.float32))
    mesh = create_mesh(MeshConfig(1, 2, 2))

    # FSDP2 with every parameter that has a divisible dimension sharded
    # (min_size 1: JAX's 2^16 leaves none of the tiny configs' parameters
    # sharded, so the pipeline and the CLIs below shard nothing)
    model = build_wan_model(cfg.model, "cpu", torch.float32, seed=None)
    model.load_state_dict(p["sd"])
    specs = infer_param_specs(model, min_size=1, axis_size=2)
    shard_params(model, mesh, min_size=1)
    out["placements"] = {
        n: (x.placements[0].dim if isinstance(x, DTensor) else None,
            tuple(x.to_local().shape) if isinstance(x, DTensor) else None)
        for n, x in model.named_parameters()}
    out["specs"] = specs
    sin, cos = rope_angles_3d((2, 4, 4), cfg.model.head_dim, seq_len=32)
    args = (_t(p["x"]), _t(p["t"]), _t(p["ctx"]))
    kw = dict(seq_len=32, rope_sin=sin, rope_cos=cos, policy=cfg.policy)
    with torch.no_grad():
        out["fsdp_forward"] = model(*args, **kw)
        # the same call under the mesh: the ring at sp 2, from the mesh alone
        with use_mesh(mesh):
            out["mesh_forward"] = model(*args, **kw)

    t5 = build_t5_encoder(cfg.t5, "cpu", torch.float32, seed=5)
    ids = _t(p["t5_ids"])
    with torch.no_grad():
        out["t5_whole"] = t5(ids, None, torch.float32)
        shard_params(t5, mesh, min_size=1)
        out["t5_sharded"] = t5(ids, None, torch.float32)
    out["t5_dtensors"] = sum(isinstance(x, DTensor) for x in t5.parameters())

    # WanT2V's denoise from JAX's noise, as generate(size=(32, 32),
    # frame_num=5, sampling_steps=2) runs it at its defaults
    pipe = WanT2V(cfg, device="cpu", param_dtype=torch.float32, mesh=mesh,
                  checkpoint_dir=p["ckpt"])
    with use_mesh(pipe.mesh):
        route = self_attention_route()
    out["plan"] = (route, pipe.sp_size, pipe.t5_auto_unload)
    noise = _t(p["gen_noise"])
    out["latents"] = sample(
        pipe.model, noise, _t(p["gen_ctx"]), _t(p["gen_ctx_null"]),
        policy=pipe.policy, seq_len=pipe.seq_len_for(tuple(noise.shape[1:])),
        shift=5.0, solver="unipc", steps=2, guide_scale=5.0,
        num_train_timesteps=cfg.num_train_timesteps, mesh=pipe.mesh)

    # the CLIs on the joined group: one file, rank 0's. No tokenizer files
    # are cached here, so the CLIs tokenize with the hash fallback; keeping
    # transformers out saves each rank its import
    import sys
    sys.modules["transformers"] = None
    from omnihuman_tpu_torch.cli import generate, omni_inference
    d = p["out_dir"]
    out["generate"] = generate.main(
        ["--task", "tiny-test", "--size", "64*64", "--frame_num", "5",
         "--sample_steps", "2", "--base_seed", "3", "--sp_size", "2",
         "--fsdp_size", "2", "--device", "cpu",
         "--save_file", os.path.join(d, "clip.mp4")])
    out["omni"] = omni_inference.main(
        ["--task", "tiny-test", "--reference_image", p["image"],
         "--size", "64*64", "--num_frames", "3", "--num_inference_steps",
         "1", "--sp_size", "2", "--device", "cpu",
         "--output", os.path.join(d, "omni.mp4")])
    return out


# ---------------------------------------------------------------------------
# tests/test_torch_sp_grad.py: the attention gradients at sp 2 and 4


def attention_grad_cases(p):
    from omnihuman_tpu_torch.ops.ring_attention import (
        ring_attention, sp_cross_attention, ulysses_attention)
    from omnihuman_tpu_torch.parallel import MeshConfig, create_mesh
    from omnihuman_tpu_torch.parallel.partition import shard_tokens
    f32 = torch.float32
    lens, klens = _t(p["lens"]), _t(p["klens"])
    out = {}
    for sp in (2, 4):
        mesh = create_mesh(MeshConfig(-1, 1, sp))

        def local(name, shard=True):
            x = _t(p[name])
            return shard_tokens(x, mesh["sp"]) if shard else x

        def grads(fn, names, shards, do):
            xs = [local(n, s).clone().requires_grad_(True)
                  for n, s in zip(names, shards)]
            (fn(*xs) * local(do)).sum().backward()
            return [x.grad for x in xs]

        for impl in ("flash", "dense"):
            for tag, kw in p["ring_masks"].items():
                out[f"sp{sp}_ring_{impl}_{tag}"] = grads(
                    lambda q, k, v: ring_attention(
                        q, k, v, mesh, seq_lens=lens, compute_dtype=f32,
                        impl=impl, **kw),
                    ("q", "k", "v"), (True,) * 3, "do")
            out[f"sp{sp}_ulysses_{impl}"] = grads(
                lambda q, k, v: ulysses_attention(
                    q, k, v, mesh, seq_lens=lens, compute_dtype=f32,
                    impl=impl),
                ("qh", "kh", "vh"), (True,) * 3, "doh")
        for tag, kw in p["cross_masks"].items():
            out[f"sp{sp}_sp_cross_{tag}"] = grads(
                lambda q, k, v: sp_cross_attention(
                    q, k, v, mesh, k_lens=klens, compute_dtype=f32, **kw),
                ("q", "kc", "vc"), (True, False, False), "do")
    return out


# ---------------------------------------------------------------------------
# tests/test_torch_sp_train.py: the training steps on (2, 1, 2) and (1, 2, 2)


class Recorder:
    """An optimizer that keeps the whole gradients it is given and their
    mesh-wide norm, then runs `inner` (or nothing)."""

    def __init__(self, inner=None):
        self.inner, self.grads, self.norm = inner, None, None

    def init(self, params):
        return self.inner.init(params) if self.inner else {}

    def step(self, params, grads, state):
        from omnihuman_tpu_torch.apt.optim import global_norm
        from omnihuman_tpu_torch.parallel.partition import full
        self.grads = {n: full(g).detach().clone() for n, g in grads.items()}
        self.norm = global_norm(grads.values())
        if self.inner:
            self.inner.step(params, grads, state)


def _floats(m):
    return {k: float(v) for k, v in m.items()}


def _wan(sd, trainable=True):
    from omnihuman_tpu_torch.configs.wan import TINY_TEST
    from omnihuman_tpu_torch.models.wan_dit import build_wan_model
    model = build_wan_model(TINY_TEST.model, "cpu", torch.float32, seed=None,
                            trainable=trainable)
    model.load_state_dict(sd)
    return model


def train_steps(p, plan, tag):
    """One distill, APT D and G, f-distill and omni step on `plan` (every
    parameter with a divisible dimension sharded: min_size 1), fp32; the
    whole gradients, the loss and the grad norm of each. With `tag`
    "fsdp", the distill state is also saved (rank 0 writes) and a
    single-process checkpoint restored."""
    import functools
    from omnihuman_tpu_torch.apt import apt_trainer as tr
    from omnihuman_tpu_torch.apt import f_distill as fd
    from omnihuman_tpu_torch.apt.distill import (
        distill_train_step, init_distill_state, make_optimizer)
    from omnihuman_tpu_torch.apt.generate import latent_rope
    from omnihuman_tpu_torch.apt.model import init_apt_discriminator
    from omnihuman_tpu_torch.configs.wan import DTypePolicy, TINY_TEST
    from omnihuman_tpu_torch.omni.model import build_omni_model
    from omnihuman_tpu_torch.omni.trainer import (
        init_omni_train_state, make_lr_schedule, make_omni_optimizer,
        omni_train_step)
    from omnihuman_tpu_torch.utils.checkpoint import (
        CheckpointManager, _to_cpu)
    from torch.distributed.tensor import DTensor
    f32 = DTypePolicy(compute=torch.float32)
    shard = functools.partial(plan.shard_tree, min_size=1)
    batch = {k: _t(v) for k, v in p["distill_batch"].items()}
    geo = latent_rope(TINY_TEST.model, batch["noise"].shape, "cpu",
                      sp=plan.sp)
    res = {"seq_len": geo["seq_len"]}

    model = shard(_wan(p["wan_sd"]))
    res["dtensors"] = sum(isinstance(x, DTensor) for x in model.parameters())
    rec = Recorder(make_optimizer())
    state = init_distill_state(model, rec)
    state, m = distill_train_step(state, plan.put_batch(batch), optimizer=rec,
                                  policy=f32, plan=plan, **geo)
    res["distill"] = dict(_floats(m), grads=rec.grads, norm=float(rec.norm))
    if tag == "fsdp":
        CheckpointManager(p["ckpt_out"]).save(1, state)
        res["state"] = _to_cpu(state.state_dict())
        fresh = init_distill_state(shard(_wan(p["wan_sd"])),
                                   make_optimizer())
        CheckpointManager(p["ckpt_in"]).restore(target=fresh)
        res["restored"] = _to_cpu(fresh.state_dict())
        res["restored_dtensor"] = isinstance(
            fresh.opt_state["inner"]["mu"]["blocks.0.ffn.0.weight"]
            if "inner" in fresh.opt_state else
            fresh.opt_state["mu"]["blocks.0.ffn.0.weight"], DTensor)

    apt = {k: _t(v) for k, v in p["apt_batch"].items()}
    backbone = shard(_wan(p["teacher_sd"], trainable=False))
    disc = init_apt_discriminator(backbone, torch.Generator().manual_seed(7))
    g_rec, d_rec = Recorder(), Recorder()
    astate = tr.init_apt_state(shard(_wan(p["wan_sd"])), disc, 5e-6, 5e-6)
    kw = dict(apt_cfg=tr.SeaweedAPTConfig(), video=False, policy=f32,
              plan=plan, **geo)
    astate, dm = tr.apt_d_step(astate, apt, torch.Generator().manual_seed(11),
                               d_optimizer=d_rec, **kw)
    astate, gm = tr.apt_g_step(astate, apt, torch.Generator().manual_seed(12),
                               g_optimizer=g_rec, **kw)
    res["apt_d"] = dict(_floats(dm), grads=d_rec.grads, norm=float(d_rec.norm))
    res["apt_g"] = dict(_floats(gm), grads=g_rec.grads, norm=float(g_rec.norm))

    fb = {k: _t(v) for k, v in p["fd_batch"].items()}
    teacher = shard(_wan(p["teacher_sd"], trainable=False))
    mlp = fd.MLPDiscriminator(p["feat"])
    mlp.load_state_dict(p["mlp_sd"])
    s_rec, m_rec = Recorder(), Recorder()
    fstate = fd.init_f_distill_state(shard(_wan(p["wan_sd"])), mlp, s_rec,
                                     m_rec)
    fstate, fm = fd.f_distill_train_step(
        fstate, teacher, plan.put_batch(fb), optimizer=s_rec,
        d_optimizer=m_rec, policy=f32, plan=plan,
        feature_fn=functools.partial(fd.default_feature_fn, dim=p["feat"]),
        **p["fd_kw"], **geo)
    res["f_distill"] = dict(_floats(fm), grads=s_rec.grads,
                            d_grads=m_rec.grads)

    o = p["omni"]
    omodel = build_omni_model(o["cfg"], "cpu", torch.float32, seed=None,
                              trainable=True)
    omodel.load_state_dict(o["sd"])
    o_rec = Recorder(make_omni_optimizer(make_lr_schedule("cosine", 1e-3,
                                                          10)))
    ostate = init_omni_train_state(shard(omodel), o_rec)
    draws = plan.put_batch({k: _t(v) for k, v in o["draws"].items()})
    t, noise = draws.pop("t"), draws.pop("noise")
    ostate, om = omni_train_step(
        ostate, plan.put_batch({k: _t(v) for k, v in o["batch"].items()}),
        draws, t, noise, optimizer=o_rec, policy=f32, plan=plan)
    res["omni"] = dict(_floats(om), grads=o_rec.grads, norm=float(o_rec.norm))
    return res


def train_step_cases(p):
    from omnihuman_tpu_torch.parallel import MeshConfig, create_mesh
    from omnihuman_tpu_torch.parallel.train_mesh import TrainMeshPlan
    out = {}
    for tag, shape in (("data", (2, 1, 2)), ("fsdp", (1, 2, 2))):
        plan = TrainMeshPlan(create_mesh(MeshConfig(*shape)),
                             torch.device("cpu"))
        out[tag] = train_steps(p, plan, tag)
    return out


# ---------------------------------------------------------------------------
# tests/test_torch_sp_cli.py: the four training CLIs on (1, 2, 2)


def train_cli_cases(p):
    import sys
    sys.modules["transformers"] = None     # the hash tokenizer: no import
    from omnihuman_tpu_torch.cli import (
        train_apt, train_distill, train_f_distill, train_omni)
    from omnihuman_tpu_torch.utils import checkpoint as ck
    writes = []
    write = ck.CheckpointManager._write

    def recording(self, step, sd, metadata):
        writes.append((os.path.basename(self.directory), step))
        return write(self, step, sd, metadata)

    ck.CheckpointManager._write = recording
    mesh = ["--task", "tiny-test", "--device", "cpu", "--fsdp_size", "2",
            "--sp_size", "2"]
    data = ["--checkpoint_dir", p["dit"], "--data_path", p["npz"],
            "--batch_size", "2", "--save_interval", "1"]
    d = p["out"]
    out = {}
    state, hist = train_distill.main(
        mesh + data + ["--output_dir", os.path.join(d, "distill"),
                       "--num_epochs", "1", "--remat_group", "2"])
    out["distill"] = {"history": hist, "state": ck._to_cpu(state.state_dict())}
    _, hist = train_f_distill.main(
        mesh + data + ["--output_dir", os.path.join(d, "f_distill"),
                       "--num_epochs", "1"])
    out["f_distill"] = hist
    _, hist = train_apt.main(
        mesh + data + ["--output_dir", os.path.join(d, "apt"),
                       "--consistency_path", os.path.join(d, "distill"),
                       "--image_updates", "1", "--video_updates", "1"])
    out["apt"] = hist
    args = train_omni.build_parser().parse_args(
        ["--config", p["omni_yaml"]] + mesh)
    setup = train_omni.run(args, _omni_samples(p["omni_geometry"]))
    out["omni_step"] = setup.trainer.state.step
    out["writes"] = writes
    return out


def _omni_samples(geo):
    """factory(stage) -> endless one-sample-per-rank batches of 2 samples
    as OmniHumanDataset gives them (frames [3, T, H, W] in [-1, 1], the
    first frame as the reference, audio rows per pixel frame), the same on
    every rank."""
    def factory(stage_idx):
        rng = np.random.default_rng(stage_idx)
        t_px, size, audio_dim = geo
        while True:
            batch = []
            for _ in range(2):
                frames = rng.uniform(-1, 1, (3, t_px, size, size)).astype(
                    np.float32)
                batch.append({"frames": frames, "metadata": {"start": 0},
                              "conditions": {
                                  "text": "a person talking",
                                  "reference": frames[:, :1],
                                  "audio": rng.normal(size=(
                                      t_px, audio_dim)).astype(np.float32)}})
            yield batch
    return factory


# ---------------------------------------------------------------------------
# tests/test_torch_sp_spatial.py: halos, the W-sharded VAE, the H-sharded
# pose in an omni step, one-step and int8 on a mesh


def spatial_cases(p):
    from omnihuman_tpu_torch.models.vae import (
        build_vae, vae_decode, vae_encode)
    from omnihuman_tpu_torch.parallel.spatial import (
        gather_spatial, halo_exchange, shard_bounds)
    world = dist.group.WORLD
    r = dist.get_rank()
    out = {}

    # the collectives and their backward
    x = _t(p["x"])
    bounds = shard_bounds(x.shape[-1], 4)
    s, e = bounds[r]
    xl = x[..., s:e].clone().requires_grad_(True)
    y = halo_exchange(xl, 4, 1, 1, world)
    (y * _t(p["halo_w"][r])).sum().backward()
    out["halo"] = (y.detach(), xl.grad)
    xg = x[..., s:e].clone().requires_grad_(True)
    g = gather_spatial(xg, 4, world, [b - a for a, b in bounds])
    (g * _t(p["gather_w"])).sum().backward()
    out["gather"] = (g.detach(), xg.grad)

    # the W-sharded VAE over the world
    vae = build_vae(p["vae_cfg"], "cpu", torch.float32, seed=None)
    vae.load_state_dict(p["vae_sd"])
    for impl in ("torch", "plain"):
        out[f"decode_{impl}"] = vae_decode(vae, _t(p["z"]), conv_impl=impl,
                                           spatial=world)
        out[f"encode_{impl}"] = vae_encode(vae, _t(p["vid"]), conv_impl=impl,
                                           spatial=world)
    out.update(_omni_pose_step(p["omni"]))
    out.update(_int8_on_fsdp(p))
    out.update(_mesh_clis(p))
    return out


def _omni_pose_step(o):
    """One omni step on (1, 2, 2) with the pose heatmaps H-sharded."""
    from omnihuman_tpu_torch.configs.wan import DTypePolicy
    from omnihuman_tpu_torch.omni.model import build_omni_model
    from omnihuman_tpu_torch.omni.trainer import (
        init_omni_train_state, omni_train_step)
    from omnihuman_tpu_torch.parallel import MeshConfig, create_mesh
    from omnihuman_tpu_torch.parallel.train_mesh import TrainMeshPlan
    plan = TrainMeshPlan(create_mesh(MeshConfig(1, 2, 2)),
                         torch.device("cpu"))
    model = build_omni_model(o["cfg"], "cpu", torch.float32, seed=None,
                             trainable=True)
    model.load_state_dict(o["sd"])
    rec = Recorder()
    state = init_omni_train_state(plan.shard_tree(model, min_size=1), rec)
    batch = plan.put_batch({k: _t(v) for k, v in o["batch"].items()})
    draws = plan.put_batch({k: _t(v) for k, v in o["draws"].items()})
    t, noise = draws.pop("t"), draws.pop("noise")
    _, m = omni_train_step(state, batch, draws, t, noise, optimizer=rec,
                           policy=DTypePolicy(compute=torch.float32),
                           plan=plan)
    return {"omni": dict(_floats(m), grads=rec.grads, norm=float(rec.norm),
                         pose_rows=batch["pose"].shape[3],
                         pose_sharded="pose_sharding" in batch)}


def _int8_on_fsdp(p):
    """The int8 DiT sharded over fsdp 2 (every divisible int8 weight and
    scale on the JAX rule's dimension) against the same model whole, one
    fp32 forward each on the mesh's plan."""
    from omnihuman_tpu_torch.configs.wan import DTypePolicy, TINY_TEST
    from omnihuman_tpu_torch.ops.quant import quantize_wan_model
    from omnihuman_tpu_torch.ops.rope import rope_angles_3d
    from omnihuman_tpu_torch.parallel import (
        MeshConfig, create_mesh, shard_params, use_mesh)
    from torch.distributed.tensor import DTensor
    mesh = create_mesh(MeshConfig(2, 2, 1))
    whole = quantize_wan_model(_wan(p["wan_sd"], trainable=False))
    sharded = shard_params(quantize_wan_model(
        _wan(p["wan_sd"], trainable=False)), mesh, min_size=1)
    sin, cos = rope_angles_3d((2, 4, 4), TINY_TEST.model.head_dim,
                              seq_len=32)
    kw = dict(seq_len=32, rope_sin=sin, rope_cos=cos,
              policy=DTypePolicy(compute=torch.float32))
    args = [_t(p["int8_in"][k]) for k in ("x", "t", "ctx")]
    with torch.no_grad(), use_mesh(mesh):
        got = sharded(*args, **kw)
        want = whole(*args, **kw)
    placed = {n: (x.placements[0].dim, tuple(x.to_local().shape))
              for n, x in sharded.named_parameters()
              if isinstance(x, DTensor) and n.endswith((".w_q", ".w_s"))}
    return {"int8": {"mesh": got, "whole": want, "placed": placed}}


def _mesh_clis(p):
    """cli.generate --one_step on (1, 2, 2) with JAX's noise and context
    patched in (the latents it decodes and the video it writes are kept),
    then --precision int8 with --fsdp_size 2 in cli.generate and
    cli.omni_inference."""
    import sys
    sys.modules["transformers"] = None     # the hash tokenizer: no import
    from omnihuman_tpu_torch.cli import generate, omni_inference
    from omnihuman_tpu_torch.pipelines import text2video, wan_inference
    from omnihuman_tpu_torch.utils import media
    d = p["out_dir"]
    videos, latents = [], []
    real_cache, real_noise = media.cache_video, wan_inference.clip_noise
    real_encode = text2video.WanT2V.encode_text
    real_decode = wan_inference.vae_decode

    def cache(video, path=None, fps=16, **kw):
        videos.append(torch.as_tensor(video).detach().clone())
        return real_cache(video, path, fps=fps, **kw)

    def decode(vae, z, **kw):
        latents.append(z.detach().clone())
        return real_decode(vae, z, **kw)

    media.cache_video = cache
    wan_inference.vae_decode = decode
    wan_inference.clip_noise = (
        lambda seed, i, shape, device: _t(p["one_step_noise"][i]))
    text2video.WanT2V.encode_text = lambda self, prompts: (
        _t(p["one_step_ctx"]).repeat(len(prompts), 1, 1), None)
    mesh = ["--sp_size", "2", "--fsdp_size", "2", "--device", "cpu"]
    out = {}
    try:
        out["one_step"] = generate.main(
            ["--task", "tiny-test", "--one_step", "--ckpt_dir", p["ckpt"],
             "--size", "32*32", "--frame_num", "5", "--base_seed", "7",
             "--save_file", os.path.join(d, "one.mp4")] + mesh)
        out["one_step_video"] = videos[0] if videos else None
        out["one_step_latents"] = latents[0]
    finally:
        wan_inference.clip_noise = real_noise
        wan_inference.vae_decode = real_decode
        text2video.WanT2V.encode_text = real_encode
    out["int8_generate"] = generate.main(
        ["--task", "tiny-test", "--precision", "int8", "--size", "32*32",
         "--frame_num", "5", "--sample_steps", "1",
         "--save_file", os.path.join(d, "int8.mp4")] + mesh)
    out["int8_omni"] = omni_inference.main(
        ["--task", "tiny-test", "--reference_image", p["image"],
         "--precision", "int8", "--size", "32*32", "--num_frames", "2",
         "--num_inference_steps", "1",
         "--output", os.path.join(d, "omni_int8.mp4")] + mesh)
    media.cache_video = real_cache
    return out


CASES = {"attention": attention_cases, "dit": dit_cases, "mesh": mesh_cases,
         "attention_grads": attention_grad_cases,
         "train_steps": train_step_cases, "train_clis": train_cli_cases,
         "spatial": spatial_cases}
