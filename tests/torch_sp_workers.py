"""Multi-process gloo runs of the port's sequence-parallel / FSDP code for
tests/test_torch_{ring_attention,mesh,sp_model}.py.

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
        with torch.no_grad(), use_mesh(mesh):
            for impl in ("ring", "ulysses"):
                out[f"{kind}_{impl}"] = model(
                    _t(d["x"]), _t(d["t"]), _t(d["ctx"]), attn_impl=impl,
                    token_sharding=mesh["sp"], **kw)
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
        MeshConfig, create_mesh, infer_param_specs, shard_params)
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
    with torch.no_grad():
        out["fsdp_forward"] = model(
            _t(p["x"]), _t(p["t"]), _t(p["ctx"]), seq_len=32, rope_sin=sin,
            rope_cos=cos, policy=cfg.policy)

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
    out["plan"] = (pipe.attn_impl, pipe.sp_size, pipe.t5_auto_unload)
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


CASES = {"attention": attention_cases, "dit": dit_cases, "mesh": mesh_cases}
