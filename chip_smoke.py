#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py        # from the root of a checkout; needs one GPU

Phases (any failure stops the run with a nonzero exit):
  1. card facts: name and power limit (nvidia-smi), torch / CUDA / nvcc
     versions, whether triton imports;
  2. build every kernel in omnihuman_tpu_torch/csrc/ with nvcc (sm_90a),
     one nvcc per source, all in parallel;
  3. every kernel against its plain PyTorch version on the card, in bf16,
     at the main path's shapes (flagship geometry: 480x832, 81 frames,
     32,760 tokens padded to 32,768; text context trimmed to 128 / 512):
     max abs error against the stated tolerance, kernel / plain /
     SDPA-yardstick times (CUDA events, warm, median of 7) and the bound;
  4. a small-input reference: the DiT forward and the VAE decode on the
     card against the same weights on the CPU (the CPU path is the one the
     test suite holds against the JAX package);
  5. the main path: `WanT2V` for t2v-1.3B at full width (dim 1536, 30
     layers, 12 heads, umT5-xxl), random bf16 weights from a seed,
     precision "fast", answers 2 requests through `generate()` at 480x832,
     cut to 17 frames (7,800 tokens padded to 8,192) and 4 UniPC steps.
     The head gets random weights (the reference zero-inits it, which
     would make every velocity 0). Launch counts are zeroed just before
     and read just after: every attention of the DiT must have gone
     through the kernel. Then one CFG step of that model at that geometry
     with attention through the kernel, held against the same step with
     attention through the plain version;
  6. one warm CFG step at the flagship geometry (latents [1,16,21,60,104]),
     timed, then once more under torch.profiler for its kernel-time split;
  7. the fused backward kernel (flash_bwd.cu, K2) and the forward's LSE
     against their plain versions, B=1, N=12, D=128, bf16, tolerance 2^-6
     of each gradient's own peak: (a) self-attention 32,768 tokens, k_len
     32,760; (b) cross-attention Lq=32,768, Lc=512, no lengths, and with
     k_lens (37, 512) at B=2; (c) Lk=257; (d) a k_len=0 row (gradients
     exactly 0); (e) ragged Lq=1000, Lk=777, causal, window and offsets;
     (f, g) the training CLIs' 1,560 tokens. Keys past k_len get exactly
     zero dK / dV. The kernel's ms alone and with its wrapper (delta, the
     fp32 dQ accumulator's zero-fill and cast), its five-product bound,
     plain ms, and the SDPA backward on the unmasked shape as a yardstick;
  8. the training main path at full width (t2v-1.3B, random weights from a
     seed with a random head, written as a reference `*.safetensors`
     checkpoint directory): `cli.teacher_data` writes 2 samples at 480x832
     (1,560 tokens), then `cli.train_distill` runs 1 epoch at batch 1 (2
     steps, per-block remat) with a checkpoint, which is restored and held
     bit-equal (parameters, EMA, AdamW state). Launch counts are zeroed
     before each CLI and read after it: every attention forward, recompute
     and backward went through K1 and K2 (one K2 launch per attention
     backward, 60 a step);
  9. one distill step at full width and 1,560 tokens, kernels against plain
     attention (relative L2 error of the loss and the gradients, tolerance
     5e-2), and the share of parameter elements one bf16 AdamW step
     changes;
 10. one timed distill step at 81 frames (32,760 tokens, per-block remat,
     batch 1) after one warm-up, its peak memory and a torch.profiler split;
 11. one APT D step and one APT G step at full width and 1,560 tokens: the
     losses, and the K2 launches (the G step's gradient flows through the
     discriminator's frozen backbone, so it launches K2; the D step's
     features are cut, so it does not);
 12. the VAE kernels (vae_conv.cu K3, vae_upsample.cu K4) against their
     plain versions at every distinct full-width shape of an 81-frame
     480x832 decode and encode (first-chunk T=1 shapes included), bf16,
     tolerance 2^-6 of the output's peak: kernel / plain / cuDNN-yardstick
     times (F.conv3d on the activated input for K3, F.conv2d on the
     upsampled input for K4) and the bound;
 13. the full-width VAE at 81 frames, 480x832: vae_decode and vae_encode
     through the kernels ("cuda") and through cuDNN ("torch"), relative L2
     between them, wall times, peak memory, and the launch counts, which
     must be 588 K3 / 63 K4 for the decode and 420 K3 for the encode;
 14. the i2v main path: `WanI2V` for i2v-14B at full width (dim 5120, 40
     layers, 40 heads, in_dim 36; CLIP ViT-H/14; umT5-xxl; Wan 2.1 VAE),
     random bf16 weights from a seed with a random head, one seeded
     480x832 image through `generate()`, cut to 17 frames and 3 steps:
     every DiT attention (self, text and image cross-attention) through
     K1, every resblock conv through K3 and every upsample through K4, at
     the counts the code implies; per-stage seconds;
 15. one-step: `SeaweedWanAPTGenerator` over t2v-1.3B, 2 prompts, 81
     frames, one batched forward and the batched decode through K3 / K4.

The line before last is a JSON object {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import copy
import gc
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(HERE, "_dev", "chip_smoke_work")   # git-ignored scratch

PEAK_BF16_FLOPS = 989e12      # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12          # H100 SXM HBM3
FLAGSHIP = dict(frames=81, size=(832, 480), tokens=32760, seq_len=32768)
SMOKE = dict(frames=17, size=(832, 480), steps=4, requests=(
    ("a red fox running through fresh snow at sunrise, cinematic", 11),
    ("two astronauts playing chess on the moon, wide shot", 23)))
NUM_LAYERS = 30


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def bench_ms(fn, reps: int = 7, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def attention_bound(b, lq, n, d, k_valid):
    """Least time the card could take: Q read and O written once, the valid
    K/V rows read once; 4*Lq*D FLOP per (query, valid key, head)."""
    keys = sum(k_valid)
    flops = 4.0 * n * lq * d * keys
    nbytes = 2.0 * (2 * b * lq * n * d + 2 * keys * n * d)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def phase_card_facts():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    from omnihuman_tpu_torch.ops import cuda_build
    nvcc = subprocess.run([cuda_build.find_nvcc(), "--version"],
                          capture_output=True, text=True, timeout=60)
    try:
        import triton
        triton_v = triton.__version__
    except ImportError:
        triton_v = "not importable"
    log(f"[1] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"nvcc: {nvcc.stdout.strip().splitlines()[-1]}, triton {triton_v}, "
        f"python {sys.version.split()[0]}")
    log(f"[1] device: {torch.cuda.get_device_name(0)}, "
        f"count {torch.cuda.device_count()}")
    return card


def phase_build():
    from omnihuman_tpu_torch.ops import cuda_build
    sources = sorted(f for f in os.listdir(cuda_build.CSRC_DIR)
                     if f.endswith(".cu"))
    t0 = time.perf_counter()
    cuda_build.build(sources)
    log(f"[2] built {sources} in {time.perf_counter() - t0:.1f} s")
    for s in sources:
        for line in cuda_build.build_log(s).splitlines():
            if "registers" in line or "spill" in line:
                log(f"[2]   {s}: {line.strip()}")


def phase_kernels():
    """Returns {kernel name: measurement row} for the JSON line."""
    import torch
    import torch.nn.functional as F
    from omnihuman_tpu_torch.ops.flash_attention import (
        flash_attention_cuda, flash_attention_plain)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1234)
    n, d = 12, 128
    L = FLAGSHIP["seq_len"]

    def rnd(b, l):
        return torch.randn((b, l, n, d), generator=gen, device=dev
                           ).to(torch.bfloat16)

    q_big = rnd(2, L)
    cases = [
        # name, q, lk, k_lens, library mask expressible, JSON row
        ("a self-attention L=32768 k_len=32760", q_big, L, (32760, 32760),
         True, "long"),
        ("b1 cross-attention Lq=32768 Lc=128 k_lens=(37,512)", q_big, 128,
         (37, 512), True, "short"),
        ("b2 cross-attention Lq=32768 Lc=512 k_lens=(37,512)", q_big, 512,
         (37, 512), True, None),
        ("c Lq=32768 Lk=257 no k_lens", q_big, 257, None, True, None),
        ("d k_len=0 row Lq=4096 Lk=512 k_lens=(512,0)", rnd(2, 4096), 512,
         (512, 0), False, None),
        ("e ragged Lq=1000 Lk=777", rnd(2, 1000), 777, None, True, None),
    ]
    rows = {}
    for name, q, lk, k_lens, lib_ok, row in cases:
        b, lq = q.shape[0], q.shape[1]
        k, v = rnd(b, lk), rnd(b, lk)
        kl = (None if k_lens is None else
              torch.tensor(k_lens, dtype=torch.int32, device=dev))
        got = flash_attention_cuda(q, k, v, k_lens=kl)
        torch.cuda.synchronize()
        want = flash_attention_plain(q, k, v, k_lens=kl)
        if not torch.isfinite(got.float()).all():
            fail(f"kernel output not finite in case {name}")
        err = (got.float() - want.float()).abs().max().item()
        # bf16 output: the two versions may round one ulp apart; 2^-6 of
        # the output's own peak is two ulps there
        tol = 2 ** -6 * want.float().abs().max().item()
        if err > tol:
            fail(f"kernel vs plain: max abs err {err} > {tol} in {name}")
        if k_lens is not None and 0 in k_lens:
            zero_row = got[list(k_lens).index(0)]
            if zero_row.abs().max().item() != 0.0:
                fail("a row with k_len=0 is not exactly 0")
        k_valid = [min(x, lk) for x in (k_lens or (lk,) * b)]
        bound, bound_by = attention_bound(b, lq, n, d, k_valid)
        ms = bench_ms(lambda: flash_attention_cuda(q, k, v, k_lens=kl))
        plain_ms = bench_ms(
            lambda: flash_attention_plain(q, k, v, k_lens=kl), reps=3,
            warmup=1)
        lib_ms = None
        if lib_ok:    # yardstick only: the port never calls SDPA
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            mask = None
            if kl is not None:
                mask = (torch.arange(lk, device=dev)[None, :]
                        < kl.clamp(max=lk)[:, None])[:, None, None, :]
            lib_ms = bench_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask))
        log(f"[3] {name}: max_abs_err {err:.3g} (tol {tol:.3g}), kernel "
            f"{ms:.3f} ms, bound {bound:.3f} ms ({bound_by}), plain "
            f"{plain_ms:.3f} ms, SDPA {lib_ms if lib_ms is None else round(lib_ms, 3)} ms")
        if row is not None:
            rows[row] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             bound_ms=bound, bound_by=bound_by,
                             library_ms=lib_ms)
        del k, v, got, want
        torch.cuda.empty_cache()
    return rows


def phase_small_reference():
    """The DiT forward and the VAE decode on the card vs the CPU, on the
    same small weights and inputs. The card runs attention in the kernel
    (bf16), the CPU in the plain version (the path the CPU tests hold
    against JAX). TF32 is off for the fp32 VAE comparison."""
    import torch
    from omnihuman_tpu_torch.configs.wan import TINY_TEST, TINY_TEST_HD128
    from omnihuman_tpu_torch.models.vae import build_vae, vae_decode
    from omnihuman_tpu_torch.models.wan_dit import build_wan_model
    from omnihuman_tpu_torch.ops.rope import rope_angles_3d

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = TINY_TEST_HD128.model
    gen = torch.Generator().manual_seed(7)
    outs = {}
    for device in ("cpu", "cuda"):
        model = build_wan_model(cfg, "cpu", torch.bfloat16, seed=3)
        with torch.no_grad():
            model.head.head.weight.normal_(0.0, 0.05,
                                           generator=torch.Generator(
                                           ).manual_seed(5))
        model = model.to(device)
        gen.manual_seed(7)
        x = torch.randn((2, 16, 3, 8, 8), generator=gen)
        ctx = torch.randn((2, 16, 32), generator=gen)
        sin, cos = rope_angles_3d((3, 4, 4), cfg.head_dim, seq_len=64)
        with torch.inference_mode():
            v = model(x.to(device), torch.tensor([900.0, 300.0]).to(device),
                      ctx.to(device), seq_len=64, rope_sin=sin.to(device),
                      rope_cos=cos.to(device),
                      context_lens=torch.tensor([9, 4]).to(device))
        outs[device] = v.float().cpu()
    err = (outs["cuda"] - outs["cpu"]).abs().max().item()
    scale = outs["cpu"].abs().max().item()
    if not torch.isfinite(outs["cuda"]).all() or err > 5e-2 * max(1.0, scale):
        fail(f"DiT forward on the card vs the CPU: max abs err {err} "
             f"(output scale {scale})")
    log(f"[4] DiT forward (head_dim 128, bf16) card vs CPU: max abs err "
        f"{err:.3g} on outputs up to {scale:.3g} (tol 5e-2 x scale)")

    vouts = {}
    z = torch.randn((1, 16, 3, 4, 6), generator=gen.manual_seed(9))
    for device in ("cpu", "cuda"):
        vae = build_vae(TINY_TEST.vae, "cpu", torch.float32, seed=4).to(device)
        with torch.inference_mode():   # fp32 at 8 channels: the torch path
            vouts[device] = vae_decode(vae, z.to(device),
                                       conv_impl="torch").cpu()
    err = (vouts["cuda"] - vouts["cpu"]).abs().max().item()
    if err > 1e-3:
        fail(f"VAE decode on the card vs the CPU: max abs err {err}")
    log(f"[4] VAE decode (fp32, TF32 off) card vs CPU: max abs err "
        f"{err:.3g} (tol 1e-3)")


def phase_main_path(kernels):
    import torch
    from omnihuman_tpu_torch.configs import T2V_1_3B
    from omnihuman_tpu_torch.pipelines.text2video import WanT2V

    t0 = time.perf_counter()
    pipe = WanT2V(T2V_1_3B, device="cuda", precision="fast", init_seed=0)
    with torch.no_grad():    # unit-scale velocities instead of all zeros
        pipe.model.head.head.weight.normal_(
            0.0, T2V_1_3B.model.dim ** -0.5,
            generator=torch.Generator(device="cuda").manual_seed(5))
    torch.cuda.synchronize()
    log(f"[5] WanT2V(t2v-1.3B) built with random bf16 weights in "
        f"{time.perf_counter() - t0:.1f} s")
    w, h = SMOKE["size"]
    frames, steps = SMOKE["frames"], SMOKE["steps"]

    for kn in kernels:
        kn.launches = 0
    for prompt, seed in SMOKE["requests"]:
        t0 = time.perf_counter()
        video = pipe.generate(prompt, size=(w, h), frame_num=frames,
                              sampling_steps=steps, seed=seed)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        if tuple(video.shape) != (3, frames, h, w):
            fail(f"video shape {tuple(video.shape)} != {(3, frames, h, w)}")
        vf = video.float()
        if not torch.isfinite(vf).all():
            fail("video holds non-finite values")
        if vf.min().item() < -1.0 or vf.max().item() > 1.0:
            fail("video values outside [-1, 1]")
        if next(pipe._t5.parameters()).device.type != "cpu":
            fail("the text encoder stayed on the card after the request")
        t = pipe.timings
        log(f"[5] request seed={seed}: video {tuple(video.shape)} in "
            f"[{vf.min().item():.3f}, {vf.max().item():.3f}], std "
            f"{vf.std().item():.3f}; total {total:.2f} s: T5 load "
            f"{t.get('t5_load_s', 0):.2f} s, T5 encode "
            f"{t['t5_encode_s']:.2f} s, T5 unload {t['t5_unload_s']:.2f} s, "
            f"{steps} CFG steps "
            f"{t['denoise_s']:.2f} s ({t['denoise_s'] / steps * 1e3:.1f} "
            f"ms/step), VAE decode {t['vae_decode_s']:.2f} s")
    launches = [kn.launches for kn in kernels]
    want = NUM_LAYERS * steps * len(SMOKE["requests"])
    log(f"[5] kernel launches on the main path: "
        f"{dict(zip([kn.name for kn in kernels], launches))}, "
        f"expected {want} each (2 requests x {steps} steps x 30 layers, "
        f"cond+uncond in one batch)")
    if launches != [want] * len(kernels):
        fail("the main path did not send every attention through the kernel")
    n_tok = (frames - 1) // 4 + 1
    log(f"[5] latents [16,{n_tok},{h // 8},{w // 8}] -> "
        f"{n_tok * (h // 16) * (w // 16)} tokens, seq_len "
        f"{pipe.seq_len_for((16, n_tok, h // 8, w // 8))}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[5] peak device memory so far {peak:.1f} GiB")
    return pipe, launches


def phase_step_vs_plain(pipe):
    """One CFG step of the main path's model (full width, the smoke's
    geometry) with attention through the kernel, against the same step on
    the same weights and inputs with attention through the plain version.
    Its kernel launches come after the main path's counts were read."""
    import torch
    from unittest import mock
    from omnihuman_tpu_torch.ops import attention
    from omnihuman_tpu_torch.ops.flash_attention import flash_attention_plain
    from omnihuman_tpu_torch.ops.rope import rope_angles_3d
    from omnihuman_tpu_torch.pipelines.text2video import cfg_model_step

    dev = pipe.device
    lat = pipe.latent_shape(SMOKE["size"], SMOKE["frames"])
    seq_len = pipe.seq_len_for(lat)
    grid = tuple(n // p for n, p in zip(lat[1:], pipe.patch_size))
    gen = torch.Generator(device=dev).manual_seed(77)
    x = torch.randn((1,) + lat, generator=gen, device=dev)
    ctx2 = torch.randn((2, 128, 4096), generator=gen, device=dev)
    lens = torch.tensor([37, 12], dtype=torch.int32, device=dev)
    sin, cos = rope_angles_3d(grid, 128, seq_len=seq_len, device=dev)

    def step():
        with torch.inference_mode():
            return cfg_model_step(pipe.model, x, 900.0, ctx2, sin, cos, lens,
                                  policy=pipe.policy, seq_len=seq_len,
                                  guide_scale=5.0).float()

    got = step()
    with mock.patch.object(attention, "flash_fwd", flash_attention_plain):
        want = step()
    if not torch.isfinite(got).all():
        fail("full-width CFG step through the kernel is not finite")
    rel = ((got - want).norm() / want.norm()).item()
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    log(f"[5] full-width CFG step ({seq_len} tokens, bf16), kernel vs plain "
        f"attention: relative L2 error {rel:.3g} (tol 5e-2), max abs err "
        f"{err:.3g} on velocities up to {scale:.3g}, velocity std "
        f"{want.std().item():.3g}")
    if rel > 5e-2:
        fail(f"full-width CFG step: kernel vs plain relative error {rel}")


def phase_flagship_step(pipe):
    import torch
    from omnihuman_tpu_torch.ops.rope import rope_angles_3d
    from omnihuman_tpu_torch.pipelines.text2video import cfg_model_step

    dev = pipe.device
    lat = pipe.latent_shape(FLAGSHIP["size"], FLAGSHIP["frames"])
    seq_len = pipe.seq_len_for(lat)
    if seq_len != FLAGSHIP["seq_len"] or lat != (16, 21, 60, 104):
        fail(f"flagship geometry {lat} / {seq_len} unexpected")
    gen = torch.Generator(device=dev).manual_seed(99)
    x = torch.randn((1,) + lat, generator=gen, device=dev)
    ctx2 = torch.randn((2, 128, 4096), generator=gen, device=dev)
    lens = torch.tensor([37, 12], dtype=torch.int32, device=dev)
    sin, cos = rope_angles_3d((21, 30, 52), 128, seq_len=seq_len, device=dev)

    def step():
        with torch.inference_mode():
            return cfg_model_step(pipe.model, x, 900.0, ctx2, sin, cos, lens,
                                  policy=pipe.policy, seq_len=seq_len,
                                  guide_scale=5.0)

    v = step()
    torch.cuda.synchronize()
    if not torch.isfinite(v).all():
        fail("flagship CFG step output not finite")
    ms = bench_ms(step, reps=3, warmup=1)
    bound = NUM_LAYERS * attention_bound(2, seq_len, 12, 128,
                                         [FLAGSHIP["tokens"]] * 2)[0]
    log(f"[6] flagship CFG step (latents [1,16,21,60,104], "
        f"{FLAGSHIP['tokens']} tokens, seq_len {seq_len}, fused batch 2): "
        f"{ms:.1f} ms; self-attention bound alone {bound:.1f} ms "
        f"(30 layers); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB")

    # where the step's device time goes, by kernel (torch.profiler/CUPTI)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in kernels) / 1e3
    if total == 0:
        log("[6] profiler: no device time recorded")
        return
    groups = {"flash_fwd (port kernel)": 0.0, "GEMM (cuBLAS)": 0.0,
              "other (elementwise, norms, copies)": 0.0}
    for e in kernels:
        t = e.self_device_time_total / 1e3
        name = e.key.lower()
        if "flash_fwd" in name:
            groups["flash_fwd (port kernel)"] += t
        elif any(s in name for s in ("gemm", "xmma", "cutlass", "cublas",
                                     "nvjet")):
            groups["GEMM (cuBLAS)"] += t
        else:
            groups["other (elementwise, norms, copies)"] += t
    log(f"[6] profiled step: {total:.1f} ms of kernel time: " + ", ".join(
        f"{k} {v:.1f} ms ({100 * v / total:.1f}%)" for k, v in groups.items()))
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"[6]   {e.self_device_time_total / 1e3:9.1f} ms "
            f"x{e.count:<5d} {e.key[:90]}")


def backward_bound(q_rows, k_rows, pairs, n, d):
    """Least time of the attention backward: five matmuls (S and dP once,
    dV, dK, dQ) of 2*D FLOP per (query, visible key) pair and head; bytes:
    q, dO, k, v read once and dq, dk, dv written once (bf16), plus the fp32
    LSE and delta. Returns (ms, "operations" | "bytes")."""
    flops = 2.0 * 5 * n * d * pairs
    nbytes = 2.0 * n * d * (3 * q_rows + 4 * k_rows) + 8.0 * q_rows * n
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def visible_pairs(b, lq, lk, k_lens, mkw, dev):
    """(query, key) pairs the mask lets through, summed over the batch."""
    import torch
    from omnihuman_tpu_torch.ops.flash_attention import _index_mask
    pairs = 0
    ok = _index_mask(0, lq, lq, lk, mkw.get("causal", False),
                     mkw.get("window_size", (-1, -1)), mkw.get("offsets"),
                     dev)
    for i in range(b):
        kv = lk if k_lens is None else min(k_lens[i], lk)
        if ok is None:
            pairs += lq * kv
        else:
            pairs += int(ok[:, :kv].sum())
    return pairs


def phase_backward_kernels():
    """Returns the measurement of K2's JSON row (case a)."""
    import torch
    import torch.nn.functional as F
    from omnihuman_tpu_torch.ops.flash_attention import (
        _clamped_lens, bwd_delta, flash_attention_cuda, flash_attention_plain,
        flash_bwd_cuda, flash_bwd_launch, flash_bwd_plain)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4321)
    n, d = 12, 128
    L = FLAGSHIP["seq_len"]

    def rnd(b, l):
        return torch.randn((b, l, n, d), generator=gen, device=dev
                           ).to(torch.bfloat16)

    cases = [
        # name, B, Lq, Lk, k_lens, mask kwargs, SDPA yardstick
        ("a self-attention L=32768 k_len=32760", 1, L, L, (32760,), {}, True),
        ("b1 cross-attention Lq=32768 Lc=512", 1, L, 512, None, {}, True),
        ("b2 cross-attention Lq=32768 Lc=512 k_lens=(37,512)", 2, L, 512,
         (37, 512), {}, False),
        ("c Lq=32768 Lk=257", 1, L, 257, None, {}, True),
        ("d k_len=0 row Lq=4096 Lk=512 k_lens=(512,0)", 2, 4096, 512,
         (512, 0), {}, False),
        ("e ragged Lq=1000 Lk=777 causal window offsets", 1, 1000, 777,
         None, dict(causal=True, window_size=(300, 20), offsets=(40, 7)),
         False),
        # the shapes the training CLIs run (1,560 tokens: ragged last tiles)
        ("f training self-attention Lq=Lk=1560", 1, 1560, 1560, None, {},
         True),
        ("g training cross-attention Lq=1560 Lc=512", 1, 1560, 512, None, {},
         True),
    ]
    rows = {}
    for name, b, lq, lk, k_lens, mkw, lib_ok in cases:
        q, k, v, dout = rnd(b, lq), rnd(b, lk), rnd(b, lk), rnd(b, lq)
        kl = (None if k_lens is None else
              torch.tensor(k_lens, dtype=torch.int32, device=dev))
        out, lse = flash_attention_cuda(q, k, v, k_lens=kl, return_lse=True,
                                        **mkw)
        torch.cuda.synchronize()
        want_out, want_lse = flash_attention_plain(q, k, v, k_lens=kl,
                                                   return_lse=True, **mkw)
        if not torch.equal(out, flash_attention_cuda(q, k, v, k_lens=kl,
                                                     **mkw)):
            fail(f"forward with and without the LSE differ in {name}")
        lse_err = (lse - want_lse).abs().max().item()
        if lse_err > 1e-3:
            fail(f"LSE kernel vs plain: {lse_err} > 1e-3 in {name}")
        got = flash_bwd_cuda(q, k, v, out, lse, dout, k_lens=kl, **mkw)
        torch.cuda.synchronize()
        want = flash_bwd_plain(q, k, v, out, lse, dout, k_lens=kl, **mkw)
        errs = []
        for gname, a, w in zip(("dq", "dk", "dv"), got, want):
            if not torch.isfinite(a.float()).all():
                fail(f"{gname} not finite in {name}")
            err = (a.float() - w.float()).abs().max().item()
            tol = 2 ** -6 * w.float().abs().max().item()
            if err > tol:
                fail(f"{gname} kernel vs plain: {err} > {tol} in {name}")
            errs.append((gname, err, tol))
        if k_lens is not None:
            for i, kv in enumerate(k_lens):
                if kv == 0 and any(x[i].abs().max().item() != 0.0
                                   for x in got):
                    fail("a row with k_len=0 has a nonzero gradient")
                if kv < lk and (got[1][i, kv:].abs().max().item() != 0.0
                                or got[2][i, kv:].abs().max().item() != 0.0):
                    fail(f"keys past k_len have nonzero dK / dV in {name}")
        # the kernel alone on preallocated outputs, then the whole wrapper
        klc = _clamped_lens(kl, b, lk, dev)
        delta = bwd_delta(out, dout)
        mask = dict(softmax_scale=None, **mkw)
        dq_acc = torch.zeros(q.shape, dtype=torch.float32, device=dev)
        dk_buf, dv_buf = torch.empty_like(k), torch.empty_like(v)
        kernel_ms = bench_ms(lambda: flash_bwd_launch(
            q, k, v, dout, lse, delta, klc, dq_acc, dk_buf, dv_buf, **mask))
        bwd_ms = bench_ms(lambda: flash_bwd_cuda(
            q, k, v, out, lse, dout, k_lens=kl, **mkw))
        fwd_lse_ms = bench_ms(lambda: flash_attention_cuda(
            q, k, v, k_lens=kl, return_lse=True, **mkw))
        plain_ms = bench_ms(lambda: flash_bwd_plain(
            q, k, v, out, lse, dout, k_lens=kl, **mkw), reps=1, warmup=0)
        lib_ms = lse_lib_ms = None
        if lib_ok:   # yardstick only: the port never calls SDPA
            qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                          for x in (q, k, v))
            # the library's forward that also returns the LSE (unmasked);
            # a yardstick only, so a missing private op is logged, not fatal
            try:
                lse_lib_ms = bench_ms(
                    lambda: torch.ops.aten._scaled_dot_product_flash_attention(
                        qt.detach(), kt.detach(), vt.detach()))
            except (RuntimeError, AttributeError) as e:
                log(f"[7] library forward with LSE not measured: {e}")
            ot = F.scaled_dot_product_attention(qt, kt, vt)
            dt = dout.transpose(1, 2)
            lib_ms = bench_ms(lambda: torch.autograd.grad(
                ot, (qt, kt, vt), dt, retain_graph=True))
            del qt, kt, vt, ot
        pairs = visible_pairs(b, lq, lk, k_lens, mkw, dev)
        bound, by = backward_bound(b * lq, b * lk, pairs, n, d)
        log(f"[7] {name}: " + ", ".join(
            f"{g} err {e:.3g} (tol {t:.3g})" for g, e, t in errs)
            + f", LSE err {lse_err:.3g}; forward with LSE {fwd_lse_ms:.3f} "
            f"ms (library forward with LSE "
            f"{lse_lib_ms if lse_lib_ms is None else round(lse_lib_ms, 3)} "
            f"ms); K2 kernel {kernel_ms:.3f} ms, with its wrapper "
            f"{bwd_ms:.3f} ms (bound {bound:.3f}, {by}), plain backward "
            f"{plain_ms:.1f} ms, SDPA backward "
            f"{lib_ms if lib_ms is None else round(lib_ms, 3)} ms")
        if name.startswith("a "):
            rows["k2"] = dict(max_abs_err=max(e for _, e, _ in errs),
                              ms=bwd_ms, kernel_ms=kernel_ms,
                              plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                              library_ms=lib_ms)
        del q, k, v, dout, out, lse, got, want, want_out, want_lse, delta
        del dq_acc, dk_buf, dv_buf
        torch.cuda.empty_cache()
    return rows


def _count(kernels):
    return {kn.name: kn.launches for kn in kernels}


def _zero(kernels):
    for kn in kernels:
        kn.launches = 0


def phase_training_main_path(kernels):
    """teacher_data, then train_distill, through their CLI main()s; returns
    {path: {kernel: launches}} and the path of the teacher data."""
    import torch
    from safetensors.torch import save_file
    from omnihuman_tpu_torch.cli import teacher_data, train_distill
    from omnihuman_tpu_torch.configs import T2V_1_3B
    from omnihuman_tpu_torch.models.wan_dit import build_wan_model
    from omnihuman_tpu_torch.utils.checkpoint import CheckpointManager

    shutil.rmtree(WORK, ignore_errors=True)
    dit_dir = os.path.join(WORK, "dit")
    os.makedirs(dit_dir)
    t0 = time.perf_counter()
    model = build_wan_model(T2V_1_3B.model, "cuda", torch.bfloat16, seed=0)
    with torch.no_grad():    # the reference zero-inits the head: v = 0
        model.head.head.weight.normal_(
            0.0, T2V_1_3B.model.dim ** -0.5,
            generator=torch.Generator(device="cuda").manual_seed(5))
    save_file({k: v.cpu() for k, v in model.state_dict().items()},
              os.path.join(dit_dir, "diffusion_pytorch_model.safetensors"))
    del model
    log(f"[8] random t2v-1.3B DiT (seed 0, random head) written as a "
        f"reference checkpoint in {time.perf_counter() - t0:.1f} s")

    counts = {}
    _zero(kernels)
    t0 = time.perf_counter()
    data = teacher_data.main([
        "--task", "t2v-1.3B", "--num_samples", "2", "--size", "480*832",
        "--out_dir", WORK, "--checkpoint_dir", dit_dir])
    torch.cuda.synchronize()
    counts["teacher_data"] = _count(kernels)
    gc.collect()
    torch.cuda.empty_cache()
    vt = data["v_teacher"]
    log(f"[8] cli.teacher_data: 2 samples at 480x832 in "
        f"{time.perf_counter() - t0:.1f} s; v_teacher {vt.shape} std "
        f"{vt.std():.3g}; launches {counts['teacher_data']}")
    if not (vt.shape == (2, 16, 1, 60, 104) and abs(vt).max() > 0):
        fail("teacher data has the wrong shape or is all zeros")
    want = [NUM_LAYERS, NUM_LAYERS, 0]
    if list(counts["teacher_data"].values()) != want:
        fail(f"teacher_data launches {counts['teacher_data']}, want {want}")

    npz = os.path.join(WORK, "dummy_data_480x832.npz")
    out = os.path.join(WORK, "distill")
    torch.cuda.reset_peak_memory_stats()
    _zero(kernels)
    t0 = time.perf_counter()
    state, history = train_distill.main([
        "--task", "t2v-1.3B", "--data_path", npz, "--output_dir", out,
        "--num_epochs", "1", "--batch_size", "1",
        "--checkpoint_dir", dit_dir])
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    counts["train_distill"] = _count(kernels)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for h in history:
        log(f"[8] distill step {h['step']}: loss {h['loss']:.6g}, grad norm "
            f"{h['grad_norm']:.6g}, {h['seconds']:.3f} s")
        if not (h["loss"] > 0 and h["grad_norm"] > 0):
            fail("a distill step has a zero or non-finite loss / gradient")
    steps = len(history)
    want = [2 * NUM_LAYERS * steps] * 3
    log(f"[8] cli.train_distill: {steps} steps in {total:.1f} s (with model "
        f"build and the checkpoint save), peak device memory {peak:.1f} GiB;"
        f" launches {counts['train_distill']}, expected {want} (per step: "
        f"30 layers x self + cross attention, K1 forward + remat recompute, "
        f"one K2 each)")
    if steps != 2 or list(counts["train_distill"].values()) != want:
        fail("the training path did not send every attention forward, "
             "recompute and backward through K1 and K2")

    t0 = time.perf_counter()
    mgr = CheckpointManager(out)
    if mgr.all_steps() != [2] or mgr.restore_metadata() != {"epoch": 0}:
        fail(f"checkpoint steps {mgr.all_steps()} / metadata unexpected")
    restored = mgr.restore()
    live = state.state_dict()
    n_bytes = 0

    def same(a, b, where):
        nonlocal n_bytes
        if isinstance(a, dict):
            if set(a) != set(b):
                fail(f"restored keys differ at {where}")
            for key in a:
                same(a[key], b[key], f"{where}/{key}")
        elif isinstance(a, torch.Tensor):
            n_bytes += a.numel() * a.element_size()
            if a.dtype != b.dtype or not torch.equal(a, b.cpu()):
                fail(f"restored tensor differs at {where}")
        elif a != b:
            fail(f"restored value differs at {where}: {a} != {b}")

    same(restored, live, "state")
    log(f"[8] checkpoint of step 2 ({n_bytes / 2 ** 30:.2f} GiB: bf16 "
        f"parameters, EMA, AdamW mu and nu) restored bit-equal in "
        f"{time.perf_counter() - t0:.1f} s")
    del state, restored, live
    gc.collect()
    torch.cuda.empty_cache()
    return counts, npz


def _param_grads(model, batch, seq_len, sin, cos, policy):
    import torch
    from omnihuman_tpu_torch.apt.distill import distill_loss, trainable_params
    params = list(trainable_params(model).values())
    loss = distill_loss(model, batch, seq_len=seq_len, rope_sin=sin,
                        rope_cos=cos, policy=policy, remat=True)
    return loss.detach(), torch.autograd.grad(loss, params)


def phase_distill_vs_plain(npz, kernels):
    """One distill loss + gradient at full width, 1,560 tokens, with the
    kernels and with plain attention; then the share of elements one AdamW
    step changes. Returns the model for the later phases."""
    import torch
    from unittest import mock
    from omnihuman_tpu_torch.apt.distill import (
        distill_train_step, init_distill_state, make_optimizer,
        trainable_params)
    from omnihuman_tpu_torch.apt.generate import (
        create_dataloader, load_teacher_data)
    from omnihuman_tpu_torch.configs import T2V_1_3B
    from omnihuman_tpu_torch.models.wan_dit import build_wan_model
    from omnihuman_tpu_torch.ops import flash_attention as fa
    from omnihuman_tpu_torch.ops.rope import rope_angles_3d
    from omnihuman_tpu_torch.utils.convert import load_wan_dit_checkpoint

    cfg = T2V_1_3B
    model = build_wan_model(cfg.model, "cuda", torch.bfloat16, seed=None,
                            trainable=True)
    load_wan_dit_checkpoint(model, os.path.join(WORK, "dit"))
    batch = next(create_dataloader(load_teacher_data(npz), batch_size=1,
                                   shuffle=False, device="cuda")())
    sin, cos = rope_angles_3d((1, 30, 52), 128, seq_len=1560, device="cuda")
    args = (batch, 1560, sin, cos, cfg.policy)
    _zero(kernels)
    loss_k, grads_k = _param_grads(model, *args)
    if not all(_count(kernels).values()):
        fail(f"the kernel pass missed a kernel: {_count(kernels)}")
    _zero(kernels)
    with mock.patch.object(fa, "flash_fwd", fa.flash_attention_plain), \
            mock.patch.object(fa, "flash_bwd", fa.flash_bwd_plain):
        loss_p, grads_p = _param_grads(model, *args)
    torch.cuda.synchronize()
    if any(_count(kernels).values()):
        fail(f"the plain pass launched kernels: {_count(kernels)}")
    num = sum((a.float() - b.float()).square().sum() for a, b in
              zip(grads_k, grads_p))
    den = sum(b.float().square().sum() for b in grads_p)
    rel_g = (num / den).sqrt().item()
    rel_l = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    log(f"[9] distill loss + gradients (t2v-1.3B, 1,560 tokens, bf16), "
        f"kernels vs plain attention: loss {loss_k.item():.6g} vs "
        f"{loss_p.item():.6g} (relative error {rel_l:.3g}, tol 5e-2), "
        f"gradients relative L2 error {rel_g:.3g} (tol 5e-2), gradient "
        f"norm {den.sqrt().item():.4g}")
    if not (rel_l <= 5e-2 and rel_g <= 5e-2):
        fail("distill step: kernels disagree with plain attention")
    del grads_k, grads_p

    opt = make_optimizer()
    state = init_distill_state(model, opt)
    before = {n: p.detach().clone() for n, p in
              trainable_params(model).items()}
    state, m = distill_train_step(state, batch, optimizer=opt, seq_len=1560,
                                  rope_sin=sin, rope_cos=cos,
                                  policy=cfg.policy)
    changed = sum(int((p != before[n]).sum()) for n, p in
                  trainable_params(model).items())
    total = sum(p.numel() for p in before.values())
    log(f"[9] one bf16 AdamW step (lr 5e-6): {changed} of {total} parameter "
        f"elements changed ({100.0 * changed / total:.4f}%); loss "
        f"{float(m['loss']):.6g}, grad norm {float(m['grad_norm']):.6g}")
    del before

    def timed_step():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, m = distill_train_step(state, batch, optimizer=opt, seq_len=1560,
                                  rope_sin=sin, rope_cos=cos,
                                  policy=cfg.policy)
        float(m["loss"])
        return time.perf_counter() - t0

    sec = timed_step()
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        timed_step()
    kernel_ms = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    log(f"[9] one distill step at 1,560 tokens (batch 1, per-block remat): "
        f"{sec:.3f} s; its profiled twin holds {kernel_ms:.1f} ms of kernel "
        f"time, {100.0 * kernel_ms / (sec * 1e3):.1f}% of the unprofiled "
        f"step: the rest is the host issuing work")
    return state, opt


def phase_flagship_distill_step(state, opt):
    """One distill step at 81 frames (32,760 tokens), per-block remat."""
    import torch
    from omnihuman_tpu_torch.apt.distill import distill_train_step
    from omnihuman_tpu_torch.configs import T2V_1_3B
    from omnihuman_tpu_torch.ops.rope import rope_angles_3d

    gen = torch.Generator(device="cuda").manual_seed(81)
    lat = (1, 16, 21, 60, 104)
    batch = {"noise": torch.randn(lat, generator=gen, device="cuda"),
             "context": torch.randn((1, 512, 4096), generator=gen,
                                    device="cuda"),
             "v_teacher": torch.randn(lat, generator=gen, device="cuda")}
    seq_len = FLAGSHIP["seq_len"]
    sin, cos = rope_angles_3d((21, 30, 52), 128, seq_len=seq_len,
                              device="cuda")

    def step():
        _, m = distill_train_step(state, batch, optimizer=opt,
                                  seq_len=seq_len, rope_sin=sin, rope_cos=cos,
                                  policy=T2V_1_3B.policy)
        return float(m["loss"])

    step()                                            # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss = step()
    sec = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if loss != loss:
        fail("81-frame distill step loss is NaN")
    log(f"[10] distill step at 81 frames (latents [1,16,21,60,104], "
        f"{FLAGSHIP['tokens']} tokens, seq_len {seq_len}, per-block remat, "
        f"batch 1): {sec:.2f} s, loss {loss:.6g}, peak device memory "
        f"{peak:.1f} GiB")

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in kernels) / 1e3
    if total == 0:
        log("[10] profiler: no device time recorded")
        return sec
    groups = {"flash_fwd (K1)": 0.0, "flash_bwd (K2)": 0.0,
              "GEMM (cuBLAS)": 0.0,
              "other (elementwise, norms, optimizer, copies)": 0.0}
    for e in kernels:
        t = e.self_device_time_total / 1e3
        name = e.key.lower()
        if "flash_fwd" in name:
            groups["flash_fwd (K1)"] += t
        elif "flash_bwd" in name:
            groups["flash_bwd (K2)"] += t
        elif any(x in name for x in ("gemm", "xmma", "cutlass", "cublas",
                                     "nvjet")):
            groups["GEMM (cuBLAS)"] += t
        else:
            groups["other (elementwise, norms, optimizer, copies)"] += t
    log(f"[10] profiled step: {total:.1f} ms of kernel time: " + ", ".join(
        f"{k} {v:.1f} ms ({100 * v / total:.1f}%)" for k, v in groups.items()))
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"[10]   {e.self_device_time_total / 1e3:9.1f} ms "
            f"x{e.count:<5d} {e.key[:90]}")
    return sec


def phase_apt_steps(state, npz, kernels):
    """One APT D step and one G step at full width, 1,560 tokens."""
    import torch
    from omnihuman_tpu_torch.apt import apt_trainer as tr
    from omnihuman_tpu_torch.apt.generate import (
        create_dataloader, load_teacher_data)
    from omnihuman_tpu_torch.apt.model import init_apt_discriminator
    from omnihuman_tpu_torch.configs import T2V_1_3B

    from omnihuman_tpu_torch.ops.rope import rope_angles_3d

    g_model = state.model
    disc = init_apt_discriminator(
        copy.deepcopy(g_model), generator=torch.Generator(
            device="cuda").manual_seed(11))
    apt_cfg = tr.SeaweedAPTConfig()
    apt = tr.init_apt_state(g_model, disc, apt_cfg.g_lr_image,
                            apt_cfg.d_lr_image)
    batch = next(create_dataloader(load_teacher_data(npz), batch_size=1,
                                   shuffle=False, device="cuda")())
    gen = torch.Generator().manual_seed(12)
    batch["real"] = torch.randn(batch["noise"].shape, generator=gen
                                ).to("cuda")
    sin, cos = rope_angles_3d((1, 30, 52), 128, seq_len=1560, device="cuda")
    kw = dict(apt_cfg=apt_cfg, video=False, seq_len=1560, rope_sin=sin,
              rope_cos=cos, policy=T2V_1_3B.policy)
    _zero(kernels)
    t0 = time.perf_counter()
    apt, dm = tr.apt_d_step(apt, batch, gen, d_optimizer=tr.make_d_optimizer(
        apt_cfg.d_lr_image, disc), **kw)
    d_loss = float(dm["d_loss"])
    d_sec = time.perf_counter() - t0
    d_counts = _count(kernels)
    _zero(kernels)
    t0 = time.perf_counter()
    apt, gm = tr.apt_g_step(apt, batch, gen, g_optimizer=tr.make_rmsprop(
        apt_cfg.g_lr_image), **kw)
    g_loss = float(gm["g_loss"])
    g_sec = time.perf_counter() - t0
    g_counts = _count(kernels)
    taps = disc.taps
    log(f"[11] APT D step: d_loss {d_loss:.6g}, r1 {float(dm['r1_loss']):.6g}"
        f", total {float(dm['d_total']):.6g}, {d_sec:.2f} s, launches "
        f"{d_counts} (generator and 3 discriminator forwards, no gradient "
        f"through the backbone)")
    log(f"[11] APT G step: g_loss {g_loss:.6g}, {g_sec:.2f} s, launches "
        f"{g_counts} (discriminator taps {taps}: its backward reaches blocks "
        f"0..{max(taps)})")
    for what, v in (("d", dm["d_total"]), ("g", gm["g_loss"])):
        if not torch.isfinite(v):
            fail(f"APT {what} loss not finite")
    k2 = [kn.name for kn in kernels if "bwd" in kn.name]
    if any(d_counts[k] for k in k2):
        fail("the D step launched the backward kernels through a cut")
    if not all(g_counts[k] > 0 for k in k2):
        fail("the G step did not launch the backward kernels")


# ---------------------------------------------------------------------------
# phases 12-15: the VAE kernels, the VAE at full width, i2v, one-step

# (T, H, W, Cin, Cout) of every distinct K3 call of an 81-frame 480x832
# decode (28 a latent frame) and encode (20 a chunk); the first chunk / step
# runs each resolution at T=1
K3_SHAPES = sorted({
    (1, 60, 104, 384, 384), (2, 120, 208, 192, 384), (2, 120, 208, 384, 384),
    (4, 240, 416, 192, 192), (4, 480, 832, 96, 96),        # decode steps
    (1, 120, 208, 192, 384), (1, 120, 208, 384, 384),
    (1, 240, 416, 192, 192), (1, 480, 832, 96, 96),        # decode first
    (4, 240, 416, 96, 192), (1, 240, 416, 96, 192)})       # encode extra
# (T, h, w, Cin, Cout) of the K4 calls (decode steps, then the first step)
K4_SHAPES = [(2, 60, 104, 384, 192), (4, 120, 208, 384, 192),
             (4, 240, 416, 192, 96), (1, 60, 104, 384, 192),
             (1, 120, 208, 384, 192), (1, 240, 416, 192, 96)]
K3_ROW, K4_ROW = (4, 480, 832, 96, 96), (4, 240, 416, 192, 96)
I2V = dict(frames=17, steps=3, size=(832, 480),
           prompt="a woman turns her head and smiles, soft window light",
           seed=31)
ONE_STEP = dict(frames=81, seed=5, prompts=(
    "a paper boat drifting down a rain-soaked street, close-up",
    "timelapse of clouds rolling over a mountain ridge at dusk"))


def _bound(flops, nbytes):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def phase_vae_kernels():
    """K3 / K4 against their plain versions at the full-width shapes.
    Returns the JSON rows of the largest call of each."""
    import torch
    import torch.nn.functional as F
    from omnihuman_tpu_torch.ops import vae_kernels as vk

    dev = torch.device("cuda")
    cl = torch.channels_last_3d
    gen = torch.Generator(device=dev).manual_seed(1212)

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    rows = {}
    for t, h, w, cin, cout in K3_SHAPES:
        res_on = cin == cout       # conv2 of an identity block
        x = rnd(1, cin, t, h, w).to(torch.bfloat16).contiguous(
            memory_format=cl)
        cache = rnd(1, cin, 2, h, w).to(torch.bfloat16).contiguous(
            memory_format=cl)
        gamma = rnd(cin, scale=0.2) + 1.0
        wt = rnd(3, 3, 3, cin, cout, scale=(27 * cin) ** -0.5)
        w2 = vk.pack_conv_weights(wt)
        bias = rnd(cout, scale=0.05)
        res = (rnd(1, cout, t, h, w).to(torch.bfloat16).contiguous(
            memory_format=cl) if res_on else None)
        got, cnew = vk.fused_act_causal_conv3d_cuda(x, cache, gamma, w2,
                                                    bias, res)
        torch.cuda.synchronize()
        want, cwant = vk.fused_act_causal_conv3d_plain(x, cache, gamma, w2,
                                                       bias, res)
        err = (got.float() - want.float()).abs().max().item()
        tol = 2 ** -6 * want.float().abs().max().item()
        cerr = (cnew.float() - cwant.float()).abs().max().item()
        ctol = 2 ** -6 * cwant.float().abs().max().item()
        if not torch.isfinite(got.float()).all() or err > tol or cerr > ctol:
            fail(f"K3 vs plain at {(t, h, w, cin, cout)}: output err {err} "
                 f"(tol {tol}), cache err {cerr} (tol {ctol})")
        n_out, hw = t * h * w, h * w
        flops = 2.0 * 27 * cin * cout * n_out
        nbytes = 2.0 * (n_out * cin + 2 * 2 * hw * cin + 27 * cin * cout
                        + n_out * cout * (2 if res_on else 1)) \
            + 4.0 * (cin + cout)
        bound, by = _bound(flops, nbytes)
        ms = bench_ms(lambda: vk.fused_act_causal_conv3d_cuda(
            x, cache, gamma, w2, bias, res))
        plain_ms = bench_ms(lambda: vk.fused_act_causal_conv3d_plain(
            x, cache, gamma, w2, bias, res), reps=3, warmup=1)
        # yardstick only: cuDNN's conv of the already-activated input
        xin = torch.cat([cache, vk.activate_plain(x, gamma)], dim=2
                        ).contiguous(memory_format=cl)
        wl = wt.permute(4, 3, 0, 1, 2).to(torch.bfloat16).contiguous(
            memory_format=cl)
        bl = bias.to(torch.bfloat16)
        lib_ms = bench_ms(lambda: F.conv3d(xin, wl, bl, padding=(0, 1, 1)))
        log(f"[12] K3 T={t} {h}x{w} {cin}->{cout}"
            f"{' +residual' if res_on else ''}: max_abs_err {err:.3g} (tol "
            f"{tol:.3g}), cache err {cerr:.3g}; kernel {ms:.3f} ms, bound "
            f"{bound:.3f} ms ({by}, {100 * bound / ms:.1f}%), plain "
            f"{plain_ms:.3f} ms, cuDNN conv3d {lib_ms:.3f} ms")
        if (t, h, w, cin, cout) == K3_ROW:
            rows["k3"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                              bound_ms=bound, bound_by=by, library_ms=lib_ms)
        del x, cache, res, got, cnew, want, cwant, xin
        torch.cuda.empty_cache()

    for t, h, w, cin, cout in K4_SHAPES:
        x = rnd(1, cin, t, h, w).to(torch.bfloat16).contiguous(
            memory_format=cl)
        wt = rnd(3, 3, cin, cout, scale=(9 * cin) ** -0.5)
        w4 = vk.pack_upsample_weights(wt.to(torch.bfloat16))
        bias = rnd(cout, scale=0.05)
        got = vk.fused_upsample_conv2d_cuda(x, w4, bias)
        torch.cuda.synchronize()
        want = vk.fused_upsample_conv2d_plain(x, w4, bias)
        err = (got.float() - want.float()).abs().max().item()
        tol = 2 ** -6 * want.float().abs().max().item()
        if not torch.isfinite(got.float()).all() or err > tol:
            fail(f"K4 vs plain at {(t, h, w, cin, cout)}: err {err} > {tol}")
        n_in = t * h * w
        flops = 2.0 * 4 * 4 * cin * cout * n_in
        nbytes = 2.0 * (n_in * cin + 16 * cin * cout + 4 * n_in * cout) \
            + 4.0 * cout
        bound, by = _bound(flops, nbytes)
        ms = bench_ms(lambda: vk.fused_upsample_conv2d_cuda(x, w4, bias))
        plain_ms = bench_ms(lambda: vk.fused_upsample_conv2d_plain(
            x, w4, bias), reps=3, warmup=1)
        # yardstick only: cuDNN's 3x3 conv of the upsampled frames
        xu = F.interpolate(x, scale_factor=(1, 2, 2), mode="nearest")
        xu = xu.transpose(1, 2).reshape(t, cin, 2 * h, 2 * w).contiguous(
            memory_format=torch.channels_last)
        wl = wt.permute(3, 2, 0, 1).to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        bl = bias.to(torch.bfloat16)
        lib_ms = bench_ms(lambda: F.conv2d(xu, wl, bl, padding=1))
        log(f"[12] K4 T={t} {h}x{w} -> {2 * h}x{2 * w} {cin}->{cout}: "
            f"max_abs_err {err:.3g} (tol {tol:.3g}); kernel {ms:.3f} ms, "
            f"bound {bound:.3f} ms ({by}, {100 * bound / ms:.1f}%), plain "
            f"{plain_ms:.3f} ms, cuDNN conv2d {lib_ms:.3f} ms")
        if (t, h, w, cin, cout) == K4_ROW:
            rows["k4"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                              bound_ms=bound, bound_by=by, library_ms=lib_ms)
        del x, got, want, xu
        torch.cuda.empty_cache()
    return rows


def f_lat_of(run) -> int:
    return (run["frames"] - 1) // 4 + 1


def _timed(fn):
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, \
        torch.cuda.max_memory_allocated() / 2 ** 30


def phase_vae_full(vae_kernels):
    """vae_decode / vae_encode at 81 frames, 480x832, K3 / K4 against
    cuDNN. Returns {path: {kernel: launches}}."""
    import torch
    from omnihuman_tpu_torch.configs import T2V_1_3B
    from omnihuman_tpu_torch.models.vae import build_vae, vae_decode, \
        vae_encode

    vae = build_vae(T2V_1_3B.vae, "cuda", torch.bfloat16, seed=1)
    gen = torch.Generator(device="cuda").manual_seed(13)
    z = torch.randn((1, 16, 21, 60, 104), generator=gen, device="cuda"
                    ).to(torch.bfloat16)
    video = (torch.rand((1, 3, 81, 480, 832), generator=gen, device="cuda")
             * 2 - 1).to(torch.bfloat16)
    counts = {}
    for name, fn, inp, want in (
            ("decode", lambda x, impl: vae_decode(vae, x, clamp=False,
                                                  conv_impl=impl), z,
             [588, 63]),
            ("encode", lambda x, impl: vae_encode(vae, x, conv_impl=impl),
             video, [420, 0])):
        with torch.inference_mode():
            fn(inp, "cuda")                           # warm-up
            _zero(vae_kernels)
            got, sec, peak = _timed(lambda: fn(inp, "cuda"))
            counts[f"vae_{name}_81f"] = _count(vae_kernels)
            fn(inp, "torch")
            ref, sec_t, peak_t = _timed(lambda: fn(inp, "torch"))
        launches = list(counts[f"vae_{name}_81f"].values())
        rel = ((got.float() - ref.float()).norm() / ref.float().norm()).item()
        log(f"[13] vae_{name} 81 frames 480x832 (bf16, streaming): kernels "
            f"{sec:.3f} s, peak {peak:.2f} GiB; cuDNN {sec_t:.3f} s, peak "
            f"{peak_t:.2f} GiB; relative L2 kernels vs cuDNN {rel:.3g} (tol "
            f"5e-2); output {tuple(got.shape)}; launches "
            f"{counts[f'vae_{name}_81f']}, expected {want}")
        if not torch.isfinite(got.float()).all() or rel > 5e-2:
            fail(f"vae_{name}: kernels vs cuDNN relative L2 {rel}")
        if launches != want:
            fail(f"vae_{name}: launches {launches} != {want}")
        del got, ref
    del vae, z, video
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def phase_i2v(kernels, flash_kernels):
    """WanI2V at i2v-14B full width: one request through generate()."""
    import torch
    from omnihuman_tpu_torch.configs import I2V_14B
    from omnihuman_tpu_torch.pipelines.image2video import WanI2V

    t0 = time.perf_counter()
    pipe = WanI2V(I2V_14B, device="cuda", precision="fast", init_seed=0)
    with torch.no_grad():    # unit-scale velocities instead of all zeros
        pipe.model.head.head.weight.normal_(
            0.0, I2V_14B.model.dim ** -0.5,
            generator=torch.Generator(device="cuda").manual_seed(5))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in pipe.model.parameters())
    log(f"[14] WanI2V(i2v-14B) built with random weights in "
        f"{time.perf_counter() - t0:.1f} s: DiT {n_params / 1e9:.2f} B "
        f"parameters (bf16), CLIP ViT-H/14 fp32, VAE bf16")
    w, h = I2V["size"]
    gen = torch.Generator(device="cuda").manual_seed(17)
    img = torch.rand((3, h, w), generator=gen, device="cuda") * 2 - 1
    torch.cuda.reset_peak_memory_stats()
    _zero(kernels)
    t0 = time.perf_counter()
    video = pipe.generate(I2V["prompt"], img, max_area=h * w,
                          frame_num=I2V["frames"],
                          sampling_steps=I2V["steps"], seed=I2V["seed"])
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    counts = _count(kernels)
    vf = video.float()
    tm = pipe.timings
    log(f"[14] i2v request: video {tuple(video.shape)} in "
        f"[{vf.min().item():.3f}, {vf.max().item():.3f}], std "
        f"{vf.std().item():.3f}; total {total:.2f} s: T5 load "
        f"{tm['t5_load_s']:.2f} s, T5 encode {tm['t5_encode_s']:.2f} s, T5 "
        f"unload {tm['t5_unload_s']:.2f} s, CLIP {tm['clip_s']:.3f} s, VAE "
        f"encode {tm['vae_encode_s']:.3f} s, denoise {tm['denoise_s']:.2f} s "
        f"({tm['denoise_s'] / I2V['steps']:.2f} s/step), VAE decode "
        f"{tm['vae_decode_s']:.3f} s; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB")
    # the reference's latent size: max_area 480*832 at this aspect gives
    # sqrt(230400) = 479.99999999999994 in float64, so 58 latent rows
    lat_h, lat_w = pipe.latent_size_for((h, w), h * w)
    log(f"[14] latent {lat_h}x{lat_w} -> {lat_h * lat_w // 4 * f_lat_of(I2V)}"
        f" tokens, seq_len {pipe.seq_len_for((16, f_lat_of(I2V), lat_h, lat_w))}")
    if tuple(video.shape) != (3, I2V["frames"], 8 * lat_h, 8 * lat_w) or \
            not torch.isfinite(vf).all() or vf.abs().max().item() > 1.0:
        fail("the i2v video has the wrong shape or values")
    layers, steps = I2V_14B.model.num_layers, I2V["steps"]
    f_lat = f_lat_of(I2V)
    want = {flash_kernels[0].name: layers * steps,        # self-attention
            flash_kernels[1].name: 2 * layers * steps,    # text + image
            kernels[-2].name: 20 * f_lat + 28 * f_lat,    # encode + decode
            kernels[-1].name: 3 * f_lat}
    want = {kn.name: want.get(kn.name, 0) for kn in kernels}
    log(f"[14] launches {counts}, expected {want} ({layers} layers x {steps}"
        f" steps, CFG in one batch; {f_lat} encode chunks x 20 + {f_lat} "
        f"decode steps x 28 K3, x 3 K4)")
    if counts != want:
        fail("the i2v path did not send every attention through K1 and "
             "every VAE conv through K3 / K4")
    del pipe, video
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def phase_one_step(kernels, flash_kernels):
    """SeaweedWanAPTGenerator: t2v-1.3B, 2 prompts x 81 frames."""
    import torch
    from omnihuman_tpu_torch.configs import T2V_1_3B
    from omnihuman_tpu_torch.pipelines.text2video import WanT2V
    from omnihuman_tpu_torch.pipelines.wan_inference import (
        SeaweedWanAPTGenerator)

    pipe = WanT2V(T2V_1_3B, device="cuda", precision="fast", init_seed=0)
    with torch.no_grad():
        pipe.model.head.head.weight.normal_(
            0.0, T2V_1_3B.model.dim ** -0.5,
            generator=torch.Generator(device="cuda").manual_seed(5))
    gen = SeaweedWanAPTGenerator(pipe)
    w, h = FLAGSHIP["size"]
    pipe.t5                                       # built outside the timing
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero(kernels)
    t0 = time.perf_counter()
    videos = gen.generate_batch(list(ONE_STEP["prompts"]), size=(w, h),
                                frame_num=ONE_STEP["frames"],
                                seed=ONE_STEP["seed"])
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    counts = _count(kernels)
    vf = videos.float()
    tm = gen.timings
    log(f"[15] one-step, 2 prompts x {ONE_STEP['frames']} frames: videos "
        f"{tuple(videos.shape)}, std {vf.std().item():.3f}; total "
        f"{total:.2f} s: text encode {tm['text_encode_s']:.2f} s, DiT "
        f"{tm['dit_s']:.3f} s, VAE decode {tm['vae_decode_s']:.3f} s, "
        f"{tm['frames_per_sec']:.1f} frames/s; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB")
    if tuple(videos.shape) != (2, 3, ONE_STEP["frames"], h, w) or \
            not torch.isfinite(vf).all():
        fail("the one-step videos have the wrong shape or values")
    f_lat = f_lat_of(ONE_STEP)
    want = {flash_kernels[0].name: NUM_LAYERS,
            flash_kernels[1].name: NUM_LAYERS,
            kernels[-2].name: 28 * f_lat, kernels[-1].name: 3 * f_lat}
    want = {kn.name: want.get(kn.name, 0) for kn in kernels}
    log(f"[15] launches {counts}, expected {want}")
    if counts != want:
        fail("the one-step path did not go through K1 and K3 / K4")
    del pipe, gen, videos
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def run_training_phases(all_kernels, paths):
    """Phases 8-11 (the attention kernels K1 / K2 only); their models and
    states are dropped on return."""
    try:
        counts, npz = phase_training_main_path(all_kernels)
        paths.update(counts)
        state, opt = phase_distill_vs_plain(npz, all_kernels)
        phase_flagship_distill_step(state, opt)
        phase_apt_steps(state, npz, all_kernels)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)




def main() -> None:
    if not os.path.isdir(os.path.join(HERE, "omnihuman_tpu_torch")):
        fail("omnihuman_tpu_torch/ is not beside chip_smoke.py: run this "
             "from the root of a checkout of the repository")
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke needs a GPU")
    sys.path.insert(0, HERE)
    t_start = time.perf_counter()

    card = phase_card_facts()
    phase_build()
    rows = phase_kernels()
    bwd_rows = phase_backward_kernels()
    vae_rows = phase_vae_kernels()
    phase_small_reference()
    from omnihuman_tpu_torch.ops.flash_attention import (
        FLASH_BWD, FLASH_FWD_LONG_K, FLASH_FWD_SHORT_K)
    from omnihuman_tpu_torch.ops.vae_kernels import VAE_CONV, VAE_UPSAMPLE
    kernels = (FLASH_FWD_LONG_K, FLASH_FWD_SHORT_K)
    flash_kernels = kernels + (FLASH_BWD,)
    all_kernels = flash_kernels + (VAE_CONV, VAE_UPSAMPLE)
    _zero(all_kernels)
    pipe, launches = phase_main_path(kernels)
    paths = {"serve": _count(all_kernels)}
    phase_step_vs_plain(pipe)
    phase_flagship_step(pipe)
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    run_training_phases(flash_kernels, paths)
    gc.collect()
    torch.cuda.empty_cache()
    paths.update(phase_vae_full((VAE_CONV, VAE_UPSAMPLE)))
    paths["i2v"] = phase_i2v(all_kernels, kernels)
    paths["one_step"] = phase_one_step(all_kernels, kernels)
    log(f"smoke wall time {time.perf_counter() - t_start:.0f} s")

    def by_path(kn):
        return {p: c.get(kn.name, 0) for p, c in paths.items()}

    fwd_src = "omnihuman_tpu_torch/csrc/flash_fwd.cu"
    bwd_src = "omnihuman_tpu_torch/csrc/flash_bwd.cu"
    out = []
    for key, kn, n, replaces in (
            ("long", FLASH_FWD_LONG_K, launches[0],
             "omnihuman_tpu/ops/flash_pallas.py:193"),
            ("short", FLASH_FWD_SHORT_K, launches[1],
             "omnihuman_tpu/ops/flash_pallas.py:94")):
        out.append(dict(name=kn.name, route="cuda", source=fwd_src,
                        replaces=replaces, launches=n, **rows[key],
                        launches_by_path=by_path(kn)))
    out.append(dict(name=FLASH_BWD.name, route="cuda", source=bwd_src,
                    replaces="omnihuman_tpu/ops/flash_pallas.py:387 and "
                             "omnihuman_tpu/ops/flash_pallas.py:437",
                    launches=paths["train_distill"][FLASH_BWD.name],
                    **bwd_rows["k2"], launches_by_path=by_path(FLASH_BWD)))
    for key, kn, src, replaces in (
            ("k3", VAE_CONV, "omnihuman_tpu_torch/csrc/vae_conv.cu",
             "omnihuman_tpu/ops/vae_pallas.py:58"),
            ("k4", VAE_UPSAMPLE, "omnihuman_tpu_torch/csrc/vae_upsample.cu",
             "omnihuman_tpu/ops/vae_pallas.py:278")):
        out.append(dict(name=kn.name, route="cuda", source=src,
                        replaces=replaces, launches=paths["i2v"][kn.name],
                        **vae_rows[key], launches_by_path=by_path(kn)))
    print(card, flush=True)
    print(json.dumps({"kernels": out}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
