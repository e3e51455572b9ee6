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
  7. the backward kernels (flash_bwd.cu, dkdv and dq) and the forward's LSE
     against their plain versions, B=1, N=12, D=128, bf16, tolerance 2^-6
     of each gradient's own peak: (a) self-attention 32,768 tokens, k_len
     32,760; (b) cross-attention Lq=32,768, Lc=512, no lengths, and with
     k_lens (37, 512) at B=2; (c) Lk=257; (d) a k_len=0 row (gradients
     exactly 0); (e) ragged Lq=1000, Lk=777, causal, window and offsets.
     Kernel ms per kernel, bound, plain ms, and the SDPA backward on the
     unmasked shape as a yardstick;
  8. the training main path at full width (t2v-1.3B, random weights from a
     seed with a random head, written as a reference `*.safetensors`
     checkpoint directory): `cli.teacher_data` writes 2 samples at 480x832
     (1,560 tokens), then `cli.train_distill` runs 1 epoch at batch 1 (2
     steps, per-block remat) with a checkpoint, which is restored and held
     bit-equal (parameters, EMA, AdamW state). Launch counts are zeroed
     before each CLI and read after it: every attention forward, recompute
     and backward went through K1 and K2;
  9. one distill step at full width and 1,560 tokens, kernels against plain
     attention (relative L2 error of the loss and the gradients, tolerance
     5e-2), and the share of parameter elements one bf16 AdamW step
     changes;
 10. one timed distill step at 81 frames (32,760 tokens, per-block remat,
     batch 1) after one warm-up, its peak memory and a torch.profiler split;
 11. one APT D step and one APT G step at full width and 1,560 tokens: the
     losses, and the K2 launches (the G step's gradient flows through the
     discriminator's frozen backbone, so it launches K2; the D step's
     features are cut, so it does not).

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
    from omnihuman_tpu_torch.models.vae import build_vae_decoder, vae_decode
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
        vae = build_vae_decoder(TINY_TEST.vae, "cpu", torch.float32,
                                seed=4).to(device)
        with torch.inference_mode():
            vouts[device] = vae_decode(vae, z.to(device)).cpu()
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


def backward_bound(q_rows, k_rows, pairs, n, d, products, grads_of_q):
    """Least time of one backward kernel: `products` matmuls of 2*D FLOP per
    (query, visible key) pair and head; bytes: q, dO, k, v read once and
    the kernel's gradients written once (dq: q-sized; dk, dv: k-sized), bf16,
    plus the fp32 LSE and delta. Returns (ms, "operations" | "bytes")."""
    flops = 2.0 * products * n * d * pairs
    out_rows = q_rows if grads_of_q else 2 * k_rows
    nbytes = (2.0 * n * d * (2 * q_rows + 2 * k_rows + out_rows)
              + 8.0 * q_rows * n)
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
    """Returns {row: measurement} for the dkdv and dq JSON rows (case a)."""
    import torch
    import torch.nn.functional as F
    from omnihuman_tpu_torch.ops.flash_attention import (
        _clamped_lens, bwd_delta, flash_attention_cuda, flash_attention_plain,
        flash_bwd_cuda, flash_bwd_dkdv_cuda, flash_bwd_dq_cuda,
        flash_bwd_plain)

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
        if k_lens is not None and 0 in k_lens:
            i = list(k_lens).index(0)
            if any(x[i].abs().max().item() != 0.0 for x in got):
                fail("a row with k_len=0 has a nonzero gradient")
        # kernel times, each kernel alone, on the same inputs
        klc = _clamped_lens(kl, b, lk, dev)
        delta = bwd_delta(out, dout)
        mask = dict(softmax_scale=None, **mkw)
        dkdv_ms = bench_ms(lambda: flash_bwd_dkdv_cuda(
            q, k, v, dout, lse, delta, klc, **mask))
        dq_ms = bench_ms(lambda: flash_bwd_dq_cuda(
            q, k, v, dout, lse, delta, klc, **mask))
        fwd_lse_ms = bench_ms(lambda: flash_attention_cuda(
            q, k, v, k_lens=kl, return_lse=True, **mkw))
        plain_ms = bench_ms(lambda: flash_bwd_plain(
            q, k, v, out, lse, dout, k_lens=kl, **mkw), reps=1, warmup=0)
        lib_ms = None
        if lib_ok:   # yardstick only: the port never calls SDPA
            qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                          for x in (q, k, v))
            ot = F.scaled_dot_product_attention(qt, kt, vt)
            dt = dout.transpose(1, 2)
            lib_ms = bench_ms(lambda: torch.autograd.grad(
                ot, (qt, kt, vt), dt, retain_graph=True))
            del qt, kt, vt, ot
        pairs = visible_pairs(b, lq, lk, k_lens, mkw, dev)
        res = {}
        for kname, products, ms in (("dkdv", 4, dkdv_ms), ("dq", 3, dq_ms)):
            bound, by = backward_bound(b * lq, b * lk, pairs, n, d, products,
                                       grads_of_q=kname == "dq")
            res[kname] = dict(ms=ms, bound_ms=bound, bound_by=by)
        log(f"[7] {name}: " + ", ".join(
            f"{g} err {e:.3g} (tol {t:.3g})" for g, e, t in errs)
            + f", LSE err {lse_err:.3g}; forward with LSE {fwd_lse_ms:.3f} "
            f"ms; dkdv {dkdv_ms:.3f} ms (bound "
            f"{res['dkdv']['bound_ms']:.3f}, {res['dkdv']['bound_by']}), dq "
            f"{dq_ms:.3f} ms (bound {res['dq']['bound_ms']:.3f}, "
            f"{res['dq']['bound_by']}), plain backward {plain_ms:.1f} ms, "
            f"SDPA backward {lib_ms if lib_ms is None else round(lib_ms, 3)}"
            f" ms")
        if name.startswith("a "):
            err_of = {g: e for g, e, _ in errs}
            for kname, grads in (("dkdv", ("dk", "dv")), ("dq", ("dq",))):
                rows[kname] = dict(
                    max_abs_err=max(err_of[g] for g in grads),
                    plain_ms=plain_ms, library_ms=lib_ms, **res[kname])
        del q, k, v, dout, out, lse, got, want, want_out, want_lse, delta
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
    want = [NUM_LAYERS, NUM_LAYERS, 0, 0]
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
    want = [2 * NUM_LAYERS * steps] * 4
    log(f"[8] cli.train_distill: {steps} steps in {total:.1f} s (with model "
        f"build and the checkpoint save), peak device memory {peak:.1f} GiB;"
        f" launches {counts['train_distill']}, expected {want} (per step: "
        f"30 layers x self + cross attention, K1 forward + remat recompute, "
        f"one dkdv and one dq each)")
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
    groups = {"flash_fwd (K1)": 0.0, "flash_bwd_dkdv (K2a)": 0.0,
              "flash_bwd_dq (K2b)": 0.0, "GEMM (cuBLAS)": 0.0,
              "other (elementwise, norms, optimizer, copies)": 0.0}
    for e in kernels:
        t = e.self_device_time_total / 1e3
        name = e.key.lower()
        if "flash_fwd" in name:
            groups["flash_fwd (K1)"] += t
        elif "flash_bwd_dkdv" in name:
            groups["flash_bwd_dkdv (K2a)"] += t
        elif "flash_bwd_dq" in name:
            groups["flash_bwd_dq (K2b)"] += t
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
    phase_small_reference()
    from omnihuman_tpu_torch.ops.flash_attention import (
        FLASH_BWD_DKDV, FLASH_BWD_DQ, FLASH_FWD_LONG_K, FLASH_FWD_SHORT_K)
    kernels = (FLASH_FWD_LONG_K, FLASH_FWD_SHORT_K)
    all_kernels = kernels + (FLASH_BWD_DKDV, FLASH_BWD_DQ)
    _zero(all_kernels)
    pipe, launches = phase_main_path(kernels)
    paths = {"serve": _count(all_kernels)}
    phase_step_vs_plain(pipe)
    phase_flagship_step(pipe)
    del pipe
    gc.collect()
    import torch
    torch.cuda.empty_cache()
    try:
        counts, npz = phase_training_main_path(all_kernels)
        paths.update(counts)
        state, opt = phase_distill_vs_plain(npz, all_kernels)
        phase_flagship_distill_step(state, opt)
        phase_apt_steps(state, npz, all_kernels)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    log(f"smoke wall time {time.perf_counter() - t_start:.0f} s")

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
                        launches_by_path={p: c[kn.name]
                                          for p, c in paths.items()}))
    for key, kn, replaces in (
            ("dkdv", FLASH_BWD_DKDV, "omnihuman_tpu/ops/flash_pallas.py:387"),
            ("dq", FLASH_BWD_DQ, "omnihuman_tpu/ops/flash_pallas.py:437")):
        out.append(dict(name=kn.name, route="cuda", source=bwd_src,
                        replaces=replaces,
                        launches=paths["train_distill"][kn.name],
                        **bwd_rows[key],
                        launches_by_path={p: c[kn.name]
                                          for p, c in paths.items()}))
    print(card, flush=True)
    print(json.dumps({"kernels": out}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
