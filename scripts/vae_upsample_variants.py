#!/usr/bin/env python3
"""Time variants of the fused VAE upsample conv kernel K4 on one GPU.

    python3 scripts/vae_upsample_variants.py [--baseline DIR] [--rounds N]
        [--only a,b]     # from the root of a checkout

Each variant is `omnihuman_tpu_torch/csrc/vae_upsample.cu` with one
design choice undone by a text substitution; every variant is built with
the port's nvcc flags into `omnihuman_tpu_torch/_build/variants/` (one
nvcc each, in parallel; ptxas's registers, spills and warnings printed
per variant) and timed with CUDA events (median of 7, warm) on the same
inputs as the kernel itself, twice a round, in the order kernel,
variants, variants reversed, kernel (`--rounds N` rounds; `--only a,b`
builds and times only those variants). The shapes are the six K4 calls of
an 81-frame 480x832 decode (chip_smoke.py phase 12's K4_SHAPES), beside
cuDNN's conv2d of the upsampled input (a yardstick, as in the smoke) and
the bound. `--baseline DIR` also builds DIR's
`omnihuman_tpu_torch/csrc/vae_upsample.cu` (another checkout of the repo,
an earlier kernel with the same C entry, which read the packed weights w4
where this one reads the K-major copy) and times it as "baseline". The
kernel is held to its plain version (2^-6 of the plain peak, as the
smoke holds it); the variants' errors are relative to the kernel's peak
(a variant that sums in another order may differ in the last bf16 bit).
Prints one JSON line per shape.
"""

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CHOICE = "if (rounds(8) * 8 * 11 < rounds(12) * 12 * 10)"
TMA_STORE = ("constexpr bool kTmaStore = true;",
             "constexpr bool kTmaStore = false;")
# name -> (what it undoes, [(old, new), ...])
VARIANTS = {
    "bn192_one_parity": (
        "BN = 192 and one column parity an item at Cout % 192 == 0 (one "
        "m64n192 accumulator; each lane stores its channel pairs, two "
        "high-res columns apart) in place of BN = 96 and both parities",
        [(CHOICE, "if (Cout % 192 == 0) return "
          "run(launch_up<192, 1, kKC, 3>);\n  " + CHOICE)]),
    "two_consumers": (
        "two consumer warpgroups (setmaxnreg 240; items of 8 low-res rows) "
        "at every shape, in place of three (160; 12 rows) where the "
        "grid's last wave is nearly full",
        [(CHOICE, "if (true)")]),
    "three_consumers": (
        "three consumer warpgroups (items of 12 low-res rows) at every "
        "shape, in place of two where 8-row items fill the grid better",
        [(CHOICE, "if (false)")]),
    "one_a_set": (
        "one A register set: each group of products waited for before the "
        "next group gathers its fragments",
        [("constexpr int kASets = 2;", "constexpr int kASets = 1;")]),
    "not_persistent": (
        "one block per work item in place of one persistent block per SM",
        [("const int grid = n_items < sms ? (int)n_items : sms;",
          "const int grid = (int)n_items;")]),
    "plain_stores": (
        "each lane stores its own channel pairs straight to y (4 bytes "
        "each) in place of staging the warp's row in shared memory for "
        "one TMA store",
        [TMA_STORE]),
    "chunk64_plain_stores": (
        "64-channel K steps (128-byte swizzle; every decode shape has Cin "
        "192 or 384) with the plain-store epilogue (the staging does not "
        "fit beside their halo ring and two weight stages): compare with "
        "plain_stores",
        [("constexpr int kKC = 32;", "constexpr int kKC = 64;"),
         TMA_STORE]),
    "three_halo": (
        "a 3-slot halo ring in place of 2",
        [("constexpr int kHStages = 2; ", "constexpr int kHStages = 3; ")]),
    "no_epilogue": (
        "diagnostic, not a design: no epilogue at all (y is not written), "
        "what the products and loads alone take",
        [("if (yy >= H) continue;", "if (yy >= H || H > 0) continue;")]),
    "no_store": (
        "diagnostic, not a design: the epilogue without its TMA stores",
        [("if (it.n0 + 32 * k < Cout)",
          "if (it.n0 + 32 * k < Cout && H < 0)")]),
    "two_stages": (
        "a 2-slot weight ring in place of 4",
        [("constexpr int kMaxWStages = 4;", "constexpr int kMaxWStages = 2;")]),
}
# (T, h, w, Cin, Cout) of the K4 calls of an 81-frame 480x832 decode
SHAPES = ((2, 60, 104, 384, 192), (4, 120, 208, 384, 192),
          (4, 240, 416, 192, 96), (1, 60, 104, 384, 192),
          (1, 120, 208, 384, 192), (1, 240, 416, 192, 96))
PEAK_BF16_FLOPS = 989e12      # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12          # H100 SXM HBM3


def _ptxas(log):
    return [line.strip() for line in log.splitlines()
            if "registers" in line or "spill" in line or "C75" in line
            or "arning" in line]


def build(cuda_build, vk, baseline, only=None):
    src_path = os.path.join(cuda_build.CSRC_DIR, "vae_upsample.cu")
    with open(src_path) as f:
        src = f.read()
    out_dir = os.path.join(cuda_build.BUILD_DIR, "variants")
    os.makedirs(out_dir, exist_ok=True)
    jobs = {}
    for name, (_, subs) in VARIANTS.items():
        if only is not None and name not in only:
            continue
        text = src
        for old, new in subs:
            if text.count(old) != 1:
                sys.exit(f"variant {name}: {old!r} not found once")
            text = text.replace(old, new)
        cu = os.path.join(out_dir, f"vae_upsample_{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        jobs[name] = (cu, cuda_build.CSRC_DIR)
    if baseline:
        csrc = os.path.join(os.path.abspath(baseline), "omnihuman_tpu_torch",
                            "csrc")
        jobs["baseline"] = (os.path.join(csrc, "vae_upsample.cu"), csrc)
    procs = {}
    for name, (cu, inc) in jobs.items():
        so = os.path.join(out_dir, f"libvae_upsample_{name}.so")
        cmd = [cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS, "-I", inc,
               "-o", so, cu]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       so)
    kernel = vk.VAE_UPSAMPLE
    fns = {"kernel": kernel._entry()}
    print(json.dumps({"variant": "kernel", "ptxas": _ptxas(
        cuda_build.build_log(kernel.source))}), flush=True)
    for name, (p, so) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            sys.exit(f"nvcc failed for {name}:\n{log}")
        what = VARIANTS[name][0] if name in VARIANTS else baseline
        print(json.dumps({"variant": name, "what": what,
                          "ptxas": _ptxas(log)}), flush=True)
        fn = getattr(ctypes.CDLL(so), kernel.symbol)
        fn.argtypes = kernel.argtypes
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def bench_ms(torch, fn, reps=7, warmup=2):
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", default=None,
                    help="another checkout whose vae_upsample.cu to time too")
    ap.add_argument("--rounds", type=int, default=1,
                    help="timing rounds (each times every variant twice)")
    ap.add_argument("--only", default=None,
                    help="comma-separated variants to build and time")
    args = ap.parse_args()
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        sys.exit("needs a GPU")
    from omnihuman_tpu_torch.ops import cuda_build
    from omnihuman_tpu_torch.ops import vae_kernels as vk

    only = None if args.only is None else args.only.split(",")
    fns = build(cuda_build, vk, args.baseline, only)
    cl = torch.channels_last_3d
    gen = torch.Generator(device="cuda").manual_seed(4343)
    ok = True
    for t, h, w, cin, cout in SHAPES:
        x = (torch.randn((1, cin, t, h, w), generator=gen, device="cuda")
             .to(torch.bfloat16).contiguous(memory_format=cl))
        wt = torch.randn((3, 3, cin, cout), generator=gen,
                         device="cuda") * (9 * cin) ** -0.5
        w4 = vk.pack_upsample_weights(wt.to(torch.bfloat16))
        wk = vk.upsample_weights_kmajor(w4)
        bias = torch.randn(cout, generator=gen, device="cuda") * 0.05
        y = torch.empty((1, cout, t, 2 * h, 2 * w), dtype=torch.bfloat16,
                        device="cuda", memory_format=cl)
        stream = torch.cuda.current_stream().cuda_stream

        def call(name):
            weights = w4 if name == "baseline" else wk
            return (x.data_ptr(), weights.data_ptr(), bias.data_ptr(),
                    y.data_ptr(), 1, t, h, w, cin, cout, stream)

        calls = {name: call(name) for name in fns}
        outs, times = {}, {name: [] for name in fns}
        for name, fn in fns.items():
            y.zero_()
            if fn(*calls[name]) != 0:
                sys.exit(f"{name}: launch failed")
            torch.cuda.synchronize()
            outs[name] = y.float().clone()
        for _ in range(args.rounds):
            for name in list(fns) + list(reversed(fns)):
                times[name].append(
                    bench_ms(torch, lambda: fns[name](*calls[name])))
        want = vk.fused_upsample_conv2d_plain(x, w4, bias).float()
        ref = outs["kernel"]
        peak = ref.abs().max().item()
        err = (ref - want).abs().max().item()
        tol = 2 ** -6 * want.abs().max().item()
        ok = ok and err <= tol and bool(torch.isfinite(ref).all())
        xu = F.interpolate(x, scale_factor=(1, 2, 2), mode="nearest")
        xu = xu.transpose(1, 2).reshape(t, cin, 2 * h, 2 * w).contiguous(
            memory_format=torch.channels_last)
        wl = wt.permute(3, 2, 0, 1).to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        bl = bias.to(torch.bfloat16)
        lib = bench_ms(torch, lambda: F.conv2d(xu, wl, bl, padding=1))
        n_in = t * h * w
        flops = 2.0 * 4 * 4 * cin * cout * n_in
        nbytes = 2.0 * (n_in * cin + 16 * cin * cout + 4 * n_in * cout) \
            + 4.0 * cout
        bound = max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES) * 1e3
        row = {name: dict(ms=times[name],
                          rel_err=((outs[name] - ref).abs().max() / peak
                                   ).item())
               for name in fns}
        print(json.dumps({"shape": [t, h, w, cin, cout],
                          "device": torch.cuda.get_device_name(0),
                          "kernel_vs_plain": dict(max_abs_err=err, tol=tol),
                          "bound_ms": bound, "cudnn_conv2d_ms": lib,
                          "variants": row}), flush=True)
        del x, y, xu, outs, want, ref
        torch.cuda.empty_cache()
    if not ok:
        sys.exit("the kernel disagrees with its plain version")


if __name__ == "__main__":
    main()
