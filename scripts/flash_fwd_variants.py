#!/usr/bin/env python3
"""Time variants of the flash-attention forward kernel K1 on one GPU.

    python3 scripts/flash_fwd_variants.py [--baseline DIR] [--rounds N]
    # from the root of a checkout

Each variant is `omnihuman_tpu_torch/csrc/flash_fwd.cu` with one design
choice undone by a text substitution; every variant is built with the
port's nvcc flags into `omnihuman_tpu_torch/_build/variants/` (one nvcc
each, in parallel; ptxas's registers, spills and warnings printed per
variant) and timed with CUDA events (median of 7, warm) on the same inputs
as the kernel itself, twice a round, in the order kernel, variants,
variants reversed, kernel (`--rounds N` rounds; `--only a,b` builds and
times only those variants). The shapes are those of chip_smoke.py
phase 3 (N=12, D=128, bf16): the flagship self-attention (B=2, 32,768
tokens, k_len 32,760), the same at B=1 with the LSE (the training
forward), the cross-attention to 128 and 512 text tokens with k_lens
(37, Lc) and to the 257 image tokens of i2v; and the self-attention at
D=64. `--baseline DIR` also builds DIR's
`omnihuman_tpu_torch/csrc/flash_fwd.cu` (another checkout of the repo, an
earlier kernel with the same C entry) and times it as "baseline". Outputs
may differ from the kernel's in the last bf16 bit where a variant sums in
another order; the printed error is relative to the kernel's peak. Prints
one JSON line per shape.
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

CFG_128 = "return f(Cfg<128, 128>{});"
CFG_64 = "return f(Cfg<64, 128>{});"
# name -> (what it undoes, [(old, new), ...])
VARIANTS = {
    "bn64": (
        "K/V tiles of 64 keys in place of 128 (D = 128)",
        [(CFG_128, "return f(Cfg<128, 64>{});")]),
    "bn176": (
        "K/V tiles of 176 keys in place of 128 (D = 128; one Q buffer "
        "then fits)",
        [(CFG_128, "return f(Cfg<128, 176>{});")]),
    "short_bn64": (
        "K/V tiles of 64 keys in place of 128 where Lk <= 1024 (D = 128)",
        [(CFG_128, "return Lk > 1024 ? f(Cfg<128, 128>{}) : "
          "f(Cfg<128, 64>{});")]),
    "d64_bn64": (
        "K/V tiles of 64 keys in place of 128 (D = 64)",
        [(CFG_64, "return f(Cfg<64, 64>{});")]),
    "d64_bn176": (
        "K/V tiles of 176 keys in place of 128 (D = 64)",
        [(CFG_64, "return f(Cfg<64, 176>{});")]),
    "no_pingpong": (
        "the two consumer warpgroups issue their products without taking "
        "turns",
        [("constexpr bool kPingPong = true;",
          "constexpr bool kPingPong = false;")]),
    "no_overlap": (
        "S_j's softmax waits for P_{j-1} V_{j-1} too (no overlap within a "
        "warpgroup)",
        [("wgmma_wait<1>();                    // S_j; P V runs on",
          "wgmma_wait<0>();")]),
    "three_stages": (
        "a 3-stage K/V ring in place of 2 (one Q buffer then fits)",
        [("constexpr int kKvStages = 2;", "constexpr int kKvStages = 3;")]),
    "one_q_buffer": (
        "one Q buffer: the next work item's Q loads after this one's store",
        [("2 * kQTile + kRing + 2048 <= kMaxSmem ? 2 : 1;", "1;")]),
    "not_persistent": (
        "one block per work item in place of one persistent block per SM",
        [("const dim3 grid(min(n_work, max(sms, 1)));",
          "const dim3 grid(n_work);")]),
    "neither_schedule": (
        "no ping-pong and no overlap within a warpgroup",
        [("constexpr bool kPingPong = true;",
          "constexpr bool kPingPong = false;"),
         ("wgmma_wait<1>();                    // S_j; P V runs on",
          "wgmma_wait<0>();")]),
    "mask_every_tile": (
        "the mask evaluated on every tile, not only on tiles it cuts",
        [("if (tile_is_cut(k0)) {", "if (true) {")]),
    "exp2f": (
        "the accurate exp2f in place of ex2.approx",
        [("#include \"hopper_common.cuh\"\n",
          "#include \"hopper_common.cuh\"\n#define exp2_approx exp2f\n")]),
}
# (B, Lq, Lk, k_lens, with the LSE, D)
SHAPES = ((2, 32768, 32768, (32760, 32760), False, 128),
          (1, 32768, 32768, (32760,), True, 128),
          (2, 32768, 128, (37, 128), False, 128),
          (2, 32768, 512, (37, 512), False, 128),
          (2, 32768, 257, None, False, 128),
          (2, 32768, 32768, (32760, 32760), False, 64))


def _ptxas(log):
    return [line.strip() for line in log.splitlines()
            if "registers" in line or "spill" in line or "C75" in line
            or "arning" in line]


def build(cuda_build, flash, baseline, only=None):
    src_path = os.path.join(cuda_build.CSRC_DIR, "flash_fwd.cu")
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
        cu = os.path.join(out_dir, f"flash_fwd_{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        jobs[name] = (cu, cuda_build.CSRC_DIR)
    if baseline:
        csrc = os.path.join(os.path.abspath(baseline), "omnihuman_tpu_torch",
                            "csrc")
        jobs["baseline"] = (os.path.join(csrc, "flash_fwd.cu"), csrc)
    procs = {}
    for name, (cu, inc) in jobs.items():
        so = os.path.join(out_dir, f"libflash_fwd_{name}.so")
        cmd = [cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS, "-I", inc,
               "-o", so, cu]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       so)
    kernel = flash.FLASH_FWD_LONG_K
    kernel._entry()
    print(json.dumps({"variant": "kernel", "ptxas": _ptxas(
        cuda_build.build_log(kernel.source))}), flush=True)
    fns = {"kernel": kernel._entry()}
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
                    help="another checkout whose flash_fwd.cu to time too")
    ap.add_argument("--rounds", type=int, default=1,
                    help="timing rounds (each times every variant twice)")
    ap.add_argument("--only", default=None,
                    help="comma-separated variants to build and time")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs a GPU")
    from omnihuman_tpu_torch.ops import cuda_build
    from omnihuman_tpu_torch.ops import flash_attention as flash

    only = None if args.only is None else args.only.split(",")
    fns = build(cuda_build, flash, args.baseline, only)
    n = 12
    gen = torch.Generator(device="cuda").manual_seed(1234)
    for b, lq, lk, k_lens, with_lse, d in SHAPES:
        q, k, v = (torch.randn((b, length, n, d), generator=gen,
                               device="cuda").to(torch.bfloat16)
                   for length in (lq, lk, lk))
        kl = torch.tensor(k_lens or (lk,) * b, dtype=torch.int32,
                          device="cuda")
        o = torch.empty_like(q)
        lse = (torch.empty((b, n, lq), dtype=torch.float32, device="cuda")
               if with_lse else None)
        stream = torch.cuda.current_stream().cuda_stream
        call = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                None if lse is None else lse.data_ptr(), kl.data_ptr(), b,
                lq, lk, n, d,
                *flash._mask_args(None, d, False, (-1, -1), None), stream)
        outs, times = {}, {name: [] for name in fns}
        for name, fn in fns.items():
            if fn(*call) != 0:
                sys.exit(f"{name}: launch failed")
            torch.cuda.synchronize()
            outs[name] = o.float().clone()
        for _ in range(args.rounds):
            for name in list(fns) + list(reversed(fns)):
                times[name].append(bench_ms(torch, lambda: fns[name](*call)))
        ref = outs["kernel"]
        peak = ref.abs().max().item()
        row = {name: dict(ms=times[name],
                          rel_err=((outs[name] - ref).abs().max() / peak
                                   ).item())
               for name in fns}
        print(json.dumps({"B": b, "Lq": lq, "Lk": lk, "k_lens": k_lens,
                          "lse": with_lse, "D": d,
                          "device": torch.cuda.get_device_name(0),
                          "variants": row}), flush=True)
        del q, k, v, o, lse
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
