#!/usr/bin/env python3
"""Time variants of the flash-attention backward kernel K2 on one GPU.

    python3 scripts/flash_bwd_variants.py     # from the root of a checkout

Each variant is `omnihuman_tpu_torch/csrc/flash_bwd.cu` with one design
choice undone by a text substitution; every variant is built with the
port's nvcc flags into `omnihuman_tpu_torch/_build/variants/` (one nvcc
each, in parallel) and timed with CUDA events (median of 7, warm) on the
same inputs as the kernel itself, at the flagship self-attention (B=1,
32,768 tokens, k_len 32,760), the cross-attention to 512 text tokens and
the training CLIs' 1,560 tokens (N=12, D=128, bf16). dK / dV of a variant
may differ from the kernel's in the last bf16 bit (another summation
order); the printed errors are relative to the kernel's peak. Prints one
JSON line per shape.
"""

import ctypes
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# name -> (what it undoes, [(old, new), ...])
VARIANTS = {
    "no_stagger": (
        "every block walks the query tiles from the first",
        [("const int j0 = blockIdx.x % n_qt;", "const int j0 = 0;")]),
    "exp2f": (
        "the accurate exp2f in place of ex2.approx",
        [("#include \"hopper_common.cuh\"\n",
          "#include \"hopper_common.cuh\"\n#define exp2_approx exp2f\n")]),
    "three_stages": (
        "a 3-stage ring of query tiles in place of 2",
        [("constexpr int kStages = 2;", "constexpr int kStages = 3;")]),
}
SHAPES = ((32768, 32768, 32760), (32768, 512, 512), (1560, 1560, 1560))


def build(cuda_build, flash):
    src_path = os.path.join(cuda_build.CSRC_DIR, "flash_bwd.cu")
    with open(src_path) as f:
        src = f.read()
    out_dir = os.path.join(cuda_build.BUILD_DIR, "variants")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, (_, subs) in VARIANTS.items():
        text = src
        for old, new in subs:
            if text.count(old) != 1:
                sys.exit(f"variant {name}: {old!r} not found once")
            text = text.replace(old, new)
        cu = os.path.join(out_dir, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        so = os.path.join(out_dir, f"lib{name}.so")
        cmd = [cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS, "-I",
               cuda_build.CSRC_DIR, "-o", so, cu]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       so)
    fns = {"kernel": flash.FLASH_BWD._entry()}
    for name, (p, so) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            sys.exit(f"nvcc failed for {name}:\n{log}")
        fn = getattr(ctypes.CDLL(so), flash.FLASH_BWD.symbol)
        fn.argtypes = flash.FLASH_BWD.argtypes
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
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs a GPU")
    from omnihuman_tpu_torch.ops import cuda_build
    from omnihuman_tpu_torch.ops import flash_attention as flash

    fns = build(cuda_build, flash)
    n, d = 12, 128
    gen = torch.Generator(device="cuda").manual_seed(4321)
    for lq, lk, k_len in SHAPES:
        q, k, v, dout = (torch.randn((1, length, n, d), generator=gen,
                                     device="cuda").to(torch.bfloat16)
                         for length in (lq, lk, lk, lq))
        kl = torch.tensor([k_len], dtype=torch.int32, device="cuda")
        out, lse = flash.flash_attention_cuda(q, k, v, k_lens=kl,
                                              return_lse=True)
        delta = flash.bwd_delta(out, dout)
        stream = torch.cuda.current_stream().cuda_stream
        row, ref = {}, None
        for name, fn in fns.items():
            dq = torch.zeros(q.shape, dtype=torch.float32, device="cuda")
            dk, dv = torch.empty_like(k), torch.empty_like(v)
            args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                    lse.data_ptr(), delta.data_ptr(), kl.data_ptr(),
                    dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), 1, lq, lk,
                    n, d, *flash._mask_args(None, d, False, (-1, -1), None),
                    stream)
            if fn(*args) != 0:
                sys.exit(f"{name}: launch failed")
            torch.cuda.synchronize()
            # copies: the timed launches below add into dq again
            grads = [dq.clone(), dk.float(), dv.float()]
            if ref is None:
                ref = grads
            err = [((a - b).abs().max() / b.abs().max()).item()
                   for a, b in zip(grads, ref)]
            row[name] = dict(ms=bench_ms(torch, lambda: fn(*args)),
                             rel_err_dq_dk_dv=err)
        print(json.dumps({"Lq": lq, "Lk": lk, "k_len": k_len,
                          "device": torch.cuda.get_device_name(0),
                          "variants": row}), flush=True)


if __name__ == "__main__":
    main()
