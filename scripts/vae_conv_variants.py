#!/usr/bin/env python3
"""Time variants of the fused VAE resblock conv kernel K3 on one GPU.

    python3 scripts/vae_conv_variants.py     # from the root of a checkout

Each variant is `omnihuman_tpu_torch/csrc/vae_conv.cu` with one design
choice undone by a text substitution; every variant is built with the
port's nvcc flags into `omnihuman_tpu_torch/_build/variants/` (one nvcc
each, in parallel) and timed with CUDA events (median of 7, warm) on the
same inputs as the kernel itself, at the two largest calls of an 81-frame
480x832 decode (T=4 480x832 96->96 and T=4 240x416 192->192, both with
the residual), at T=2 120x208 384->384 (+residual) and at the encoder's T=4
240x416 96->192 (+residual, as the script gives every shape one; the
ragged Cin chunk). Every variant is
timed twice, in the order kernel, variants, variants reversed, kernel,
beside cuDNN's conv3d of the activated input (a yardstick, as in
chip_smoke.py phase 12). Outputs may differ from the kernel's in the last
bf16 bit where a variant sums in another order; the printed error is
relative to the kernel's peak. Prints one JSON line per shape.
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
    "mt1": (
        "one m64 tile a consumer warpgroup in place of two at BN = 96 (half "
        "the M: twice the weight traffic per FLOP)",
        [("run(launch_conv<96, 2, 64>) : run(launch_conv<96, 2, 32>)",
          "run(launch_conv<96, 1, 64>) : run(launch_conv<96, 1, 32>)")]),
    "two_consumers": (
        "two consumer warpgroups (setmaxnreg 240; M = 256 at BN = 96, 128 "
        "at BN = 192) in place of three (160; M = 384, 192)",
        [("constexpr int kConsumers = 3;", "constexpr int kConsumers = 2;")]),
    "n96_everywhere": (
        "BN = 96 with M = 384 at Cout = 192 and 384 too, in place of "
        "BN = 192 with M = 192: the halo loaded once per 96 channels",
        [("if (Cout % 192 == 0)\n", "if (false)\n")]),
    "chunk32": (
        "32-channel K steps (64-byte swizzle) at every Cin, in place of 64 "
        "(128-byte swizzle) where Cin % 64 == 0",
        [("const bool wide = Cin % 64 == 0;", "const bool wide = false;")]),
    "chunk64": (
        "64-channel K steps at every Cin (a zero-filled half chunk at "
        "Cin = 96) in place of 32 where Cin % 64 != 0",
        [("const bool wide = Cin % 64 == 0;", "const bool wide = true;")]),
    "no_overlap": (
        "each group of products waited for before the next group gathers "
        "its A fragments",
        [("wgmma_wait<1>();   // the group before",
          "wgmma_wait<0>();   // the group before")]),
    "two_stages": (
        "a 2-slot weight ring in place of 4",
        [("constexpr int kMaxWStages = 4;", "constexpr int kMaxWStages = 2;")]),
    "three_stages": (
        "a 3-slot weight ring in place of 4",
        [("constexpr int kMaxWStages = 4;", "constexpr int kMaxWStages = 3;")]),
}
SHAPES = ((4, 480, 832, 96, 96), (4, 240, 416, 192, 192),
          (2, 120, 208, 384, 384), (4, 240, 416, 96, 192))


def build(cuda_build, vk):
    src_path = os.path.join(cuda_build.CSRC_DIR, "vae_conv.cu")
    with open(src_path) as f:
        src = f.read()
    out_dir = os.path.join(cuda_build.BUILD_DIR, "variants")
    os.makedirs(out_dir, exist_ok=True)
    texts = {}
    for name, (_, subs) in VARIANTS.items():
        text = src
        for old, new in subs:
            if text.count(old) != 1:
                sys.exit(f"variant {name}: {old!r} not found once")
            text = text.replace(old, new)
        texts[name] = text
    procs = {}
    for name, text in texts.items():
        cu = os.path.join(out_dir, f"vae_conv_{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        so = os.path.join(out_dir, f"libvae_conv_{name}.so")
        cmd = [cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS, "-I",
               cuda_build.CSRC_DIR, "-o", so, cu]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       so)
    fns = {"kernel": vk.VAE_CONV._entry()}
    for name, (p, so) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            sys.exit(f"nvcc failed for {name}:\n{log}")
        regs = [line.strip() for line in log.splitlines()
                if "registers" in line or "spill" in line
                or "wgmma" in line or "arning" in line]
        print(json.dumps({"variant": name, "what": VARIANTS[name][0],
                          "ptxas": regs}), flush=True)
        fn = getattr(ctypes.CDLL(so), vk.VAE_CONV.symbol)
        fn.argtypes = vk.VAE_CONV.argtypes
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
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        sys.exit("needs a GPU")
    from omnihuman_tpu_torch.ops import cuda_build
    from omnihuman_tpu_torch.ops import vae_kernels as vk

    fns = build(cuda_build, vk)
    cl = torch.channels_last_3d
    gen = torch.Generator(device="cuda").manual_seed(4242)

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    for t, h, w, cin, cout in SHAPES:
        x = rnd(1, cin, t, h, w).to(torch.bfloat16).contiguous(
            memory_format=cl)
        cache = rnd(1, cin, 2, h, w).to(torch.bfloat16).contiguous(
            memory_format=cl)
        gamma = rnd(cin, scale=0.2) + 1.0
        wt = rnd(3, 3, 3, cin, cout, scale=(27 * cin) ** -0.5)
        wk = vk.conv_weights_kmajor(vk.pack_conv_weights(wt))
        bias = rnd(cout, scale=0.05)
        res = rnd(1, cout, t, h, w).to(torch.bfloat16).contiguous(
            memory_format=cl)
        y = torch.empty_like(res)
        new_cache = torch.empty_like(cache)
        act = torch.empty((1, cin, t, h, w), dtype=torch.bfloat16,
                          device="cuda", memory_format=cl)   # scratch
        stream = torch.cuda.current_stream().cuda_stream
        args = (x.data_ptr(), cache.data_ptr(), gamma.data_ptr(),
                wk.data_ptr(), bias.data_ptr(), res.data_ptr(), y.data_ptr(),
                new_cache.data_ptr(), act.data_ptr(), 1, t, h, w, cin, cout,
                stream)
        outs, times = {}, {name: [] for name in fns}
        for name, fn in fns.items():
            if fn(*args) != 0:
                sys.exit(f"{name}: launch failed")
            torch.cuda.synchronize()
            outs[name] = y.float().clone()
        order = list(fns) + list(reversed(fns))
        for name in order:
            times[name].append(bench_ms(torch, lambda: fns[name](*args)))
        ref = outs["kernel"]
        peak = ref.abs().max().item()
        a = torch.cat([cache, vk.activate_plain(x, gamma)], dim=2
                      ).contiguous(memory_format=cl)
        wl = wt.permute(4, 3, 0, 1, 2).to(torch.bfloat16).contiguous(
            memory_format=cl)
        bl = bias.to(torch.bfloat16)
        lib = bench_ms(torch, lambda: F.conv3d(a, wl, bl, padding=(0, 1, 1)))
        pre = bench_ms(torch, lambda: vk.act_cache_cuda(x, cache, gamma))
        row = {name: dict(ms=times[name],
                          rel_err=((outs[name] - ref).abs().max() / peak
                                   ).item())
               for name in fns}
        print(json.dumps({"shape": [t, h, w, cin, cout], "residual": True,
                          "device": torch.cuda.get_device_name(0),
                          "pre_pass_ms": pre, "cudnn_conv3d_ms": lib,
                          "variants": row}), flush=True)
        del x, cache, res, y, new_cache, act, a
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
