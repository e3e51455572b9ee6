#!/usr/bin/env python3
"""Quick check of the flash-attention forward kernel K1 on one GPU.

    python3 scripts/flash_fwd_check.py [--time]   # from a checkout's root

Builds `omnihuman_tpu_torch/csrc/flash_fwd.cu` (the port's nvcc flags),
prints what ptxas says of each kernel (registers, spills, and any wgmma
serialization or injected-wait remark, C75xx), then holds the kernel
against its plain version on six small shapes (ragged, k_lens with a
k_len = 0 row, Lk = 257, causal, D = 64 and 128): O within 2^-6 of the
plain peak and the LSE within 1e-3, printing OK or BAD per shape. With
`--time` it also times the wrapper (CUDA events, warm, median of 7) at
chip_smoke.py phase 3's shapes beside SDPA, and the B=1 forward with the
LSE. The short first call on the card after a change to the kernel;
chip_smoke.py and tests/test_torch_kernels_cuda.py are the full checks.
"""

import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def bench_ms(torch, fn, reps=7):
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        e.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(e))
    return statistics.median(times)


def main():
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        sys.exit("needs a GPU")
    from omnihuman_tpu_torch.ops import cuda_build
    from omnihuman_tpu_torch.ops.flash_attention import (
        flash_attention_cuda, flash_attention_plain)

    t0 = time.time()
    cuda_build.build(["flash_fwd.cu"])
    print(f"build {time.time() - t0:.1f} s", flush=True)
    for line in cuda_build.build_log("flash_fwd.cu").splitlines():
        if any(w in line for w in ("entry", "registers", "spill", "arning",
                                   "C75")):
            print("  ", line.strip()[:200])
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def rnd(b, length, n, d):
        return torch.randn((b, length, n, d), generator=g, device=dev
                           ).to(torch.bfloat16)

    bad = 0
    # (B, Lq, Lk, N, D, k_lens or "causal" or None)
    for b, lq, lk, n, d, extra in (
            (1, 128, 128, 1, 128, None), (1, 300, 77, 2, 128, None),
            (2, 1000, 777, 3, 64, (777, 0)), (2, 513, 257, 2, 128, None),
            (1, 700, 700, 2, 128, "causal"),
            (2, 4096, 4096, 4, 128, (4000, 4096))):
        q, k, v = rnd(b, lq, n, d), rnd(b, lk, n, d), rnd(b, lk, n, d)
        kw = {}
        if isinstance(extra, tuple):
            kw["k_lens"] = torch.tensor(extra, dtype=torch.int32, device=dev)
        elif extra == "causal":
            kw["causal"] = True
        got, lse = flash_attention_cuda(q, k, v, return_lse=True, **kw)
        torch.cuda.synchronize()
        want, want_lse = flash_attention_plain(q, k, v, return_lse=True,
                                               **kw)
        err = (got.float() - want.float()).abs().max().item()
        tol = 2 ** -6 * want.float().abs().max().item()
        lse_err = (lse - want_lse).abs().max().item()
        ok = err <= tol and lse_err <= 1e-3
        bad += not ok
        print(f"case {(b, lq, lk, n, d, extra)}: err {err:.3g} tol {tol:.3g} "
              f"lse err {lse_err:.3g} {'OK' if ok else 'BAD'}", flush=True)

    if "--time" in sys.argv:
        L = 32768
        q = rnd(2, L, 12, 128)
        for lk, kl in ((L, (32760, 32760)), (128, (37, 128)),
                       (512, (37, 512)), (257, None)):
            k, v = rnd(2, lk, 12, 128), rnd(2, lk, 12, 128)
            klt = (None if kl is None else
                   torch.tensor(kl, dtype=torch.int32, device=dev))
            ms = bench_ms(torch, lambda: flash_attention_cuda(q, k, v,
                                                              k_lens=klt))
            mask = (None if klt is None else
                    (torch.arange(lk, device=dev)[None] < klt[:, None]
                     )[:, None, None, :])
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            sdpa = bench_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask))
            print(f"time Lk={lk} k_lens={kl}: K1 {ms:.3f} ms, SDPA "
                  f"{sdpa:.3f} ms", flush=True)
        q1, k1, v1 = rnd(1, L, 12, 128), rnd(1, L, 12, 128), rnd(1, L, 12, 128)
        kl1 = torch.tensor([32760], dtype=torch.int32, device=dev)
        ms = bench_ms(torch, lambda: flash_attention_cuda(
            q1, k1, v1, k_lens=kl1, return_lse=True))
        print(f"time LSE B=1: K1 {ms:.3f} ms", flush=True)
    print(f"device {torch.cuda.get_device_name(0)}", flush=True)
    sys.exit(1 if bad else 0)


if __name__ == "__main__":
    main()
