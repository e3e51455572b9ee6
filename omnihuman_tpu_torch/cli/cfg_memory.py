"""Peak device memory and time of one CFG step, fused against sequential.

    python -m omnihuman_tpu_torch.cli.cfg_memory --task t2v-14B --size 720*1280

Builds the task's DiT at full size with random bf16 weights (seed 0) on the
GPU, then runs one classifier-free-guidance step in each `cfg_mode` at the
size's geometry (81 frames) on random latents and a random 128-token
context. Prints one JSON line per mode: the peak of allocated device memory
over the step (the weights included), the card's total memory, and the
step's wall time (one cold call: it includes cuBLAS's first-call set-up).
A mode that runs out of device memory is reported as such. `WanT2V`'s
default `cfg_mode` rests on these numbers.
"""

from __future__ import annotations

import argparse
import json
import time


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--task", default="t2v-14B")
    p.add_argument("--size", default="720*1280")
    p.add_argument("--frame_num", type=int, default=81)
    p.add_argument("--precision", default="reference",
                   choices=("reference", "fast"))
    args = p.parse_args(argv)

    import torch
    from omnihuman_tpu_torch.configs import SIZE_CONFIGS, WAN_CONFIGS
    from omnihuman_tpu_torch.models.wan_dit import latent_rope
    from omnihuman_tpu_torch.pipelines.text2video import WanT2V, cfg_model_step

    cfg = WAN_CONFIGS[args.task]
    h, w = SIZE_CONFIGS[args.size]
    pipe = WanT2V(cfg, precision=args.precision)
    dev = pipe.device
    lat = pipe.latent_shape((w, h), args.frame_num)
    grid = tuple(n // s for n, s in zip(lat[1:], pipe.patch_size))
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((1,) + lat, generator=gen, device=dev)
    ctx2 = torch.randn((2, 128, cfg.model.text_dim), generator=gen,
                       device=dev)
    lens = torch.tensor([37, 12], dtype=torch.int32, device=dev)
    geo = latent_rope(cfg.model, lat, dev, sp=pipe.sp_size)
    seq_len, sin, cos = geo["seq_len"], geo["rope_sin"], geo["rope_cos"]
    total = torch.cuda.get_device_properties(dev).total_memory
    weights = torch.cuda.memory_allocated(dev)
    for mode in ("fused", "sequential"):
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        row = dict(task=args.task, size=args.size, frames=args.frame_num,
                   tokens=grid[0] * grid[1] * grid[2], seq_len=seq_len,
                   precision=args.precision, cfg_mode=mode,
                   card=torch.cuda.get_device_name(dev), total_bytes=total,
                   before_step_bytes=weights)
        try:
            with torch.inference_mode():
                v = cfg_model_step(pipe.model, x, 900.0, ctx2, sin, cos,
                                   lens, policy=pipe.policy, seq_len=seq_len,
                                   guide_scale=5.0, cfg_mode=mode)
            torch.cuda.synchronize(dev)
            row.update(step_ms=(time.perf_counter() - t0) * 1e3,
                       finite=bool(torch.isfinite(v).all()))
            del v
        except torch.cuda.OutOfMemoryError:
            row.update(out_of_memory=True)
        row.update(peak_bytes=torch.cuda.max_memory_allocated(dev))
        torch.cuda.empty_cache()
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
