"""Generation CLI of the port: text-to-video (and t2i, its 1-frame case).

    python -m omnihuman_tpu_torch.cli.generate --task t2v-1.3B \\
        --size 480*832 --frame_num 81 --prompt "..." --save_file clip.mp4

Runs on the GPU unless `--device cpu` is given. Weights are random, made
from a fixed init seed (0); --base_seed seeds the noise. The flags of the
JAX CLI that belong to paths not ported yet are refused with the slice
that brings them.
"""

from __future__ import annotations

import argparse
import sys

# flags of omnihuman_tpu.cli.generate that later slices of the port bring
LATER_FLAGS = {
    "--image": "the i2v slice (ROADMAP queue A, slice 2)",
    "--ckpt_dir": "checkpoint loading in the CLI (ROADMAP queue A, slice 2)",
    "--one_step": "the one-step APT generator (ROADMAP queue A, slice 2)",
    "--prompts_file": "the one-step APT generator (ROADMAP queue A, slice 2)",
    "--generator_ckpt": "the one-step APT generator (ROADMAP queue A, "
                        "slice 2)",
    "--sp_size": "sequence parallelism (ROADMAP queue A, slice 5)",
    "--fsdp_size": "multi-GPU sharding (ROADMAP queue A, slice 5)",
    "--export_step": "serving-step export (ROADMAP queue A, slice 5)",
    "--export_platform": "serving-step export (ROADMAP queue A, slice 5)",
    "--profile": "tracing tools (ROADMAP queue A, slice 5)",
    "--use_prompt_extend": "the Qwen prompt expander (ROADMAP queue A, "
                           "slice 4)",
    "--prompt_extend_target_lang": "the Qwen prompt expander (ROADMAP "
                                   "queue A, slice 4)",
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("omnihuman-tpu-torch generate")
    p.add_argument("--task", default="t2v-1.3B",
                   help="model registry key (t2v-1.3B, t2v-14B, t2i-14B, "
                        "t2v-1.3B-small, tiny-test)")
    p.add_argument("--size", default="480*832",
                   help="HxW key from SIZE_CONFIGS, e.g. 480*832")
    p.add_argument("--frame_num", type=int, default=None)
    p.add_argument("--prompt", default="a cat walking in the rain")
    p.add_argument("--n_prompt", default="")
    p.add_argument("--sample_solver", default="unipc",
                   choices=("unipc", "dpm++"))
    p.add_argument("--sample_steps", type=int, default=None)
    p.add_argument("--sample_shift", type=float, default=None)
    p.add_argument("--sample_guide_scale", type=float, default=None)
    p.add_argument("--base_seed", type=int, default=-1)
    p.add_argument("--precision", default="fast",
                   choices=("fast", "reference", "int8"),
                   help="'fast' = bf16 residual stream (serving default); "
                        "'reference' = fp32 residual; 'int8' comes in a "
                        "later slice")
    p.add_argument("--cfg_mode", default="fused",
                   choices=("fused", "sequential"),
                   help="'sequential' lowers the activation peak, for a "
                        "card with less memory than an 80 GB H100")
    p.add_argument("--save_file", default=None)
    p.add_argument("--device", default=None,
                   help="torch device (default: the GPU; 'cpu' on request)")
    return p


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    for a in argv:
        flag = a.split("=", 1)[0]
        if flag in LATER_FLAGS:
            sys.exit(f"{flag} is not ported yet: it comes with "
                     f"{LATER_FLAGS[flag]}")
    args = build_parser().parse_args(argv)
    if args.precision == "int8":
        sys.exit("--precision int8 is not ported yet: it comes with the "
                 "serving-precision work (ROADMAP queue A, slice 2)")

    from omnihuman_tpu_torch.configs import (
        SIZE_CONFIGS, SUPPORTED_SIZES, WAN_CONFIGS)
    from omnihuman_tpu_torch.pipelines.text2video import WanT2V
    from omnihuman_tpu_torch.utils.media import cache_video

    if args.task not in WAN_CONFIGS:
        sys.exit(f"unknown task {args.task!r}; choose from "
                 f"{sorted(WAN_CONFIGS)}")
    if args.task.startswith("i2v"):
        sys.exit(f"{args.task} is not ported yet: it comes with the i2v "
                 "slice (ROADMAP queue A, slice 2)")
    cfg = WAN_CONFIGS[args.task]
    if args.size in SIZE_CONFIGS:
        if args.size not in SUPPORTED_SIZES[args.task]:
            sys.exit(f"size {args.size} unsupported for {args.task}; "
                     f"choose from {SUPPORTED_SIZES[args.task]}")
        h, w = SIZE_CONFIGS[args.size]
    else:
        try:   # custom "H*W" sizes for smoke runs / small models
            h, w = (int(x) for x in args.size.split("*"))
        except ValueError:
            sys.exit(f"size {args.size} not parseable; registry sizes: "
                     f"{list(SIZE_CONFIGS)}")
    frame_num = args.frame_num or (1 if args.task == "t2i-14B"
                                   else cfg.frame_num)

    pipe = WanT2V(cfg, precision=args.precision, device=args.device)
    video = pipe.generate(
        args.prompt, size=(w, h), frame_num=frame_num,
        shift=args.sample_shift or cfg.sample_shift,
        sample_solver=args.sample_solver,
        sampling_steps=args.sample_steps or cfg.sample_steps,
        guide_scale=args.sample_guide_scale or cfg.sample_guide_scale,
        n_prompt=args.n_prompt, seed=args.base_seed, cfg_mode=args.cfg_mode)

    out = args.save_file or (f"{args.task.replace('-', '_')}_"
                             f"{args.size.replace('*', 'x')}.mp4")
    path = cache_video(video, out, fps=cfg.sample_fps)
    print(f"saved {path}  stage timings: {pipe.timings}")
    return path


if __name__ == "__main__":
    main()
