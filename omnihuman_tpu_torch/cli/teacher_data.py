"""Teacher-data CLI of the port (the reference's seaweed_apt/generate.py
mode): the teacher's CFG velocities at t = 999 for N prompts, saved as
`out_dir/dummy_data_{H}x{W}.npz`.

    python -m omnihuman_tpu_torch.cli.teacher_data --task t2v-1.3B \\
        --num_samples 100 --size 480*832 --out_dir data/

Runs on the GPU unless `--device cpu` is given. `--checkpoint_dir` loads
the DiT from a reference checkpoint directory (`*.safetensors`); without
it the weights are random, made from a fixed init seed (0).
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    p = argparse.ArgumentParser("omnihuman-tpu-torch teacher-data")
    p.add_argument("--task", default="t2v-1.3B")
    p.add_argument("--checkpoint_dir", default=None)
    p.add_argument("--num_samples", type=int, default=100)
    p.add_argument("--size", default="480*832")
    p.add_argument("--base_seed", type=int, default=0)
    p.add_argument("--cfg_scale", type=float, default=7.5)
    p.add_argument("--out_dir", default=".")
    p.add_argument("--device", default=None,
                   help="torch device (default: the GPU; 'cpu' on request)")
    args = p.parse_args(argv)

    from omnihuman_tpu_torch.apt.generate import generate_batch
    from omnihuman_tpu_torch.configs import SIZE_CONFIGS, WAN_CONFIGS
    from omnihuman_tpu_torch.pipelines.text2video import WanT2V
    from omnihuman_tpu_torch.utils.convert import load_wan_dit_checkpoint

    if args.size not in SIZE_CONFIGS:
        sys.exit(f"unknown size {args.size!r}; choose from "
                 f"{list(SIZE_CONFIGS)}")
    if args.task not in WAN_CONFIGS:
        sys.exit(f"unknown task {args.task!r}; choose from "
                 f"{sorted(WAN_CONFIGS)}")
    pipe = WanT2V(WAN_CONFIGS[args.task], device=args.device)
    if args.checkpoint_dir:
        load_wan_dit_checkpoint(pipe.model, args.checkpoint_dir)
    data = generate_batch(
        pipe, num_samples=args.num_samples, size=SIZE_CONFIGS[args.size],
        base_seed=args.base_seed, cfg_scale=args.cfg_scale,
        out_dir=args.out_dir)
    print({k: getattr(v, "shape", len(v)) for k, v in data.items()},
          flush=True)
    return data


if __name__ == "__main__":
    main()
