"""EMA evaluation CLI of the port (reference seaweed_apt/eval_ema.py; JAX
cli/eval_ema.py).

    python -m omnihuman_tpu_torch.cli.eval_ema --task t2v-1.3B \\
        --checkpoint_dir Wan2.1-T2V-1.3B/ --ema_checkpoint distill_out/ \\
        --data_path dummy_data_480x832.npz --num_samples 10

Runs on the GPU unless `--device cpu` is given. `--checkpoint_dir` is a
Wan checkpoint directory, read as `WanT2V(checkpoint_dir=)` reads it (the
DiT, `Wan2.1_VAE.pth`, umT5 where present; random weights without it);
`--ema_checkpoint` names a `cli.train_distill` output directory of the
port, whose latest EMA stream becomes the pipeline's DiT. Prints and
returns the metrics of `apt/eval_ema.py:evaluate_ema`.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    p = argparse.ArgumentParser("omnihuman-tpu-torch eval-ema")
    p.add_argument("--task", default="t2v-1.3B")
    p.add_argument("--checkpoint_dir", default=None)
    p.add_argument("--ema_checkpoint", default=None,
                   help="checkpoint dir of the distill state (EMA stream)")
    p.add_argument("--data_path", default="dummy_data_480x832.npz")
    p.add_argument("--num_samples", type=int, default=10)
    p.add_argument("--out_dir", default="eval_images")
    p.add_argument("--device", default=None,
                   help="torch device (default: the GPU; 'cpu' on request)")
    args = p.parse_args(argv)

    from omnihuman_tpu_torch.apt.eval_ema import evaluate_ema
    from omnihuman_tpu_torch.configs import WAN_CONFIGS
    from omnihuman_tpu_torch.pipelines.text2video import WanT2V
    from omnihuman_tpu_torch.utils.checkpoint import restore_ema_into

    pipe = WanT2V(WAN_CONFIGS[args.task], device=args.device,
                  checkpoint_dir=args.checkpoint_dir)
    if args.ema_checkpoint:
        restore_ema_into(pipe.model, args.ema_checkpoint)
    metrics = evaluate_ema(pipe, args.data_path,
                           num_samples=args.num_samples,
                           out_dir=args.out_dir)
    print(metrics)
    return metrics


if __name__ == "__main__":
    main()
