"""Generation CLI of the port: text-to-video (and t2i, its 1-frame case),
image-to-video and the one-step APT generator.

    python -m omnihuman_tpu_torch.cli.generate --task t2v-1.3B \\
        --size 480*832 --frame_num 81 --prompt "..." --save_file clip.mp4
    python -m omnihuman_tpu_torch.cli.generate --task i2v-14B \\
        --size 480*832 --image first_frame.png --prompt "..."
    python -m omnihuman_tpu_torch.cli.generate --task t2v-1.3B --one_step \\
        --prompts_file prompts.txt --generator_ckpt distill_out/

Runs on the GPU unless `--device cpu` is given. `--ckpt_dir` names a Wan
checkpoint directory in the reference layout (`*.safetensors` DiT shards,
`Wan2.1_VAE.pth`, and `models_t5_umt5-xxl-enc-bf16.pth` where present);
without it the weights are random, made from a fixed init seed (0).
--base_seed seeds the noise. With `--one_step`, `--generator_ckpt` names
a training checkpoint whose EMA stream replaces the DiT. The flags of the JAX CLI that belong to
paths not ported yet are refused with the slice that brings them.
"""

from __future__ import annotations

import argparse
import sys

# flags of omnihuman_tpu.cli.generate that later slices of the port bring
LATER_FLAGS = {
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
                   help="model registry key (t2v-1.3B, t2v-14B, i2v-14B, "
                        "t2i-14B, t2v-1.3B-small, tiny-test)")
    p.add_argument("--size", default="480*832",
                   help="HxW key from SIZE_CONFIGS, e.g. 480*832")
    p.add_argument("--frame_num", type=int, default=None)
    p.add_argument("--prompt", default="a cat walking in the rain")
    p.add_argument("--image", default=None, help="reference image (i2v)")
    p.add_argument("--ckpt_dir", default=None, metavar="DIR",
                   help="Wan checkpoint directory in the reference layout: "
                        "*.safetensors (the DiT), Wan2.1_VAE.pth, and "
                        "models_t5_umt5-xxl-enc-bf16.pth when present "
                        "(default: random weights from seed 0)")
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
                        "'reference' = fp32 residual; 'int8' = fast with "
                        "W8A8 int8 DiT block GEMMs (ops/quant.py)")
    p.add_argument("--cfg_mode", default="fused",
                   choices=("fused", "sequential"),
                   help="'sequential' lowers the activation peak, for a "
                        "card with less memory than an 80 GB H100")
    p.add_argument("--one_step", action="store_true",
                   help="Seaweed-APT one-step generation: one DiT forward "
                        "at t=T, then the VAE decode")
    p.add_argument("--prompts_file", default=None, metavar="TXT",
                   help="one-step batch serving: one prompt per line, all "
                        "clips in one batched forward and decode; outputs "
                        "get a _NN suffix. Requires --one_step")
    p.add_argument("--generator_ckpt", default=None, metavar="DIR",
                   help="directory of a training checkpoint of the port "
                        "(utils/checkpoint.py, from cli.train_distill); "
                        "its EMA stream becomes the one-step generator")
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

    from omnihuman_tpu_torch.configs import (
        SIZE_CONFIGS, SUPPORTED_SIZES, WAN_CONFIGS)
    from omnihuman_tpu_torch.pipelines.text2video import WanT2V
    from omnihuman_tpu_torch.utils.media import cache_video

    if args.task not in WAN_CONFIGS:
        sys.exit(f"unknown task {args.task!r}; choose from "
                 f"{sorted(WAN_CONFIGS)}")
    cfg = WAN_CONFIGS[args.task]
    i2v = cfg.model.model_type == "i2v"
    if args.prompts_file and not args.one_step:
        sys.exit("--prompts_file is the one-step batch-serving mode; pass "
                 "--one_step")
    if args.one_step and i2v:
        sys.exit("--one_step is the Seaweed-APT t2v path; i2v tasks have "
                 "no one-step generator")
    if i2v and not args.image:
        sys.exit(f"{args.task} needs --image")
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

    out = args.save_file or (f"{args.task.replace('-', '_')}_"
                             f"{args.size.replace('*', 'x')}.mp4")
    sampling = dict(shift=args.sample_shift or cfg.sample_shift,
                    sample_solver=args.sample_solver,
                    sampling_steps=args.sample_steps or cfg.sample_steps,
                    guide_scale=(args.sample_guide_scale
                                 or cfg.sample_guide_scale),
                    n_prompt=args.n_prompt, seed=args.base_seed,
                    cfg_mode=args.cfg_mode)
    if i2v:
        import numpy as np
        from PIL import Image

        from omnihuman_tpu_torch.pipelines.image2video import WanI2V
        pipe = WanI2V(cfg, precision=args.precision, device=args.device,
                      checkpoint_dir=args.ckpt_dir)
        img = np.asarray(Image.open(args.image).convert("RGB"),
                         np.float32).transpose(2, 0, 1) / 127.5 - 1.0
        video = pipe.generate(args.prompt, img, max_area=h * w,
                              frame_num=frame_num, **sampling)
        timings = pipe.timings
    elif args.one_step:
        return _one_step(args, cfg, (w, h), frame_num, out)
    else:
        pipe = WanT2V(cfg, precision=args.precision, device=args.device,
                      checkpoint_dir=args.ckpt_dir)
        video = pipe.generate(args.prompt, size=(w, h), frame_num=frame_num,
                              **sampling)
        timings = pipe.timings
    path = cache_video(video, out, fps=cfg.sample_fps)
    print(f"saved {path}  stage timings: {timings}")
    return path


def _one_step(args, cfg, size, frame_num: int, out: str):
    """--one_step: the pipeline's DiT (from --ckpt_dir or random), or the
    EMA stream of the training checkpoint in --generator_ckpt, one forward
    per batch of prompts."""
    import os

    from omnihuman_tpu_torch.ops.quant import quantize_wan_model
    from omnihuman_tpu_torch.pipelines.text2video import WanT2V
    from omnihuman_tpu_torch.pipelines.wan_inference import (
        SeaweedWanAPTGenerator)
    from omnihuman_tpu_torch.utils.checkpoint import restore_ema_into
    from omnihuman_tpu_torch.utils.media import cache_video

    # int8 quantizes after the checkpoint's weights are in
    int8 = args.precision == "int8"
    pipe = WanT2V(cfg, precision="fast" if int8 else args.precision,
                  device=args.device, checkpoint_dir=args.ckpt_dir)
    if args.generator_ckpt:
        restore_ema_into(pipe.model, args.generator_ckpt)
    if int8:
        quantize_wan_model(pipe.model)
        pipe.precision = "int8"
    gen = SeaweedWanAPTGenerator(pipe)
    if args.prompts_file:
        with open(args.prompts_file, encoding="utf-8") as f:
            prompts = [ln.strip() for ln in f if ln.strip()]
        if not prompts:
            sys.exit(f"{args.prompts_file} contains no prompts")
        videos = gen.generate_batch(prompts, size=size, frame_num=frame_num,
                                    seed=args.base_seed)
        root, ext = os.path.splitext(out)
        paths = [cache_video(videos[i], f"{root}_{i:02d}{ext}",
                             fps=cfg.sample_fps)
                 for i in range(videos.shape[0])]
        print(f"saved {paths}  one-step timings: {gen.timings}")
        return paths
    video = gen.generate(args.prompt, size=size, frame_num=frame_num,
                         seed=args.base_seed)
    path = cache_video(video, out, fps=cfg.sample_fps)
    print(f"saved {path}  one-step timings: {gen.timings}")
    return path


if __name__ == "__main__":
    main()
