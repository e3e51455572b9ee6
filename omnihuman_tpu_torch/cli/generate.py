"""Generation CLI of the port: text-to-video (and t2i, its 1-frame case),
image-to-video and the one-step APT generator.

    python -m omnihuman_tpu_torch.cli.generate --task t2v-1.3B \\
        --size 480*832 --frame_num 81 --prompt "..." --save_file clip.mp4
    python -m omnihuman_tpu_torch.cli.generate --task i2v-14B \\
        --size 480*832 --image first_frame.png --prompt "..."
    python -m omnihuman_tpu_torch.cli.generate --task t2v-1.3B --one_step \\
        --prompts_file prompts.txt --generator_ckpt distill_out/
    python -m omnihuman_tpu_torch.cli.generate --task t2v-1.3B \\
        --size 480*832 --frame_num 81 --export_step t2v_step.pt2
    python -m omnihuman_tpu_torch.cli.generate --profile trace_dir \\
        --use_prompt_extend --prompt "..."
    torchrun --nproc_per_node 4 -m omnihuman_tpu_torch.cli.generate \\
        --task t2v-14B --size 720*1280 --sp_size 4

Runs on the GPU unless `--device cpu` is given. `--ckpt_dir` names a Wan
checkpoint directory in the reference layout (`*.safetensors` DiT shards,
`Wan2.1_VAE.pth`, and `models_t5_umt5-xxl-enc-bf16.pth` where present);
without it the weights are random, made from a fixed init seed (0).
--base_seed seeds the noise. With `--one_step`, `--generator_ckpt` names
a training checkpoint whose EMA stream replaces the DiT. `--export_step`
writes the CFG denoise step as a `torch.export` program instead of
generating (utils/export.py); `--profile DIR` records a torch.profiler
trace of the request in DIR; `--use_prompt_extend` expands the prompt
first (DashScope where DASH_API_KEY is set, else the local Qwen expander,
whose template fallback needs no weights).

`--sp_size` / `--fsdp_size` above 1 run one process per GPU under
torchrun (NCCL; gloo with `--device cpu`) on a (data, fsdp, sp) mesh,
data taking the rest of the world (`parallel.mesh_from_flags`): the ring /
sp_cross attention over `sp`, FSDP2 over `fsdp`; rank 0 writes the file.
`--one_step` and `--export_step` run on one device.
"""

from __future__ import annotations

import argparse
import contextlib
import sys


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
    p.add_argument("--export_step", default=None, metavar="PATH",
                   help="instead of generating, export the CFG denoise "
                        "step for this task / size / frame_num as a "
                        "torch.export program (utils/export.py; weights "
                        "are its input, a .json sidecar beside it)")
    p.add_argument("--export_platform", default=None,
                   choices=("cuda", "cpu", "tpu"),
                   help="device the exported step is traced for (default: "
                        "cpu with --device cpu, else cuda); tpu artifacts "
                        "are the JAX package's")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="record a torch.profiler trace of the generation "
                        "as DIR/trace.json")
    p.add_argument("--use_prompt_extend", action="store_true",
                   help="expand the prompt with an LLM first (DashScope "
                        "with DASH_API_KEY, else the local Qwen expander, "
                        "whose template fallback needs no weights)")
    p.add_argument("--prompt_extend_target_lang", default="en",
                   choices=("en", "zh"))
    p.add_argument("--sp_size", type=int, default=1,
                   help="sequence-parallel degree (ring attention over the "
                        "token axis; one process per GPU under torchrun)")
    p.add_argument("--fsdp_size", type=int, default=1,
                   help="parameter-sharding degree (FSDP2 over the DiT and "
                        "umT5; one process per GPU under torchrun)")
    p.add_argument("--save_file", default=None)
    p.add_argument("--device", default=None,
                   help="torch device (default: the GPU; 'cpu' on request)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    multi = args.sp_size > 1 or args.fsdp_size > 1
    if multi and args.one_step:
        sys.exit("--one_step on a mesh needs the W-sharded VAE decode "
                 "(ROADMAP queue A, item 19, part 3); run it on one device")
    if multi and args.export_step:
        sys.exit("--export_step exports the single-device step; drop "
                 "--sp_size / --fsdp_size")
    if args.precision == "int8" and args.fsdp_size > 1:
        sys.exit("--precision int8 with --fsdp_size > 1: FSDP2 does not "
                 "shard the int8 weights (buffers) yet (ROADMAP queue A, "
                 "item 19, part 3)")
    import torch.distributed as dist
    owned = not dist.is_initialized()
    try:
        return _main(args)
    finally:
        if multi and owned and dist.is_initialized():
            dist.destroy_process_group()


def _main(args):
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
    from omnihuman_tpu_torch.parallel.mesh import is_writer, mesh_from_flags
    mesh, args.device = mesh_from_flags(args.fsdp_size, args.sp_size,
                                        args.device)

    if args.export_step:
        return _export(args, cfg, (w, h), frame_num, i2v)
    if args.use_prompt_extend:
        args.prompt = _extend_prompt(args)

    out = args.save_file or (f"{args.task.replace('-', '_')}_"
                             f"{args.size.replace('*', 'x')}.mp4")
    sampling = dict(shift=args.sample_shift or cfg.sample_shift,
                    sample_solver=args.sample_solver,
                    sampling_steps=args.sample_steps or cfg.sample_steps,
                    guide_scale=(args.sample_guide_scale
                                 or cfg.sample_guide_scale),
                    n_prompt=args.n_prompt, seed=args.base_seed,
                    cfg_mode=args.cfg_mode)
    prof = contextlib.nullcontext()
    if args.profile and is_writer():
        from omnihuman_tpu_torch.utils.logging import profile_trace
        prof = profile_trace(args.profile)
    if i2v:
        import numpy as np
        from PIL import Image

        from omnihuman_tpu_torch.pipelines.image2video import WanI2V
        pipe = WanI2V(cfg, precision=args.precision, device=args.device,
                      checkpoint_dir=args.ckpt_dir, mesh=mesh)
        img = np.asarray(Image.open(args.image).convert("RGB"),
                         np.float32).transpose(2, 0, 1) / 127.5 - 1.0
        with prof:
            video = pipe.generate(args.prompt, img, max_area=h * w,
                                  frame_num=frame_num, **sampling)
        timings = pipe.timings
    elif args.one_step:
        return _one_step(args, cfg, (w, h), frame_num, out, prof)
    else:
        pipe = WanT2V(cfg, precision=args.precision, device=args.device,
                      checkpoint_dir=args.ckpt_dir, mesh=mesh)
        with prof:
            video = pipe.generate(args.prompt, size=(w, h),
                                  frame_num=frame_num, **sampling)
        timings = pipe.timings
    if not is_writer():          # one file per run: rank 0's
        return None
    path = cache_video(video, out, fps=cfg.sample_fps)
    print(f"saved {path}  stage timings: {timings}")
    return path


def _export(args, cfg, size, frame_num: int, i2v: bool) -> str:
    """--export_step: the CFG denoise step as a torch.export program."""
    from omnihuman_tpu_torch.utils.export import (
        export_i2v_denoise_step, export_t2v_denoise_step)
    from omnihuman_tpu_torch.utils.logging import logger
    platform = args.export_platform or (
        "cpu" if args.device == "cpu" else "cuda")
    if platform == "tpu":
        sys.exit("--export_platform tpu: a TPU artifact is the JAX "
                 "package's (omnihuman_tpu.utils.export); the port exports "
                 "for cuda or cpu")
    guide = (args.sample_guide_scale if args.sample_guide_scale is not None
             else cfg.sample_guide_scale)
    exporter = export_i2v_denoise_step if i2v else export_t2v_denoise_step
    path = exporter(cfg, size, frame_num, args.export_step,
                    guide_scale=guide, platforms=(platform,),
                    cfg_mode=args.cfg_mode, precision=args.precision)
    logger.info(f"exported serving step -> {path} (+.json sidecar)")
    return path


def _extend_prompt(args) -> str:
    """--use_prompt_extend: DashScope where DASH_API_KEY is set, else the
    local Qwen expander on --device; the prompt unchanged on failure."""
    import os

    from omnihuman_tpu_torch.utils.logging import logger
    from omnihuman_tpu_torch.utils.prompt_extend import (
        DashScopePromptExpander, QwenPromptExpander)
    expander = (DashScopePromptExpander() if os.environ.get("DASH_API_KEY")
                else QwenPromptExpander(device=args.device))
    out = expander(args.prompt, tar_lang=args.prompt_extend_target_lang,
                   seed=max(args.base_seed, 0))
    if out.status:
        logger.info(f"prompt extended ({out.message}): {out.prompt}")
        return out.prompt
    logger.warning(f"prompt extension failed: {out.message}")
    return args.prompt


def _one_step(args, cfg, size, frame_num: int, out: str, prof):
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
        with prof:
            videos = gen.generate_batch(prompts, size=size,
                                        frame_num=frame_num,
                                        seed=args.base_seed)
        root, ext = os.path.splitext(out)
        paths = [cache_video(videos[i], f"{root}_{i:02d}{ext}",
                             fps=cfg.sample_fps)
                 for i in range(videos.shape[0])]
        print(f"saved {paths}  one-step timings: {gen.timings}")
        return paths
    with prof:
        video = gen.generate(args.prompt, size=size, frame_num=frame_num,
                             seed=args.base_seed)
    path = cache_video(video, out, fps=cfg.sample_fps)
    print(f"saved {path}  one-step timings: {gen.timings}")
    return path


if __name__ == "__main__":
    main()
