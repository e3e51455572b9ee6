"""Stage-2 Seaweed-APT adversarial post-training CLI of the port (reference
apt_trainer.py __main__, :379-489; JAX cli/train_apt.py). A YAML
`--config` fills the flags left unset.

    python -m omnihuman_tpu_torch.cli.train_apt --task t2v-1.3B \\
        --checkpoint_dir Wan2.1-T2V-1.3B/ --consistency_path distill_out/ \\
        --data_path dummy_data_480x832.npz --output_dir apt_out/

Runs on one GPU unless `--device cpu` is given; --fsdp_size / --sp_size
above 1 train on a (data, fsdp, sp) mesh under torchrun, as
`cli.train_distill` does (the generator and the frozen backbone sharded by
FSDP2; every rank draws the global batch and keeps its data slice). The
Wan DiT of
`--checkpoint_dir` (`*.safetensors`; random from init seed 0 without it,
bf16) is the discriminator's frozen backbone; the generator starts from
the EMA of the distill checkpoint in `--consistency_path`, or from a copy
of that DiT. Two phases (`apt/apt_trainer.py`): the image phase on
`--data_path`, then the video phase on `--video_data_path` (default: the
same file) with the generator restarted from the image-phase EMA, a fresh
discriminator on the same backbone and fresh optimizers. Each update is
one D step and one G step on a batch of real = noise - v_teacher, fresh
noise and the positive contexts; the batch indices and the noise are
numpy draws from default_rng(seed + 1), as in JAX, the D / G timestep and
R1 draws come from a torch.Generator seeded with --seed. A checkpoint
every `--save_interval` updates (not on a phase's last) and one at each
phase's end, numbered globally (the video phase's after the image
phase's), with metadata {"phase", "update"[, "final"]}. `--resume` goes
on from the latest. `main` returns (state, history): the final APTState
and one {"phase", "update", "d_seconds", "g_seconds", metrics...} record
per update.
"""

from __future__ import annotations

import argparse
import time


def _build_batch(data, sel, rng, device):
    """GAN batch from the teacher artifact: real = the teacher's one-step
    x0 (noise - v_teacher), fresh numpy noise, positive contexts."""
    import numpy as np
    import torch
    noise = rng.normal(size=data["noise"][sel].shape).astype(np.float32)
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return {"real": put(data["noise"][sel] - data["v_teacher"][sel]),
            "noise": put(noise),
            "context": put(data["positive_contexts"][sel])}


def main(argv=None):
    from omnihuman_tpu_torch.parallel.train_mesh import add_mesh_args
    p = argparse.ArgumentParser("omnihuman-tpu-torch train-apt")
    p.add_argument("--config", default=None, help="optional YAML")
    p.add_argument("--task", default="t2v-1.3B")
    p.add_argument("--checkpoint_dir", default=None,
                   help="Wan weights (*.safetensors; None = random init)")
    p.add_argument("--consistency_path", default=None,
                   help="distill checkpoint dir to boot the generator "
                        "(EMA stream); default = copy of the teacher")
    p.add_argument("--data_path", default="dummy_data_480x832.npz",
                   help="teacher npz for the image phase")
    p.add_argument("--video_data_path", default=None,
                   help="teacher npz for the video phase (defaults to "
                        "--data_path)")
    p.add_argument("--output_dir", default="checkpoints/apt")
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--image_updates", type=int, default=None)
    p.add_argument("--video_updates", type=int, default=None)
    p.add_argument("--g_lr_image", type=float, default=None)
    p.add_argument("--d_lr_image", type=float, default=None)
    p.add_argument("--g_lr_video", type=float, default=None)
    p.add_argument("--d_lr_video", type=float, default=None)
    p.add_argument("--lambda_r1", type=float, default=None)
    p.add_argument("--ema_decay", type=float, default=None)
    p.add_argument("--save_interval", type=int, default=50)
    p.add_argument("--log_interval", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--wandb_project", default="seaweed-apt-stage2")
    p.add_argument("--wandb_run_name", default=None)
    p.add_argument("--grad_accumulation", type=int, default=1,
                   help="micro-batches averaged per optimizer update "
                        "(MultiSteps), toward the paper's 9062/2048 batches")
    p.add_argument("--device", default=None,
                   help="torch device (default: the GPU; 'cpu' on request)")
    add_mesh_args(p)
    args = p.parse_args(argv)

    if args.config:
        from omnihuman_tpu_torch.utils.config_io import load_yaml, merge_args
        merge_args(load_yaml(args.config), args)

    import copy

    import numpy as np
    import torch

    from omnihuman_tpu_torch.apt import apt_trainer as tr
    from omnihuman_tpu_torch.apt.generate import (
        latent_rope, load_teacher_data)
    from omnihuman_tpu_torch.apt.model import init_apt_discriminator
    from omnihuman_tpu_torch.configs import WAN_CONFIGS
    from omnihuman_tpu_torch.models.wan_dit import build_wan_model
    from omnihuman_tpu_torch.parallel.train_mesh import (
        TrainMeshPlan, resolve_remat)
    from omnihuman_tpu_torch.utils.checkpoint import (
        CheckpointManager, restore_ema_into)
    from omnihuman_tpu_torch.utils.convert import load_wan_dit_checkpoint
    from omnihuman_tpu_torch.utils.logging import MetricsLogger, logger

    cfg = WAN_CONFIGS[args.task]
    apt_cfg = tr.SeaweedAPTConfig(**{k: v for k, v in (
        ("image_updates", args.image_updates),
        ("video_updates", args.video_updates),
        ("g_lr_image", args.g_lr_image), ("d_lr_image", args.d_lr_image),
        ("g_lr_video", args.g_lr_video), ("d_lr_video", args.d_lr_video),
        ("lambda_r1", args.lambda_r1), ("ema_decay", args.ema_decay))
        if v is not None})
    bsz = args.batch_size or 1
    accum = max(1, args.grad_accumulation)
    remat = resolve_remat(args.remat_group, cfg.model.num_layers)
    plan = TrainMeshPlan.from_sizes(
        args.fsdp_size, args.sp_size, args.device,
        module="omnihuman_tpu_torch.cli.train_apt")
    plan.check_batch(bsz)
    logger.info(f"training plan: {plan.describe()}")
    device = plan.device

    # the frozen backbone of every discriminator (the teacher)
    backbone = build_wan_model(cfg.model, device, torch.bfloat16, seed=0)
    if args.checkpoint_dir:
        load_wan_dit_checkpoint(backbone, args.checkpoint_dir)
    g_model = copy.deepcopy(backbone).train().requires_grad_(True)
    if args.consistency_path:
        step = restore_ema_into(g_model, args.consistency_path)
        logger.info(f"generator <- consistency EMA @ step {step} "
                    f"({args.consistency_path})")
    else:
        logger.info("no --consistency_path: generator <- teacher copy")
    plan.shard_tree(backbone)
    plan.shard_tree(g_model)

    def fresh_disc(seed_offset: int):
        return init_apt_discriminator(backbone, torch.Generator(
            device=device).manual_seed(args.seed + seed_offset))

    metrics_log = MetricsLogger(project=args.wandb_project,
                                run_name=args.wandb_run_name,
                                out_dir=args.output_dir)
    ckpt = CheckpointManager(args.output_dir)
    draws = torch.Generator().manual_seed(args.seed)
    rng = np.random.default_rng(args.seed + 1)
    history = []

    def save(step, metadata):
        t0 = time.perf_counter()
        ckpt.save(step, state, metadata=metadata)
        logger.info(f"checkpoint of step {step} saved in "
                    f"{time.perf_counter() - t0:.1f} s")

    def run_phase(data, *, phase, start_update, num_updates, step_offset):
        # step_offset keeps checkpoint numbers globally unique across the
        # handoff (start_video_phase resets state.step to 0)
        nonlocal state
        video = phase == "video"
        g_lr = apt_cfg.g_lr_video if video else apt_cfg.g_lr_image
        d_lr = apt_cfg.d_lr_video if video else apt_cfg.d_lr_image
        kw = dict(apt_cfg=apt_cfg, video=video, policy=cfg.policy, plan=plan,
                  **latent_rope(cfg.model, data["noise"].shape, device,
                                sp=plan.sp))
        g_opt = tr.make_rmsprop(g_lr, accum)
        d_opt = tr.make_d_optimizer(d_lr, state.disc, accum)
        n = data["noise"].shape[0]
        for update in range(start_update, num_updates):
            sel = rng.integers(0, n, size=bsz)
            batch = _build_batch(data, sel, rng, device)
            t0 = time.perf_counter()
            state, dm = tr.apt_d_step(state, batch, draws, d_optimizer=d_opt,
                                      **kw)
            dm = {k: float(v) for k, v in dm.items()}
            t1 = time.perf_counter()
            state, gm = tr.apt_g_step(state, batch, draws, g_optimizer=g_opt,
                                      remat=remat, **kw)
            m = {"phase": float(video), "d_loss": dm["d_loss"],
                 "r1_loss": dm["r1_loss"], "g_loss": float(gm["g_loss"])}
            history.append(dict(update=update + 1, d_seconds=t1 - t0,
                                g_seconds=time.perf_counter() - t1, **m))
            if (update + 1) % args.log_interval == 0:
                metrics_log.log(m, step=step_offset + update + 1)
                logger.info(f"[{phase}] update {update + 1}/{num_updates} "
                            f"g {m['g_loss']:.4f} d {m['d_loss']:.4f} "
                            f"r1 {m['r1_loss']:.4f}")
            if ((update + 1) % args.save_interval == 0
                    and update + 1 < num_updates):
                save(step_offset + update + 1,
                     {"phase": phase, "update": update + 1})
        save(step_offset + num_updates,
             {"phase": phase, "update": num_updates, "final": True})

    image_data = load_teacher_data(args.data_path)
    video_data = (load_teacher_data(args.video_data_path)
                  if args.video_data_path else image_data)
    state = tr.init_apt_state(g_model, fresh_disc(1), apt_cfg.g_lr_image,
                              apt_cfg.d_lr_image, accum)

    start_phase, start_update = "image", 0
    if args.resume:
        meta = ckpt.restore_metadata() or {}
        if not meta and ckpt.latest_step() is not None:
            # restarting from scratch would silently discard the checkpoint
            raise RuntimeError(
                f"--resume: checkpoint at step {ckpt.latest_step()} in "
                f"{args.output_dir} has no readable metadata; refusing to "
                "restart from scratch")
        if meta:
            # both phases' states have the same structure: restore as is
            ckpt.restore(target=state)
            start_phase = meta.get("phase", "image")
            start_update = int(meta.get("update", 0))
            if meta.get("final"):
                if start_phase == "video":
                    logger.info("training already complete")
                    metrics_log.finish()
                    return state, history
                # the image phase is done: the handoff comes next
                state = tr.start_video_phase(state, fresh_disc(2), apt_cfg,
                                             accum)
                start_phase, start_update = "video", 0
            logger.info(f"resumed: phase {start_phase} update "
                        f"{start_update}")

    if start_phase == "image":
        run_phase(image_data, phase="image", start_update=start_update,
                  num_updates=apt_cfg.image_updates, step_offset=0)
        start_update = 0
        # G <- the image-phase EMA, a fresh D on the same frozen backbone
        state = tr.start_video_phase(state, fresh_disc(2), apt_cfg, accum)
    run_phase(video_data, phase="video", start_update=start_update,
              num_updates=apt_cfg.video_updates,
              step_offset=apt_cfg.image_updates)
    metrics_log.finish()
    logger.info(f"APT training complete; final EMA in the step "
                f"{apt_cfg.image_updates + apt_cfg.video_updates} "
                f"checkpoint at {args.output_dir}")
    return state, history


if __name__ == "__main__":
    main()
