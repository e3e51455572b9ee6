"""f-divergence one-step distillation CLI of the port (reference
f_distilled_trainer.py __main__, :353-444; JAX cli/train_f_distill.py).
A YAML `--config` fills the flags left unset.

    python -m omnihuman_tpu_torch.cli.train_f_distill --task t2v-1.3B \\
        --checkpoint_dir Wan2.1-T2V-1.3B/ --data_path dummy_data_480x832.npz \\
        --output_dir ckpt/ --num_epochs 10 --f_divergence jensen-shannon

Runs on one GPU unless `--device cpu` is given; --fsdp_size / --sp_size
above 1 train on a (data, fsdp, sp) mesh under torchrun, as
`cli.train_distill` does (the teacher and the student sharded by FSDP2,
the teacher's CFG on the mesh's serving path). The teacher (frozen) and
the student (its copy) start from `--checkpoint_dir`'s `*.safetensors` or
from random weights made from a fixed init seed (0), in bf16 like the JAX
trainer; both stay resident, and each step computes the teacher's CFG
velocity live (`apt/f_distill.py`). The student trains with AdamW(lr, wd
0.01), the MLP discriminator on `feat_dim = min(512, latent size)`
velocity features with Adam(--discriminator_lr). A checkpoint is saved
every `--save_interval` steps and at the end of every epoch where that is
not already a save; `--resume` restarts from the latest one, mid-epoch
too. Metrics go to `MetricsLogger` at the run's first step and every 5
steps. `main` returns (state, history): the final FDistillState and one
{"step", "epoch", "seconds", metrics...} record per step.
"""

from __future__ import annotations

import argparse
import time


def _bool(s: str) -> bool:
    """JAX's parse: anything but 'false' is true."""
    return s.lower() != "false"


def main(argv=None):
    from omnihuman_tpu_torch.apt.f_distill import F_DIVERGENCES
    from omnihuman_tpu_torch.parallel.train_mesh import add_mesh_args
    p = argparse.ArgumentParser("omnihuman-tpu-torch train-f-distill")
    p.add_argument("--config", default=None, help="optional YAML")
    p.add_argument("--task", default="t2v-1.3B")
    p.add_argument("--checkpoint_dir", default=None,
                   help="Wan weights for the teacher (*.safetensors; "
                        "None = random init)")
    p.add_argument("--data_path", default="dummy_data_480x832.npz")
    p.add_argument("--output_dir", default="checkpoints/f_distill")
    p.add_argument("--num_epochs", type=int, default=10)
    p.add_argument("--learning_rate", type=float, default=1e-5)
    p.add_argument("--discriminator_lr", type=float, default=1e-5)
    p.add_argument("--cfg_scale", type=float, default=7.5)
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--save_interval", type=int, default=10)
    p.add_argument("--f_divergence", default="jensen-shannon",
                   choices=F_DIVERGENCES)
    p.add_argument("--use_discriminator", type=_bool, default=True)
    p.add_argument("--alpha", type=float, default=0.1,
                   help="GAN loss weight")
    p.add_argument("--beta", type=float, default=0.9,
                   help="f-divergence loss weight")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--wandb_project", default="wan-f-distillation")
    p.add_argument("--wandb_run_name", default=None)
    p.add_argument("--device", default=None,
                   help="torch device (default: the GPU; 'cpu' on request)")
    add_mesh_args(p)
    args = p.parse_args(argv)

    if args.config:
        from omnihuman_tpu_torch.utils.config_io import load_yaml, merge_args
        merge_args(load_yaml(args.config), args)

    import copy
    import functools

    import numpy as np
    import torch

    from omnihuman_tpu_torch.apt import f_distill as fd
    from omnihuman_tpu_torch.apt.generate import (
        create_dataloader, latent_rope, load_teacher_data)
    from omnihuman_tpu_torch.configs import WAN_CONFIGS
    from omnihuman_tpu_torch.models.wan_dit import build_wan_model
    from omnihuman_tpu_torch.parallel.train_mesh import (
        TrainMeshPlan, resolve_remat)
    from omnihuman_tpu_torch.utils.checkpoint import CheckpointManager
    from omnihuman_tpu_torch.utils.convert import load_wan_dit_checkpoint
    from omnihuman_tpu_torch.utils.logging import MetricsLogger, logger

    cfg = WAN_CONFIGS[args.task]
    remat = resolve_remat(args.remat_group, cfg.model.num_layers)
    plan = TrainMeshPlan.from_sizes(
        args.fsdp_size, args.sp_size, args.device,
        module="omnihuman_tpu_torch.cli.train_f_distill")
    plan.check_batch(args.batch_size)
    logger.info(f"training plan: {plan.describe()}")
    device = plan.device
    teacher = build_wan_model(cfg.model, device, torch.bfloat16, seed=0)
    if args.checkpoint_dir:
        load_wan_dit_checkpoint(teacher, args.checkpoint_dir)
    student = copy.deepcopy(teacher).train().requires_grad_(True)
    plan.shard_tree(teacher)
    plan.shard_tree(student)

    data = load_teacher_data(args.data_path)
    bsz = args.batch_size
    neg_ctx = torch.from_numpy(data["negative_context"]).to(device)

    opt = fd.make_student_optimizer(args.learning_rate)
    d_opt = fd.make_d_optimizer(args.discriminator_lr)
    # the reference's fixed 512-element slice, clamped for small latents
    feat_dim = min(512, int(np.prod(data["noise"].shape[1:])))
    disc = fd.init_mlp_discriminator(
        feat_dim, device, torch.Generator(device=device).manual_seed(
            args.seed))
    state = fd.init_f_distill_state(student, disc, opt, d_opt)

    ckpt = CheckpointManager(args.output_dir)
    start_step = 0
    if args.resume and ckpt.restore(target=state) is not None:
        start_step = state.step
        logger.info(f"resumed at step {start_step}")
    metrics_log = MetricsLogger(project=args.wandb_project,
                                run_name=args.wandb_run_name,
                                out_dir=args.output_dir)

    def save(metadata):
        t0 = time.perf_counter()
        ckpt.save(step, state, metadata=metadata)
        logger.info(f"checkpoint of step {step} saved in "
                    f"{time.perf_counter() - t0:.1f} s")

    step_kw = dict(
        optimizer=opt, d_optimizer=d_opt, policy=cfg.policy,
        f_divergence=args.f_divergence,
        cfg_scale=args.cfg_scale, alpha=args.alpha, beta=args.beta,
        use_discriminator=args.use_discriminator,
        t_max=float(cfg.num_train_timesteps),
        feature_fn=functools.partial(fd.default_feature_fn, dim=feat_dim),
        remat=remat, plan=plan,
        **latent_rope(cfg.model, data["noise"].shape, device, sp=plan.sp))

    history = []
    step = start_step
    steps_per_epoch = max(1, data["noise"].shape[0] // bsz)
    start_epoch = start_step // steps_per_epoch
    # mid-epoch resume: replay the interrupted epoch's shuffle and skip the
    # batches it already took, so the run ends where an uninterrupted one
    # does and no sample is trained twice in the epoch
    skip_in_epoch = start_step - start_epoch * steps_per_epoch
    dl = create_dataloader(data, batch_size=bsz, seed=args.seed,
                           skip_epochs=start_epoch, device=device)
    for epoch in range(start_epoch, args.num_epochs):
        for i, batch in enumerate(dl()):
            if epoch == start_epoch and i < skip_in_epoch:
                continue
            t0 = time.perf_counter()
            b = batch["noise"].shape[0]
            batch = plan.put_batch({
                "noise": batch["noise"], "context": batch["context"],
                "context_null": neg_ctx[None].expand(b, -1, -1)})
            state, m = fd.f_distill_train_step(state, teacher, batch,
                                               **step_kw)
            rec = {k: float(v) for k, v in m.items()}
            step += 1
            history.append(dict(step=step, epoch=epoch,
                                seconds=time.perf_counter() - t0, **rec))
            if step % 5 == 0 or step == start_step + 1:
                metrics_log.log(rec, step=step)
                logger.info(
                    f"epoch {epoch} step {step} loss {rec['loss']:.5f} "
                    f"f_div {rec['f_div_loss']:.5f} d {rec['d_loss']:.5f} "
                    f"ratio {rec['density_ratio_mean']:.3f}")
            if step % args.save_interval == 0:
                save({"epoch": epoch})
        if step % args.save_interval != 0:
            save({"epoch": epoch, "final": epoch == args.num_epochs - 1})
    metrics_log.finish()
    logger.info(f"f-distill complete: {step} steps -> {args.output_dir}")
    return state, history


if __name__ == "__main__":
    main()
