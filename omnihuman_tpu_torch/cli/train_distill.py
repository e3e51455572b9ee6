"""Consistency-distillation training CLI of the port (reference
distilled_trainer.py __main__, :351-415). A YAML `--config` fills the
flags left unset.

    python -m omnihuman_tpu_torch.cli.train_distill --task t2v-1.3B \\
        --data_path data/dummy_data_480x832.npz --output_dir ckpt/ \\
        --num_epochs 10 --batch_size 1

Runs on one GPU unless `--device cpu` is given. --fsdp_size / --sp_size
above 1 train on a (data, fsdp, sp) mesh, one process per GPU under
torchrun (parallel/train_mesh.py), e.g.

    torchrun --standalone --nproc_per_node 4 \\
        -m omnihuman_tpu_torch.cli.train_distill --fsdp_size 2 --sp_size 2 ...

(gloo processes with `--device cpu`); the batch must divide by the data
degree, rank 0 prints and writes the checkpoints. The student starts
from `--checkpoint_dir` (reference `*.safetensors`) or from
random weights made from a fixed init seed (0), in bf16 like the JAX
trainer. A checkpoint is saved every `--save_interval` steps and at the
end of every epoch. `main` returns (state, history): the final
DistillState and one {"step", "epoch", "loss", "grad_norm", "seconds"}
record per step.
"""

from __future__ import annotations

import argparse
import time

MODULE = "omnihuman_tpu_torch.cli.train_distill"


def main(argv=None):
    from omnihuman_tpu_torch.parallel.train_mesh import add_mesh_args
    p = argparse.ArgumentParser("omnihuman-tpu-torch train-distill")
    p.add_argument("--config", default=None, help="optional YAML")
    p.add_argument("--task", default="t2v-1.3B")
    p.add_argument("--checkpoint_dir", default=None)
    p.add_argument("--data_path", default="dummy_data_480x832.npz")
    p.add_argument("--output_dir", default="checkpoints/distill")
    p.add_argument("--learning_rate", type=float, default=None)
    p.add_argument("--num_epochs", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--ema_decay", type=float, default=None)
    p.add_argument("--save_interval", type=int, default=None)
    p.add_argument("--device", default=None,
                   help="torch device (default: the GPU; 'cpu' on request)")
    add_mesh_args(p)
    args = p.parse_args(argv)

    if args.config:
        from omnihuman_tpu_torch.utils.config_io import load_yaml, merge_args
        merge_args(load_yaml(args.config), args)
    lr = args.learning_rate or 5e-6
    epochs = args.num_epochs or 10
    bsz = args.batch_size or 1
    ema_decay = args.ema_decay or 0.995
    save_interval = args.save_interval or 100

    import torch

    from omnihuman_tpu_torch.apt.distill import (
        distill_train_step, init_distill_state, make_optimizer)
    from omnihuman_tpu_torch.apt.generate import (
        create_dataloader, latent_rope, load_teacher_data)
    from omnihuman_tpu_torch.configs import WAN_CONFIGS
    from omnihuman_tpu_torch.models.wan_dit import build_wan_model
    from omnihuman_tpu_torch.parallel.mesh import is_writer
    from omnihuman_tpu_torch.parallel.train_mesh import (
        TrainMeshPlan, resolve_remat)
    from omnihuman_tpu_torch.utils.checkpoint import CheckpointManager
    from omnihuman_tpu_torch.utils.convert import load_wan_dit_checkpoint

    cfg = WAN_CONFIGS[args.task]
    remat = resolve_remat(args.remat_group, cfg.model.num_layers)
    plan = TrainMeshPlan.from_sizes(args.fsdp_size, args.sp_size,
                                    args.device, module=MODULE)
    plan.check_batch(bsz)
    device = plan.device
    say = print if is_writer() else (lambda *a, **k: None)
    say(f"training plan: {plan.describe()}", flush=True)
    model = build_wan_model(cfg.model, device, torch.bfloat16, seed=0,
                            trainable=True)
    if args.checkpoint_dir:
        load_wan_dit_checkpoint(model, args.checkpoint_dir)
    plan.shard_tree(model)
    data = load_teacher_data(args.data_path)
    dl = create_dataloader(data, batch_size=bsz, device=device)

    geometry = latent_rope(cfg.model, data["noise"].shape, device,
                           sp=plan.sp)

    opt = make_optimizer(lr=lr)
    state = init_distill_state(model, opt)
    ckpt = CheckpointManager(args.output_dir)

    def save(metadata=None):
        t0 = time.perf_counter()
        ckpt.save(step, state, metadata=metadata)
        say(f"checkpoint of step {step} saved in "
            f"{time.perf_counter() - t0:.1f} s", flush=True)

    history = []
    step = 0
    for epoch in range(epochs):
        for batch in dl():
            t0 = time.perf_counter()
            state, m = distill_train_step(
                state, plan.put_batch(batch), optimizer=opt,
                policy=cfg.policy, ema_decay=ema_decay, remat=remat,
                plan=plan, **geometry)
            loss, g_norm = float(m["loss"]), float(m["grad_norm"])
            step += 1
            history.append(dict(step=step, epoch=epoch, loss=loss,
                                grad_norm=g_norm,
                                seconds=time.perf_counter() - t0))
            if step % 5 == 0:
                say(f"epoch {epoch} step {step} loss {loss:.5f} "
                      f"grad_norm {g_norm:.4g}", flush=True)
            if step % save_interval == 0:
                save()
        save(metadata={"epoch": epoch})
    ckpt.wait()
    say(f"done: {step} steps", flush=True)
    return state, history


if __name__ == "__main__":
    main()
