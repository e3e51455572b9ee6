"""The training CLIs' shared mesh flags (port of
omnihuman_tpu/parallel/train_mesh.py, single-GPU part).

The JAX package builds a (data, fsdp, sp) mesh from --fsdp_size/--sp_size.
The port trains on one GPU: both sizes must be 1, and anything else is
refused with the slice that brings the ring backward and FSDP2 to the
trainers (ROADMAP queue A, item 19); serving runs on the mesh already
(parallel/mesh.py). --remat_group works as in JAX.
"""

from __future__ import annotations

MULTI_GPU_SLICE = ("multi-GPU training (FSDP and sequence parallelism) comes "
                   "with ROADMAP queue A, item 19")


def add_mesh_args(parser) -> None:
    """The shared --fsdp_size/--sp_size/--remat_group CLI surface
    (reference: --ulysses_size/--ring_size, distilled_trainer.py:370-371)."""
    parser.add_argument(
        "--fsdp_size", type=int, default=1,
        help="parameter-sharding degree (the training CLIs take only 1 so "
             "far; serving runs it under torchrun)")
    parser.add_argument(
        "--sp_size", type=int, default=1,
        help="sequence-parallel degree (the training CLIs take only 1 so "
             "far; serving runs it under torchrun)")
    parser.add_argument(
        "--remat_group", type=int, default=0,
        help="grouped two-level remat segment size (0 = per-block "
             "checkpointing; must divide num_layers)")


def check_single_device(fsdp_size: int, sp_size: int) -> None:
    """Raise unless the flags ask for one device."""
    for name, size in (("--fsdp_size", fsdp_size), ("--sp_size", sp_size)):
        if size != 1:
            raise ValueError(f"{name} {size}: {MULTI_GPU_SLICE}")


def resolve_remat(remat_group: int, num_layers: int):
    """CLI remat flag -> WanModel.forward remat arg (int group or True)."""
    if remat_group and remat_group > 1:
        if num_layers % remat_group != 0:
            raise ValueError(
                f"--remat_group {remat_group} must divide num_layers "
                f"{num_layers}")
        return int(remat_group)
    return True
