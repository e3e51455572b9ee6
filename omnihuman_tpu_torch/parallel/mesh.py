"""The (data, fsdp, sp) device mesh over torch.distributed (port of
omnihuman_tpu/parallel/mesh.py).

    data : batch / gradient data parallelism (the reference's DDP)
    fsdp : parameter sharding (FSDP2 `fully_shard`, parallel/partition.py)
    sp   : sequence parallelism over the token axis (ops/ring_attention.py)

The JAX package is single-controller: one process drives every device and
GSPMD inserts the collectives. The port runs one process per GPU (torchrun
starts them); `create_mesh` lays a `DeviceMesh` over the process group the
caller has joined, `sp` innermost so that the ring's neighbours are
adjacent ranks, and the model code issues its collectives itself (NCCL on
the card, gloo on the CPU).
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

AXIS_DATA = "data"
AXIS_FSDP = "fsdp"
AXIS_SP = "sp"
MESH_AXES = (AXIS_DATA, AXIS_FSDP, AXIS_SP)


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Degrees for each mesh axis; -1 on `data` means 'absorb the rest'."""

    data: int = -1
    fsdp: int = 1
    sp: int = 1

    def resolve(self, n_devices: int) -> "MeshConfig":
        data = self.data
        if data == -1:
            denom = self.fsdp * self.sp
            if n_devices % denom != 0:
                raise ValueError(
                    f"{n_devices} devices not divisible by fsdp*sp={denom}")
            data = n_devices // denom
        if data * self.fsdp * self.sp != n_devices:
            raise ValueError(
                f"mesh {data}x{self.fsdp}x{self.sp} != {n_devices} devices")
        return MeshConfig(data, self.fsdp, self.sp)


def _device_type() -> str:
    """The mesh's device type: cuda under NCCL, else cpu (gloo)."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def create_mesh(config: MeshConfig = MeshConfig(),
                device_type: Optional[str] = None):
    """The (data, fsdp, sp) `DeviceMesh` over the process group already
    joined, one rank per device, `sp` innermost."""
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("create_mesh needs a process group: call "
                           "init_distributed() (or torchrun's env) first")
    cfg = config.resolve(dist.get_world_size())
    return init_device_mesh(device_type or _device_type(),
                            (cfg.data, cfg.fsdp, cfg.sp),
                            mesh_dim_names=MESH_AXES)


def local_mesh():
    """The mesh with every rank on `data` (JAX: everything on `data`).
    Nothing in the port calls it; it keeps JAX's `parallel` API whole."""
    return create_mesh(MeshConfig())


def init_distributed(device: Optional[str] = None) -> torch.device:
    """Join the process group that torchrun's environment describes
    (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR / MASTER_PORT): NCCL with
    the GPU of LOCAL_RANK, or gloo when `device` is "cpu". Returns this
    rank's device. A second call returns the same device."""
    cpu = device is not None and torch.device(device).type == "cpu"
    local = int(os.environ.get("LOCAL_RANK", "0"))
    if not dist.is_initialized():
        if cpu:
            dist.init_process_group(
                "gloo", timeout=datetime.timedelta(minutes=30))
        else:
            torch.cuda.set_device(local)
            dist.init_process_group(
                "nccl", device_id=torch.device("cuda", local),
                timeout=datetime.timedelta(minutes=30))
    return torch.device("cpu") if cpu else torch.device("cuda", local)


# ---------------------------------------------------------------------------
# the current mesh: the DiT and the attention dispatcher take the forward's
# sequence-parallel plan from it, so no caller threads the plan through

_CURRENT_MESH: list = []       # (mesh, self-attention route) of each use_mesh
SP_ROUTE = "ring"              # the self-attention's route on program paths


@contextlib.contextmanager
def use_mesh(mesh, sp_route: str = SP_ROUTE):
    """`mesh` is the current mesh inside; None means none (the attention
    dispatcher's single-device routes), so a caller passes its optional
    mesh through unchanged. `sp_route`: the DiT self-attention's route on
    the mesh (`flash_attention`'s implementation): the ring on every
    program path, Ulysses where a caller asks for it."""
    if sp_route not in (SP_ROUTE, "ulysses"):
        raise ValueError(f"unknown sequence-parallel route {sp_route!r}")
    _CURRENT_MESH.append((mesh, sp_route))
    try:
        yield mesh
    finally:
        _CURRENT_MESH.pop()


def current_mesh():
    return _CURRENT_MESH[-1][0] if _CURRENT_MESH else None


def self_attention_route() -> str:
    """The DiT self-attention's `flash_attention` implementation: the
    route the current mesh was made current with, "auto" (the
    single-device route) with no mesh current."""
    if current_mesh() is None:
        return "auto"
    return _CURRENT_MESH[-1][1]


def sp_degree(mesh) -> int:
    """The sp degree of an optional mesh, 1 without one: token lengths
    are padded to a multiple of it."""
    return 1 if mesh is None else int(mesh[AXIS_SP].size())


def mesh_from_flags(fsdp_size: int, sp_size: int, device=None,
                    module: str = "omnihuman_tpu_torch.cli.generate"):
    """The serving CLIs' mesh (JAX cli/generate.py:145-149): None when both
    sizes are 1; else (data -1, fsdp, sp) over the process group of
    torchrun's environment, joined here if needed. Returns (mesh, device).
    A single process asked for sizes above 1 exits with the torchrun
    command that starts enough."""
    if fsdp_size < 1 or sp_size < 1:
        raise SystemExit(f"--fsdp_size {fsdp_size} / --sp_size {sp_size}: "
                         "sizes are at least 1")
    if fsdp_size == 1 and sp_size == 1:
        return None, device
    need = fsdp_size * sp_size
    world = (dist.get_world_size() if dist.is_initialized()
             else int(os.environ.get("WORLD_SIZE", "1")))
    if world % need:
        raise SystemExit(
            f"--fsdp_size {fsdp_size} --sp_size {sp_size} need a world size "
            f"that is a multiple of {need}, one process per GPU; this run "
            f"has {world}: start it as `torchrun --nproc_per_node {need} "
            f"-m {module} ...`")
    dev = init_distributed(device)
    return create_mesh(MeshConfig(data=-1, fsdp=fsdp_size, sp=sp_size)), dev


def is_writer() -> bool:
    """True on the rank that writes a run's files: rank 0, or the only
    process."""
    return not dist.is_initialized() or dist.get_rank() == 0
