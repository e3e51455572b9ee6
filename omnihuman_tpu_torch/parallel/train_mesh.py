"""Training-mesh orchestration shared by the training CLIs (port of
omnihuman_tpu/parallel/train_mesh.py).

The JAX package builds one plan from --fsdp_size/--sp_size: a (data, fsdp,
sp) mesh, FSDP PartitionSpecs on every state leaf, batches on `data`, and
the ring attention route; with fsdp = sp = 1 the plan is a no-op. The port
keeps that shape. `TrainMeshPlan.from_sizes` joins the process group that
torchrun's environment describes (one process per GPU, NCCL; gloo with
--device cpu) and lays the mesh over it (parallel/mesh.py); with both
sizes 1 it has no mesh, and the single-GPU steps run exactly as before.
A single process asked for sizes above 1 exits with the torchrun command
it needs. On a mesh:

  - `shard_tree` applies FSDP2 to a model (parallel/partition.py): the
    parameters JAX shards live as DTensor shards on `fsdp`, the others
    whole on every rank; optimizer states and EMAs made from them follow;
  - the steps run the ring self-attention and sp_cross cross-attention on
    this rank's 1/sp of the tokens (`token_sharding`, `mesh_context`);
  - `put_batch` gives each data rank its slice of the global batch: the
    fsdp and sp ranks of one data group take the same samples (JAX's
    `P("data")`); the pose heatmaps [B, K, F, H, W] also give each sp
    rank its H / sp rows (JAX's `P("data", None, None, "sp", None)`),
    which the pose guider's convs read with halos from the neighbouring
    rows (`omni/model.py:process_pose`, parallel/spatial.py). JAX shards
    H where H % sp == 0; the port where H % (4 sp) == 0, so that both of
    the guider's stride-2 convs start every shard on an even row, and
    keeps other heights whole; the results are the same either way;
  - `grads` takes a loss's gradients the way FSDP2 supports
    (`loss.backward()`, each parameter's `.grad`) and averages every one
    over the whole mesh: FSDP2's reduce-scatter averages the sharded ones
    over fsdp and an all-reduce averages them over data and sp; the whole
    (ignored) parameters are averaged over every rank by one all-reduce.
    With the sp convention of parallel/partition.py that is the gradient
    of the global mean loss of the JAX step.

--remat_group works on the mesh: a remat segment recomputes its ring
forward, P2P included, inside the backward, and every rank walks the same
graph in the same order.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Iterable, Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from omnihuman_tpu_torch.parallel.mesh import (
    AXIS_DATA, AXIS_FSDP, AXIS_SP, mesh_from_flags, use_mesh)
from omnihuman_tpu_torch.parallel.partition import local, shard_params

REDUCE_BUCKET = 2 ** 26      # elements (fp32) of one gradient all-reduce


@dataclasses.dataclass
class TrainMeshPlan:
    """Everything a training step needs to run on a mesh; `mesh` None is
    the single-device plan."""

    mesh: Optional[object] = None
    device: Optional[torch.device] = None

    @classmethod
    def from_sizes(cls, fsdp_size: int = 1, sp_size: int = 1, device=None,
                   module: str = "omnihuman_tpu_torch.cli.train_distill"
                   ) -> "TrainMeshPlan":
        """No mesh when both sizes are 1 (on `device`, default the GPU);
        else (data -1, fsdp, sp) over torchrun's process group, joined
        here, on this rank's device. `module` names the CLI in the
        torchrun command a single process exits with."""
        from omnihuman_tpu_torch.pipelines.text2video import resolve_device
        mesh, dev = mesh_from_flags(fsdp_size, sp_size, device, module)
        return cls(mesh, resolve_device(dev))

    # -- the mesh's shape ---------------------------------------------------

    def _size(self, axis: str) -> int:
        return 1 if self.mesh is None else int(self.mesh[axis].size())

    @property
    def sp(self) -> int:
        return self._size(AXIS_SP)

    @property
    def data(self) -> int:
        return self._size(AXIS_DATA)

    @property
    def attn_impl(self) -> str:
        return "auto" if self.mesh is None else "ring"

    @property
    def token_sharding(self):
        """The 1-D sp mesh the DiT shards its tokens over, or None."""
        return None if self.mesh is None else self.mesh[AXIS_SP]

    def seq_len(self, n_tokens: int) -> int:
        """Padded token length: sp-divisible, and 1024-aligned at flagship
        lengths (JAX `:68`, `wan_dit.padded_seq_len`)."""
        from omnihuman_tpu_torch.models.wan_dit import padded_seq_len
        return padded_seq_len(n_tokens, self.sp)

    def check_batch(self, batch_size: int) -> None:
        if batch_size % self.data != 0:
            raise ValueError(
                f"batch_size {batch_size} must be divisible by the data "
                f"mesh axis ({self.data}); pass a multiple or shrink "
                "--fsdp_size/--sp_size")

    def describe(self) -> str:
        if self.mesh is None:
            return "single-device (no mesh)"
        shape = {a: self._size(a) for a in (AXIS_DATA, AXIS_FSDP, AXIS_SP)}
        return f"mesh {shape} attn=ring"

    # -- placing state and batches -------------------------------------------

    def shard_tree(self, model: torch.nn.Module,
                   min_size: Optional[int] = None) -> torch.nn.Module:
        """FSDP2 on `model`'s parameters (`shard_params`; no-op without a
        mesh). Shard a model before its optimizer state and EMA are made:
        they copy its parameters' placement."""
        if self.mesh is None:
            return model
        return shard_params(model, self.mesh, min_size=min_size)

    def put_batch(self, batch: Dict) -> Dict:
        """This data rank's slice (dim 0) of every tensor of the global
        batch, and this sp rank's rows of the pose heatmaps [B, K, F, H, W]
        where sp > 1 and H % (4 sp) == 0 (module docstring; then
        "pose_sharding" holds the sp mesh they are sharded over); the
        batch itself without a mesh."""
        if self.mesh is None:
            return batch
        out = dict(batch)
        if self.data > 1:
            rank, n = self.mesh[AXIS_DATA].get_local_rank(), self.data

            def put(x):
                if not isinstance(x, torch.Tensor):
                    return x
                b = x.shape[0] // n
                return x[rank * b:(rank + 1) * b]

            out = {k: put(v) for k, v in out.items()}
        pose = out.get("pose")
        if (isinstance(pose, torch.Tensor) and pose.dim() == 5
                and self.sp > 1 and pose.shape[3] % (4 * self.sp) == 0):
            rows = pose.shape[3] // self.sp
            r = self.mesh[AXIS_SP].get_local_rank()
            out["pose"] = pose[:, :, :, r * rows:(r + 1) * rows]
            out["pose_sharding"] = self.mesh[AXIS_SP]
        return out

    def mesh_context(self):
        """The mesh made current for the attention dispatcher."""
        if self.mesh is None:
            return contextlib.nullcontext()
        return use_mesh(self.mesh)

    # -- gradients and metrics -----------------------------------------------

    def grads(self, loss: torch.Tensor, params: Dict[str, torch.Tensor],
              allow_unused: bool = False) -> Dict[str, torch.Tensor]:
        """{name: d loss / d param}. Without a mesh, `torch.autograd.grad`
        (unused parameters get zeros with `allow_unused`). On a mesh,
        `loss.backward()`, so FSDP2's hooks reduce-scatter the sharded
        gradients; each parameter's `.grad` is taken (and cleared) and
        averaged over the mesh (module docstring). Every parameter with
        requires_grad that the loss reaches gets a `.grad`: freeze the
        others (`frozen`) before the forward."""
        if self.mesh is None:
            gs = torch.autograd.grad(loss, list(params.values()),
                                     allow_unused=allow_unused,
                                     materialize_grads=allow_unused)
            return dict(zip(params, gs))
        for p in params.values():
            p.grad = None
        loss.backward()
        grads = {}
        for n, p in params.items():
            g = p.grad
            if g is None:
                if not allow_unused:
                    raise RuntimeError(f"parameter {n} got no gradient")
                g = torch.zeros_like(p)
            grads[n] = g
            p.grad = None
        sharded = [local(g) for g in grads.values() if isinstance(g, DTensor)]
        whole = [g for g in grads.values() if not isinstance(g, DTensor)]
        groups = [self.mesh[a].get_group() for a in (AXIS_DATA, AXIS_SP)
                  if self._size(a) > 1]
        _all_reduce_mean(sharded, groups, self.data * self.sp)
        _all_reduce_mean(whole, [None], dist.get_world_size())
        return grads

    def mean_over_data(self, x: torch.Tensor) -> torch.Tensor:
        """The mean of a per-data-rank value over the data ranks (a batch
        mean of the global batch from the local ones); x without a mesh."""
        if self.data == 1:
            return x
        y = x.detach().clone()
        dist.all_reduce(y, group=self.mesh[AXIS_DATA].get_group())
        return y / self.data


NO_MESH = TrainMeshPlan()


@torch.no_grad()
def _all_reduce_mean(tensors: Iterable[torch.Tensor], groups, n: int
                     ) -> None:
    """Replace each tensor by its sum over every group in `groups` (in
    turn) divided by n: fp32 buckets of up to REDUCE_BUCKET elements."""
    tensors = [t for t in tensors if t.numel()]
    if not groups or n == 1 or not tensors:
        return
    i = 0
    while i < len(tensors):
        bucket, size = [], 0
        while i < len(tensors) and (not bucket or size + tensors[i].numel()
                                    <= REDUCE_BUCKET):
            bucket.append(tensors[i])
            size += tensors[i].numel()
            i += 1
        flat = torch.cat([t.reshape(-1).float() for t in bucket])
        for g in groups:
            dist.all_reduce(flat, group=g)
        flat /= n
        off = 0
        for t in bucket:
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()


@contextlib.contextmanager
def frozen(*modules: torch.nn.Module):
    """requires_grad off on every parameter of `modules` inside, restored
    after: a mesh step's `loss.backward()` then gives them no gradient
    (the parameters of a model the loss reads but the step does not
    train)."""
    params = [p for m in modules for p in m.parameters() if p.requires_grad]
    for p in params:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p in params:
            p.requires_grad_(True)


def add_mesh_args(parser) -> None:
    """The shared --fsdp_size/--sp_size/--remat_group CLI surface
    (reference: --ulysses_size/--ring_size, distilled_trainer.py:370-371)."""
    parser.add_argument(
        "--fsdp_size", type=int, default=1,
        help="parameter-sharding degree (fsdp mesh axis, FSDP2); sizes "
             "above 1 run under torchrun, one process per GPU")
    parser.add_argument(
        "--sp_size", type=int, default=1,
        help="sequence-parallel degree (sp mesh axis, ring attention); "
             "sizes above 1 run under torchrun, one process per GPU")
    parser.add_argument(
        "--remat_group", type=int, default=0,
        help="grouped two-level remat segment size (0 = per-block "
             "checkpointing; must divide num_layers)")


def resolve_remat(remat_group: int, num_layers: int):
    """CLI remat flag -> WanModel.forward remat arg (int group or True)."""
    if remat_group and remat_group > 1:
        if num_layers % remat_group != 0:
            raise ValueError(
                f"--remat_group {remat_group} must divide num_layers "
                f"{num_layers}")
        return int(remat_group)
    return True
