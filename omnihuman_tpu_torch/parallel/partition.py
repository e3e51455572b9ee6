"""Parameter sharding over the `fsdp` mesh axis with FSDP2 (port of
omnihuman_tpu/parallel/partition.py).

The JAX package gives every parameter leaf a PartitionSpec by its shape:
leaves of MIN_SHARD_SIZE elements or more shard their largest dimension
that the axis size divides, ties to the last dimension; the others stay
replicated. `infer_param_specs` evaluates that rule on each port
parameter in the JAX package's layout: a torch Linear weight is [out, in]
where JAX's is [in, out], a Conv3d weight [O, I, kt, kh, kw] where JAX's
is [kt, kh, kw, I, O], the DiT's patch embedding a [I*kt*kh*kw, O] linear
there, and a module list named `blocks` one stacked leaf there (the layer
axis in front). The result names, for each port parameter, the dimension
JAX shards, or None where JAX replicates the leaf or shards a dimension
the port's per-layer tensor does not have (the layer axis, a merged one).

`shard_params` applies FSDP2's `fully_shard` to every block of every
`blocks` list and then to the root, over `mesh["fsdp"]`, each parameter
sharded on that dimension (`shard_placement_fn`); the parameters JAX
replicates are left out of FSDP (`ignored_params`) and stay whole on every
rank. FSDP2 gathers a block's parameters when the block's `__call__` runs
and frees them after it, so the model code calls its blocks as modules.
The buffers (Int8Linear's int8 weights) are not sharded.
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor, distribute_tensor

from omnihuman_tpu_torch.parallel.mesh import AXIS_FSDP

MIN_SHARD_SIZE = 2 ** 16
_BLOCK = re.compile(r"(^|\.)blocks\.(\d+)\.")


def _jax_view(module: nn.Module, mname: str, pname: str,
              shape) -> Tuple[tuple, tuple]:
    """(shape in the JAX layout, port dimension of each JAX dimension or
    None) of parameter `pname` of `module` (named `mname`)."""
    if pname == "weight" and isinstance(module, nn.Linear):
        return (shape[1], shape[0]), (1, 0)
    if pname == "weight" and isinstance(module, nn.Conv3d):
        if mname.split(".")[-1] == "patch_embedding":
            rest = 1
            for s in shape[1:]:
                rest *= s
            return (rest, shape[0]), (None, 0)
        return tuple(shape[i] for i in (2, 3, 4, 1, 0)), (2, 3, 4, 1, 0)
    if pname == "weight" and isinstance(module, nn.Conv2d):
        return tuple(shape[i] for i in (2, 3, 1, 0)), (2, 3, 1, 0)
    return tuple(shape), tuple(range(len(shape)))


def _num_blocks(model: nn.Module, name: str) -> int:
    """Length of the `blocks` list that parameter `name` lives in."""
    m = _BLOCK.search(name)
    prefix = name[:m.start()] + ("." if m.group(1) else "")
    return len(model.get_submodule(prefix + "blocks"))


def infer_param_specs(model: nn.Module, min_size: Optional[int] = None,
                      axis_size: Optional[int] = None
                      ) -> Dict[str, Optional[int]]:
    """{parameter name: dimension to shard on `fsdp`, or None} by the JAX
    shape rule in the JAX layout (module docstring); `min_size` defaults
    to MIN_SHARD_SIZE. Without `axis_size` the divisibility check is
    skipped, as in JAX."""
    if min_size is None:
        min_size = MIN_SHARD_SIZE
    specs: Dict[str, Optional[int]] = {}
    for mname, module in model.named_modules():
        for pname, p in module.named_parameters(recurse=False):
            name = f"{mname}.{pname}" if mname else pname
            shape, port_dim = _jax_view(module, mname, pname,
                                        tuple(p.shape))
            if _BLOCK.search(name):        # one stacked leaf in JAX
                shape = (_num_blocks(model, name),) + shape
                port_dim = (None,) + port_dim
            size = 1
            for s in shape:
                size *= s
            cands = [i for i in range(len(shape))
                     if axis_size is None or shape[i] % axis_size == 0]
            if not shape or size < min_size or not cands:
                specs[name] = None
                continue
            best = max(cands, key=lambda i: (shape[i], i))
            specs[name] = port_dim[best]
    return specs


def shard_params(model: nn.Module, mesh,
                 min_size: Optional[int] = None) -> nn.Module:
    """FSDP2 over `mesh["fsdp"]`: `fully_shard` on each block of every
    `blocks` list, then on the root, each parameter on its
    `infer_param_specs(min_size=)` dimension at the axis size. Returns the
    model, changed in place.

    The root reshards after every forward too (FSDP2 keeps a root's
    parameters gathered after a forward by default, and while they are,
    `named_parameters()` gives the gathered copies): between calls the
    module holds its shards, so what an optimizer updates after forwards
    that ran without a backward is the shards."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard
    fsdp = mesh[AXIS_FSDP]
    specs = infer_param_specs(model, min_size=min_size,
                              axis_size=fsdp.size())
    by_param = {p: specs.get(n) for n, p in model.named_parameters()}
    ignored = {p for p, d in by_param.items() if d is None}

    def placement(p):
        return Shard(by_param[p])

    for mname, module in model.named_modules():
        if mname.split(".")[-1] == "blocks" and isinstance(module,
                                                           nn.ModuleList):
            for blk in module:
                fully_shard(blk, mesh=fsdp, shard_placement_fn=placement,
                            ignored_params=ignored)
    fully_shard(model, mesh=fsdp, shard_placement_fn=placement,
                ignored_params=ignored, reshard_after_forward=True)
    return model


# ---------------------------------------------------------------------------
# the token axis over `sp` (JAX annotates it with `with_sharding_constraint`
# and GSPMD slices and gathers; here each rank keeps its own rows)
#
# The gradient convention of the mesh: every rank of an sp group computes
# the same loss from the gathered outputs, and the gather's backward SUMS
# the ranks' gradients of its output (a reduce-scatter), so each rank's
# gradient of a token shard, and the sum over the ranks of their
# gradients of a replicated tensor (a parameter), is sp times the true
# one. The training step then AVERAGES every parameter's gradient over
# sp (and over data and fsdp, parallel/train_mesh.py). That holds for
# parameters used before the gather (the blocks), after it (the APT
# probes read gathered taps) and on both sides of a second shard / gather
# pair (APT's G step feeds the gathered sample into the discriminator).

def shard_tokens(x, sp_mesh, dim: int = 1):
    """This rank's contiguous 1/sp of `x` along `dim` (rank-major, as
    `NamedSharding(mesh, P(None, "sp"))` lays tokens out). `sp_mesh` is
    the 1-D `mesh["sp"]`; None or size 1 returns x. A slice, so its
    backward puts the gradient in this rank's rows and zeros elsewhere."""
    if sp_mesh is None or sp_mesh.size() == 1:
        return x
    sp, rank = sp_mesh.size(), sp_mesh.get_local_rank()
    n = x.shape[dim]
    if n % sp:
        raise ValueError(f"{n} tokens do not shard over sp={sp}")
    return x.narrow(dim, rank * (n // sp), n // sp)


def gather_tokens(x, sp_mesh, dim: int = 1):
    """The inverse of `shard_tokens`: every rank's rows of `x` along `dim`,
    in rank order, by one all-gather over the sp group; its backward
    reduce-scatters (sums) the gradient (`_GatherTokens`)."""
    if sp_mesh is None or sp_mesh.size() == 1:
        return x
    return _GatherTokens.apply(x, sp_mesh.get_group(), dim)


class _GatherTokens(torch.autograd.Function):
    """all-gather along `dim` over `group`; backward: the sum over the
    ranks of the output's gradient, this rank's rows of it."""

    @staticmethod
    def forward(ctx, x, group, dim: int):
        ctx.group, ctx.dim = group, dim
        xt = x.movedim(dim, 0).contiguous()
        out = xt.new_empty((dist.get_world_size(group) * xt.shape[0],)
                           + tuple(xt.shape[1:]))
        dist.all_gather_into_tensor(out, xt, group=group)
        return out.movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        gt = g.movedim(ctx.dim, 0).contiguous()
        out = gt.new_empty((gt.shape[0] // dist.get_world_size(ctx.group),)
                           + tuple(gt.shape[1:]))
        dist.reduce_scatter_tensor(out, gt, group=ctx.group)
        return out.movedim(0, ctx.dim), None, None


# ---------------------------------------------------------------------------
# whole tensors and FSDP2's shards (DTensor parameters, their gradients and
# the optimizer states made like them)

def local(t: torch.Tensor) -> torch.Tensor:
    """This rank's shard of a DTensor (the storage itself), or t."""
    return t.to_local() if isinstance(t, DTensor) else t


def full(t: torch.Tensor) -> torch.Tensor:
    """The whole tensor of a DTensor (an all-gather: every rank of its mesh
    must call it), or t."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def place_like(saved, live):
    """A checkpoint's tree (dicts of whole tensors and values) laid out as
    the live state `live`: a tensor whose live counterpart is a DTensor
    becomes that DTensor's placement of it (each rank keeps its own
    slice, no collective), any other moves to the live tensor's device;
    values are kept."""
    if isinstance(saved, torch.Tensor):
        if isinstance(live, DTensor):
            return distribute_tensor(saved.to(live.device), live.device_mesh,
                                     live.placements, src_data_rank=None)
        return saved.to(live.device)
    if isinstance(saved, dict):
        return {k: place_like(v, live[k]) for k, v in saved.items()}
    return saved


@torch.no_grad()
def copy_whole_into(dst: torch.Tensor, src: torch.Tensor) -> None:
    """dst <- the whole tensor src (cast to dst's dtype): a DTensor dst
    takes its own slice."""
    if isinstance(dst, DTensor):
        dst.to_local().copy_(place_like(src, dst).to_local())
    else:
        dst.copy_(src)
