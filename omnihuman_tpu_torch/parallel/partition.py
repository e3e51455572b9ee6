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

from torch import nn

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
    model, changed in place."""
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
                ignored_params=ignored)
    return model


# ---------------------------------------------------------------------------
# the token axis over `sp` (JAX annotates it with `with_sharding_constraint`
# and GSPMD slices and gathers; here each rank keeps its own rows)

def shard_tokens(x, sp_mesh, dim: int = 1):
    """This rank's contiguous 1/sp of `x` along `dim` (rank-major, as
    `NamedSharding(mesh, P(None, "sp"))` lays tokens out). `sp_mesh` is
    the 1-D `mesh["sp"]`; None or size 1 returns x."""
    if sp_mesh is None or sp_mesh.size() == 1:
        return x
    sp, rank = sp_mesh.size(), sp_mesh.get_local_rank()
    n = x.shape[dim]
    if n % sp:
        raise ValueError(f"{n} tokens do not shard over sp={sp}")
    return x.narrow(dim, rank * (n // sp), n // sp)


def gather_tokens(x, sp_mesh, dim: int = 1):
    """The inverse of `shard_tokens`: every rank's rows of `x` along `dim`,
    in rank order, by one `all_gather_into_tensor` over the sp group."""
    import torch
    import torch.distributed as dist
    if sp_mesh is None or sp_mesh.size() == 1:
        return x
    sp = sp_mesh.size()
    xt = x.movedim(dim, 0).contiguous()
    out = xt.new_empty((sp * xt.shape[0],) + tuple(xt.shape[1:]))
    # all_gather_single is the newer torch's name of all_gather_into_tensor
    gather = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    gather(out, xt, group=sp_mesh.get_group())
    return torch.movedim(out, 0, dim)
