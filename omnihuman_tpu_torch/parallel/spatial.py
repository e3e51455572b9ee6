"""Spatial sharding with explicit halo exchanges (the port's counterpart of
what GSPMD does for the JAX package's `spatial_sharding`,
omnihuman_tpu/models/vae.py:640-662,705-747, and of the pose heatmaps' H
sharding, omnihuman_tpu/parallel/train_mesh.py:89-112).

JAX annotates an activation as sharded along an image axis and GSPMD
partitions every conv over it, fetching each shard's neighbour columns
(its halo) itself. The port runs one program per rank, so the program
fetches them:

  - `shard_bounds(width, parts)`: the columns of each shard, split as
    `torch.tensor_split` splits them (uneven shards allowed, the first
    ones one wider);
  - `halo_exchange(x, dim, lo, hi, group)`: x with `lo` slices of the left
    neighbour in front and `hi` slices of the right neighbour behind along
    `dim`; past the image's edge the slices are zeros. Its backward sends
    each halo's gradient back to the rank that owns those slices, where it
    is added;
  - `gather_spatial(x, dim, group, sizes)`: every rank's shard along `dim`
    in rank order (an all-gather; uneven shards padded to the widest for
    the collective). Its backward is the reduce-scatter (sum) of the
    gradient, as `parallel/partition.py:gather_tokens`'s: the sp
    convention of the training mesh, where every rank's loss reads the
    whole gathered tensor.

`group` is a torch.distributed process group (one process per GPU, NCCL;
gloo on the CPU), a 1-D `DeviceMesh`, or a rank of `VirtualRanks`: R
ranks' programs run in lockstep in one process, one thread each, their
halos cut from the neighbours' tensors. On virtual ranks the whole
computation is one autograd graph (a halo is a slice of the neighbour's
own tensor), so a backward through it gives the true gradients. With
`record=True` every rank's received halos and gathers are kept, and
`VirtualRanks.replay(r)` gives a group that hands rank r's back without
waiting for anyone: rank r's program then runs alone, and its time is
its own work apart from the collectives.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


def shard_bounds(width: int, parts: int) -> List[Tuple[int, int]]:
    """[(start, stop)] of each of `parts` shards of `width` slices, in
    rank order: the first width % parts shards one slice wider
    (`torch.tensor_split`)."""
    if parts < 1 or width < parts:
        raise ValueError(f"{width} slices do not split into {parts} shards")
    base, extra = divmod(width, parts)
    out, start = [], 0
    for r in range(parts):
        stop = start + base + (1 if r < extra else 0)
        out.append((start, stop))
        start = stop
    return out


def _buffer_like(x: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """An empty tensor of x's shape with `n` slices along `dim`, in x's
    dtype, device and memory format (channels_last_3d where x is
    channels-last: the VAE's kernels read only that layout)."""
    shape = list(x.shape)
    shape[dim] = n
    fmt = torch.contiguous_format
    if x.dim() == 5 and x.stride(1) == 1 and x.shape[1] > 1:
        fmt = torch.channels_last_3d
    return torch.empty(shape, dtype=x.dtype, device=x.device,
                       memory_format=fmt)


def _assemble(x: torch.Tensor, dim: int, left, right, lo: int,
              hi: int) -> torch.Tensor:
    """[left | x | right] along `dim` in a fresh buffer of x's layout; a
    missing side is zeros. Differentiable (the copies record)."""
    w = x.shape[dim]
    out = _buffer_like(x, dim, lo + w + hi)
    out.narrow(dim, lo, w).copy_(x)
    for start, n, part in ((0, lo, left), (lo + w, hi, right)):
        if n == 0:
            continue
        if part is None:
            out.narrow(dim, start, n).zero_()
        else:
            out.narrow(dim, start, n).copy_(part)
    return out


# ---------------------------------------------------------------------------
# process groups


def _group_of(group):
    """(process group or None for the default one) of a DeviceMesh or a
    group."""
    from torch.distributed.device_mesh import DeviceMesh
    if isinstance(group, DeviceMesh):
        if group.ndim != 1:
            raise ValueError("a spatial group is one mesh dimension")
        return group.get_group()
    return group


def group_size(group) -> int:
    if isinstance(group, (VirtualRank, ReplayRank)):
        return group.size
    return dist.get_world_size(_group_of(group))


def group_rank(group) -> int:
    if isinstance(group, (VirtualRank, ReplayRank)):
        return group.rank
    return dist.get_rank(_group_of(group))


def _gather_dim0(t: torch.Tensor, group) -> torch.Tensor:
    """all_gather_into_tensor of a contiguous tensor: [R * n, ...]."""
    out = t.new_empty((dist.get_world_size(group) * t.shape[0],)
                      + tuple(t.shape[1:]))
    dist.all_gather_into_tensor(out, t, group=group)
    return out


class _Halo(torch.autograd.Function):
    """Every rank sends its first `hi` and last `lo` slices along `dim` in
    one all-gather; each takes its neighbours'. Backward: the halos'
    gradients travel back the same way and are added to the owners'
    edge slices."""

    @staticmethod
    def forward(ctx, x, dim: int, lo: int, hi: int, group):
        ctx.dim, ctx.lo, ctx.hi, ctx.group = dim, lo, hi, group
        r, n = dist.get_rank(group), dist.get_world_size(group)
        w = x.shape[dim]
        edges = torch.cat([x.narrow(dim, 0, hi), x.narrow(dim, w - lo, lo)],
                          dim).movedim(dim, 0).contiguous()
        every = _gather_dim0(edges, group).movedim(0, dim)
        span = hi + lo
        left = (every.narrow(dim, (r - 1) * span + hi, lo)
                if r > 0 else None)
        right = (every.narrow(dim, (r + 1) * span, hi)
                 if r < n - 1 else None)
        return _assemble(x, dim, left, right, lo, hi)

    @staticmethod
    def backward(ctx, g):
        dim, lo, hi, group = ctx.dim, ctx.lo, ctx.hi, ctx.group
        r, n = dist.get_rank(group), dist.get_world_size(group)
        w = g.shape[dim] - lo - hi
        back = torch.cat([g.narrow(dim, 0, lo), g.narrow(dim, lo + w, hi)],
                         dim).movedim(dim, 0).contiguous()
        every = _gather_dim0(back, group).movedim(0, dim)
        span = lo + hi
        gx = g.narrow(dim, lo, w).clone()
        if r < n - 1 and lo:      # the right neighbour's halo of my tail
            gx.narrow(dim, w - lo, lo).add_(
                every.narrow(dim, (r + 1) * span, lo))
        if r > 0 and hi:          # the left neighbour's halo of my head
            gx.narrow(dim, 0, hi).add_(
                every.narrow(dim, (r - 1) * span + lo, hi))
        return gx, None, None, None, None


class _Gather(torch.autograd.Function):
    """all-gather along `dim` of shards of `sizes` slices (padded to the
    widest for the collective); backward: the reduce-scatter (sum) of the
    gradient."""

    @staticmethod
    def forward(ctx, x, dim: int, group, sizes: Tuple[int, ...]):
        ctx.dim, ctx.group, ctx.sizes = dim, group, sizes
        wide = max(sizes)
        xt = x.movedim(dim, 0)
        if xt.shape[0] < wide:
            xt = torch.cat([xt, xt.new_zeros((wide - xt.shape[0],)
                                             + tuple(xt.shape[1:]))])
        every = _gather_dim0(xt.contiguous(), group)
        parts = [every[i * wide:i * wide + s] for i, s in enumerate(sizes)]
        return torch.cat(parts).movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        dim, group, sizes = ctx.dim, ctx.group, ctx.sizes
        r = dist.get_rank(group)
        gt = g.movedim(dim, 0)
        starts = [sum(sizes[:i]) for i in range(len(sizes))]
        wide = max(sizes)
        padded = gt.new_zeros((len(sizes) * wide,) + tuple(gt.shape[1:]))
        for i, (s, n) in enumerate(zip(starts, sizes)):
            padded[i * wide:i * wide + n] = gt[s:s + n]
        out = gt.new_empty((wide,) + tuple(gt.shape[1:]))
        dist.reduce_scatter_tensor(out, padded, group=group)
        return out[:sizes[r]].movedim(0, dim), None, None, None


def halo_exchange(x: torch.Tensor, dim: int, lo: int, hi: int, group
                  ) -> torch.Tensor:
    """x with `lo` slices of the left neighbour's shard in front and `hi`
    of the right neighbour's behind along `dim` (zeros past the image's
    edges), in a fresh buffer of x's memory format."""
    if dim < 0:
        dim += x.dim()
    if isinstance(group, (VirtualRank, ReplayRank)):
        return group.halo(x, dim, lo, hi)
    pg = _group_of(group)
    if dist.get_world_size(pg) == 1:
        return _assemble(x, dim, None, None, lo, hi)
    if x.shape[dim] < max(lo, hi):
        raise ValueError(f"a shard of {x.shape[dim]} slices cannot give a "
                         f"halo of {max(lo, hi)}")
    return _Halo.apply(x, dim, lo, hi, pg)


def gather_spatial(x: torch.Tensor, dim: int, group,
                   sizes: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Every rank's shard of x along `dim`, in rank order. `sizes`: each
    rank's number of slices (default: all as x's). Its backward sums the
    ranks' gradients (module docstring); virtual ranks differentiate the
    one graph they build."""
    if dim < 0:
        dim += x.dim()
    n = group_size(group)
    sizes = tuple(int(s) for s in sizes) if sizes is not None else (
        (x.shape[dim],) * n)
    if len(sizes) != n or sizes[group_rank(group)] != x.shape[dim]:
        raise ValueError(f"shard sizes {sizes} do not fit this rank's "
                         f"{x.shape[dim]} slices on {n} ranks")
    if n == 1:
        return x
    if isinstance(group, (VirtualRank, ReplayRank)):
        return group.gather(x, dim)
    return _Gather.apply(x, dim, _group_of(group), sizes)


# ---------------------------------------------------------------------------
# virtual ranks: R programs in one process


class VirtualRanks:
    """`size` ranks whose programs run in lockstep in one process, one
    thread each (`run`); their collectives meet at a barrier and read each
    other's tensors. Every thread runs with the caller's grad mode,
    inference mode, CUDA device and stream, so the ranks' kernels queue on
    one stream. With `record`, what each rank receives is kept for
    `replay`."""

    def __init__(self, size: int, record: bool = False):
        if size < 1:
            raise ValueError(f"{size} virtual ranks")
        self.size = size
        self.record = record
        self.records: List[List[torch.Tensor]] = [[] for _ in range(size)]
        self._barrier = threading.Barrier(size)
        self._slots: List[object] = [None] * size

    def rank(self, r: int) -> "VirtualRank":
        return VirtualRank(self, r)

    def replay(self, r: int) -> "ReplayRank":
        """Rank r's recorded halos and gathers, in the order it received
        them (needs `record=True` and a finished `run`)."""
        if not self.record:
            raise ValueError("replay needs VirtualRanks(record=True)")
        return ReplayRank(r, self.size, self.records[r])

    def _exchange(self, r: int, obj, read: Callable):
        """read(every rank's obj) on rank r, between two barriers: no rank
        goes on (and could change its tensor) before all have read."""
        self._slots[r] = obj
        self._barrier.wait()
        out = read(list(self._slots))
        self._barrier.wait()
        return out

    def run(self, fn: Callable, per_rank_args: Sequence[tuple]) -> list:
        """[fn(self.rank(r), *per_rank_args[r]) for every r], each on its
        own thread, all at once. The first rank's exception is raised
        here (the others are released from the barrier)."""
        if len(per_rank_args) != self.size:
            raise ValueError(f"{len(per_rank_args)} argument tuples for "
                             f"{self.size} ranks")
        self.records = [[] for _ in range(self.size)]
        self._barrier = threading.Barrier(self.size)
        grad = torch.is_grad_enabled()
        inference = torch.is_inference_mode_enabled()
        stream = (torch.cuda.current_stream()
                  if torch.cuda.is_available() and torch.cuda.is_initialized()
                  else None)
        results: list = [None] * self.size
        errors: list = [None] * self.size

        def body(r):
            try:
                if stream is not None:
                    torch.cuda.set_device(stream.device)
                ctx = (torch.cuda.stream(stream) if stream is not None
                       else contextlib.nullcontext())
                with torch.inference_mode(inference), \
                        torch.set_grad_enabled(grad), ctx:
                    results[r] = fn(self.rank(r), *per_rank_args[r])
            except BaseException as e:      # noqa: BLE001 - raised below
                errors[r] = e
                self._barrier.abort()

        if self.size == 1:
            body(0)
        else:
            threads = [threading.Thread(target=body, args=(r,))
                       for r in range(self.size)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        raised = [e for e in errors if e is not None]
        if raised:      # the cause, not a rank the abort released
            raise next((e for e in raised if not isinstance(
                e, threading.BrokenBarrierError)), raised[0])
        return results


class VirtualRank:
    """Rank `rank` of a `VirtualRanks`: the group handle its program
    passes to `halo_exchange` / `gather_spatial`."""

    def __init__(self, world: VirtualRanks, rank: int):
        self.world, self.rank, self.size = world, rank, world.size

    def halo(self, x, dim: int, lo: int, hi: int):
        r, n = self.rank, self.size

        def read(every):
            left = right = None
            if r > 0 and lo:
                prev = every[r - 1]
                left = prev.narrow(dim, prev.shape[dim] - lo, lo)
            if r < n - 1 and hi:
                right = every[r + 1].narrow(dim, 0, hi)
            if self.world.record:
                self.world.records[r].append(
                    (None if left is None else left.detach().clone(),
                     None if right is None else right.detach().clone()))
            return _assemble(x, dim, left, right, lo, hi)

        return self.world._exchange(r, x, read)

    def gather(self, x, dim: int):
        out = self.world._exchange(self.rank, x,
                                   lambda every: torch.cat(every, dim))
        if self.world.record:
            self.world.records[self.rank].append(out.detach())
        return out


class ReplayRank:
    """Rank `rank`'s program run alone: each halo / gather hands back what
    that rank received in the recorded run, in order."""

    def __init__(self, rank: int, size: int, records: list):
        self.rank, self.size = rank, size
        self._records, self._i = records, 0

    def _next(self):
        if self._i >= len(self._records):
            raise RuntimeError("the replayed program asks for more "
                               "collectives than the recorded run made")
        rec = self._records[self._i]
        self._i += 1
        return rec

    def halo(self, x, dim: int, lo: int, hi: int):
        left, right = self._next()
        return _assemble(x, dim, left, right, lo, hi)

    def gather(self, x, dim: int):
        return self._next()

    def rewind(self) -> "ReplayRank":
        self._i = 0
        return self
