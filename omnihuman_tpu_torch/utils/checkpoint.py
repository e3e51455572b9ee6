"""Checkpoint IO for training states (port of
omnihuman_tpu/utils/checkpoint.py, which saves through Orbax).

    mgr = CheckpointManager(directory, max_to_keep=5)
    mgr.save(step, state, metadata={"epoch": 0})
    state = mgr.restore(target=state)          # latest step, in place

Each step is a directory `step_XXXXXXXX/` holding `state.pt` (the state's
`state_dict()`, or the dict itself, with every tensor moved to the host and
written by `torch.save`; dtypes and bits are kept) and `meta.json`. A step
is written to a temporary directory and renamed into place, so a crash
never leaves a half-written step behind. Saving is synchronous; `wait` and
`close` are there for the JAX interface. Past `max_to_keep` steps, the
oldest are deleted.

On a training mesh (a joined process group) every rank calls `save`: the
DTensor shards of a state are gathered into whole tensors (every rank
takes part in each gather), rank 0 writes the single-GPU file layout and
the others wait for it. Every rank `restore`s from the file, and a
state's `load_state_dict` keeps each rank's own shards
(parallel/partition.py `place_like`), so a step written on one mesh
resumes on another, or in one process, and the reverse (orbax's
restore-then-reshard in JAX).
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, List, Optional

import torch
import torch.distributed as dist

from omnihuman_tpu_torch.parallel.mesh import is_writer
from omnihuman_tpu_torch.parallel.partition import copy_whole_into, full


def _to_cpu(tree, keep: bool = True):
    """The tree with every tensor whole (DTensors gathered) on the host;
    with keep False (a rank that does not write) the gathers still run
    but the tensors are dropped."""
    if isinstance(tree, torch.Tensor):
        whole = full(tree.detach())
        return whole.cpu() if keep else None
    if isinstance(tree, dict):
        return {k: _to_cpu(v, keep) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v, keep) for v in tree)
    return tree


class CheckpointManager:
    """save(step, state, metadata) / restore(step?, target?) -> state."""

    def __init__(self, directory: str, max_to_keep: int = 5):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}")

    def save(self, step: int, state: Any,
             metadata: Optional[Dict] = None) -> None:
        sd = state.state_dict() if hasattr(state, "state_dict") else state
        writer = is_writer()
        host = _to_cpu(sd, keep=writer)
        if writer:
            self._write(step, host, metadata)
        if dist.is_initialized():
            dist.barrier()

    def _write(self, step: int, sd: Dict, metadata: Optional[Dict]) -> None:
        final = self._path(step)
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(sd, os.path.join(tmp, "state.pt"))
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump({"metadata": metadata}, f)
        shutil.rmtree(final, ignore_errors=True)
        os.rename(tmp, final)
        if self.max_to_keep:
            for old in self.all_steps()[:-self.max_to_keep]:
                shutil.rmtree(self._path(old))

    def restore(self, step: Optional[int] = None, target: Any = None) -> Any:
        """The state dict of `step` (default: the latest) on the host, or
        None if there is no checkpoint. With a `target` (an object with
        `load_state_dict`), load into it and return the target."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        # mmap: tensors are read as they are used, so a caller that takes
        # part of a large state (the parameters alone) reads only that
        sd = torch.load(os.path.join(self._path(step), "state.pt"),
                        map_location="cpu", weights_only=True, mmap=True)
        if target is not None:
            target.load_state_dict(sd)
            return target
        return sd

    def restore_metadata(self, step: Optional[int] = None) -> Optional[Dict]:
        """The JSON metadata saved with `step` (None if there is none)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        path = os.path.join(self._path(step), "meta.json")
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return json.load(f).get("metadata")

    def all_steps(self) -> List[int]:
        return sorted(int(d.split("_")[1]) for d in os.listdir(self.directory)
                      if d.startswith("step_") and not d.endswith(".tmp"))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def wait(self) -> None:
        """Saves are synchronous: nothing to wait for."""

    def close(self) -> None:
        """Nothing is held open."""


@torch.no_grad()
def restore_ema_into(model: torch.nn.Module, directory: str) -> int:
    """Copy the generator stream of the latest step in `directory` into
    `model`'s parameters, cast to their dtype: the `ema_params` of a
    distill or APT state, or a bare {name: tensor} dict as it is. Returns
    the step. FileNotFoundError without a step, ValueError when the names
    are not the model's."""
    mgr = CheckpointManager(directory)
    step = mgr.latest_step()
    if step is None:
        raise FileNotFoundError(f"no checkpoint found in {directory}")
    state = mgr.restore(step)
    ema = state.get("ema_params", state)
    params = dict(model.named_parameters())
    if set(ema) != set(params):
        raise ValueError(f"{directory}: the EMA parameters do not match the "
                         f"model's")
    for name, p in params.items():
        copy_whole_into(p, ema[name])
    return step
