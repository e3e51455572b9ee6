"""The port's logger, device helpers and training-metrics sink (port of
omnihuman_tpu/utils/logging.py: `get_logger`, `logger`,
`log_device_memory`, `debug_tensor`, `anomaly_detection`,
`profile_trace`, `MetricsLogger`).

`logger` writes to stderr (JAX's also appends to `project.log` in the
working directory). `MetricsLogger` appends one JSON record a call to
`<out_dir>/metrics_<run_name>.jsonl`, or logs to wandb where the
environment configures it (`WANDB_MODE` or `WANDB_API_KEY` set) and
`wandb.init` succeeds: the same call surface either way. JAX's tries
wandb whenever it imports; here an unconfigured `wandb.init` is never
called, because it may reach for the network, and because wandb keeps
the exception it raises, whose frames then hold every object of the
caller that built the logger (a whole train setup, where wandb is
installed but not logged in).

Device helpers: `log_device_memory` reports each CUDA device's allocated
and total memory (JAX: `memory_stats()` per device); `debug_tensor`
returns JAX's dict; `profile_trace` records a `torch.profiler` trace
(host and, where there is a card, CUDA activity) and writes it as a
chrome trace in `log_dir` (JAX: `jax.profiler`; the TPU trace parser
`utils/xplane.py` has no counterpart). `anomaly_detection` is JAX's
`jax_debug_nans`: it raises FloatingPointError at the first op whose
floating output holds a NaN, forward ops included (a TorchDispatchMode;
`torch.autograd.set_detect_anomaly` alone checks only the backward, which
it also turns on).
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import sys
import time
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode


def get_logger() -> logging.Logger:
    """The package logger, its stderr handler (INFO) added on the first
    call."""
    lg = logging.getLogger("omnihuman_tpu_torch")
    if not lg.handlers:
        lg.setLevel(logging.DEBUG)
        sh = logging.StreamHandler(sys.stderr)
        sh.setLevel(logging.INFO)
        sh.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname)s %(name)s: %(message)s"))
        lg.addHandler(sh)
    return lg


logger = get_logger()


def log_device_memory(tag: str = "") -> dict:
    """{device: (GiB allocated by this process, GiB total)} of every CUDA
    device, each also logged; raises without one."""
    if not torch.cuda.is_available():
        raise RuntimeError("log_device_memory reports CUDA devices; this "
                           "process sees none")
    stats = {}
    for i in range(torch.cuda.device_count()):
        used = torch.cuda.memory_allocated(i) / 2 ** 30
        total = torch.cuda.mem_get_info(i)[1] / 2 ** 30
        name = f"cuda:{i} ({torch.cuda.get_device_name(i)})"
        stats[name] = (used, total)
        logger.info(f"{tag} {name}: {used:.2f}/{total:.2f} GiB in use")
    return stats


def debug_tensor(x, name: str = "tensor") -> dict:
    """Shape, dtype, min / max / mean / std (population) and NaN / Inf
    flags of a tensor, with the JAX helper's keys and dtype names."""
    x = torch.as_tensor(x)
    xf = x.detach().to(torch.float32)
    info = {
        "name": name, "shape": tuple(x.shape),
        "dtype": str(x.dtype).removeprefix("torch."),
        "min": float(xf.min()), "max": float(xf.max()),
        "mean": float(xf.mean()), "std": float(xf.std(correction=0)),
        "has_nan": bool(torch.isnan(xf).any()),
        "has_inf": bool(torch.isinf(xf).any()),
    }
    logger.debug(f"{name}: {info}")
    return info


# factories whose output is uninitialised memory, not a result
_UNINITIALISED = ("empty", "empty_like", "empty_strided", "new_empty",
                  "new_empty_strided", "empty_permuted")


class _NaNCheck(TorchDispatchMode):
    """Raises FloatingPointError at the first op that returns a new
    floating tensor holding a NaN (views, in-place results and
    uninitialised allocations are not results of their own)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        schema = func._schema
        if (func.overloadpacket.__name__ in _UNINITIALISED
                or schema.is_mutable
                or any(r.alias_info is not None for r in schema.returns)):
            return out
        for t in torch.utils._pytree.tree_leaves(out):
            if (isinstance(t, torch.Tensor) and t.is_floating_point()
                    and torch.isnan(t).any()):
                raise FloatingPointError(f"NaN in the output of {func}")
        return out


@contextlib.contextmanager
def anomaly_detection():
    """NaN trap (JAX `jax_debug_nans`, reference TorchDebugger anomaly
    mode): forward ops through `_NaNCheck`, the backward through
    `torch.autograd.set_detect_anomaly`."""
    with torch.autograd.set_detect_anomaly(True), _NaNCheck():
        yield


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """A `torch.profiler` trace of the block (host activity, and CUDA
    activity where there is a card), written on exit as
    `<log_dir>/trace.json` (chrome trace format). Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    logger.info(f"profiler trace -> {path}")


class MetricsLogger:
    """log(metrics, step) / finish(): wandb when available, else JSONL. On
    a process group only the writing rank (rank 0) logs; the others'
    loggers do nothing."""

    def __init__(self, project: str = "omnihuman-tpu",
                 run_name: Optional[str] = None, out_dir: str = "."):
        from omnihuman_tpu_torch.parallel.mesh import is_writer
        self._wandb = None
        self._file = None
        if not is_writer():
            return
        why = "not configured (WANDB_MODE / WANDB_API_KEY unset)"
        if os.environ.get("WANDB_MODE") or os.environ.get("WANDB_API_KEY"):
            try:
                import wandb
                wandb.init(project=project, name=run_name)
                self._wandb = wandb
            except Exception as e:    # no wandb, or no login for it
                why = type(e).__name__
        if self._wandb is None:
            os.makedirs(out_dir, exist_ok=True)
            path = os.path.join(out_dir, f"metrics_{run_name or 'run'}.jsonl")
            self._file = open(path, "a")
            logger.info(f"wandb unavailable ({why}); metrics -> {path}")

    def log(self, metrics: dict, step: Optional[int] = None) -> None:
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)
            return
        if self._file is None:
            return
        rec = {"step": step, "ts": time.time(),
               **{k: float(v) for k, v in metrics.items()
                  if isinstance(v, (int, float)) or hasattr(v, "item")}}
        self._file.write(json.dumps(rec) + "\n")
        self._file.flush()

    def finish(self) -> None:
        if self._wandb is not None:
            self._wandb.finish()
        elif self._file is not None:
            self._file.close()
            self._file = None
