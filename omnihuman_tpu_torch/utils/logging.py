"""The port's logger and training-metrics sink (port of
omnihuman_tpu/utils/logging.py: `get_logger`, `logger`, `MetricsLogger`).

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

The JAX module's device helpers (`log_device_memory`, `profile_trace`,
`anomaly_detection`, `debug_tensor`) are not ported: their counterparts
here are `torch.cuda.max_memory_allocated`, `torch.profiler` and
`torch.autograd.set_detect_anomaly` (ROADMAP queue A, item 20).
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time
from typing import Optional


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


class MetricsLogger:
    """log(metrics, step) / finish(): wandb when available, else JSONL."""

    def __init__(self, project: str = "omnihuman-tpu",
                 run_name: Optional[str] = None, out_dir: str = "."):
        self._wandb = None
        self._file = None
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
