"""YAML config + argparse merge (port of omnihuman_tpu/utils/config_io.py,
the part the training CLIs use).

  - `load_yaml(path)` -> nested AttrDict with ${a.b} interpolation
  - `merge_args(cfg, args)` -> YAML fills argparse fields left at None
    (the reference's precedence, distilled_trainer.py:376-382: a flag set
    on the command line wins)
  - `save_snapshot(cfg, run_dir)` -> the resolved config as YAML in the
    run directory

`yaml` is imported only inside `load_yaml` and `save_snapshot`, so the
CLIs need it only when they read or write a YAML.
"""

from __future__ import annotations

import argparse
import os
import re
from typing import Any, Dict


class AttrDict(dict):
    """dict with attribute access."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name, value):
        self[name] = value

    def get_path(self, dotted: str, default=None):
        cur: Any = self
        for part in dotted.split("."):
            if not isinstance(cur, dict) or part not in cur:
                return default
            cur = cur[part]
        return cur


def _wrap(obj):
    if isinstance(obj, dict):
        return AttrDict({k: _wrap(v) for k, v in obj.items()})
    if isinstance(obj, list):
        return [_wrap(v) for v in obj]
    return obj


_INTERP = re.compile(r"\$\{([a-zA-Z0-9_.]+)\}")


def _interpolate(node, root):
    if isinstance(node, dict):
        return AttrDict({k: _interpolate(v, root) for k, v in node.items()})
    if isinstance(node, list):
        return [_interpolate(v, root) for v in node]
    if isinstance(node, str):
        full = _INTERP.fullmatch(node)
        if full:     # a whole-string reference keeps the value's type
            val = root.get_path(full.group(1))
            return val if val is not None else node

        def sub(m):
            val = root.get_path(m.group(1))
            return str(val) if val is not None else m.group(0)
        return _INTERP.sub(sub, node)
    return node


def load_yaml(path: str) -> AttrDict:
    import yaml
    with open(path) as f:
        raw = yaml.safe_load(f) or {}
    cfg = _wrap(raw)
    return _interpolate(cfg, cfg)


def merge_args(cfg: Dict[str, Any],
               args: argparse.Namespace) -> argparse.Namespace:
    """Fill argparse fields that are None from the (flat) config."""
    for k, v in vars(args).items():
        if v is None and k in cfg:
            setattr(args, k, cfg[k])
    return args


def save_snapshot(cfg: Dict[str, Any], run_dir: str,
                  name: str = "config_snapshot.yaml") -> str:
    """Write `cfg` (interpolated) to `run_dir/name`; returns the path."""
    import yaml
    os.makedirs(run_dir, exist_ok=True)
    path = os.path.join(run_dir, name)

    def plain(o):
        if isinstance(o, dict):
            return {k: plain(v) for k, v in o.items()}
        if isinstance(o, list):
            return [plain(v) for v in o]
        return o

    with open(path, "w") as f:
        yaml.safe_dump(plain(dict(cfg)), f, sort_keys=False,
                       allow_unicode=True)
    return path
