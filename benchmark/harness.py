"""One run of one cell: find its files by name, set up the program, time
the window, read the trace, compute the metrics and decide `correct`.

`run.py` checks for the card and prints; the tests call `run_cell` with a
CPU device and small files to drive everything else."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys
import time
from types import ModuleType
from typing import Callable, Dict, List, Optional

import torch

from benchmark import trace as tr

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# top-level modules no run may hold: JAX and the JAX package (compared as
# whole names: the port's name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "omnihuman_tpu")


def load_module(path: str, name: str) -> ModuleType:
    """A benchmark file as a module (metric names hold dots, so the files
    are loaded by path)."""
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    workload: dict
    config: dict             # configs/<config>.json
    traffic: dict            # traffic/<mix>.json
    limits: dict             # limits/<cell>.json
    driver: ModuleType
    end_to_end: List[dict]
    per_layer: List[dict]


def _reports(metric: dict, cell: str, e2e_names: List[str]) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") is None or metric["moves"] in e2e_names


def load_cell(name: str, root: str = ROOT, bench: Optional[dict] = None,
              files: str = HERE) -> Cell:
    """The cell `name` of BENCHMARK.json (`bench`, else root's file) with
    its files, found by name: the configuration's file under `root`, the
    traffic and the limits under `files` (the benchmark's folder)."""
    bench = bench or read_json(os.path.join(root, "BENCHMARK.json"))
    wl = [w for w in bench["workloads"] if w["name"] == name]
    if not wl:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    wl = wl[0]
    conf = [c for c in bench["configs"] if c["name"] == wl["config"]][0]
    config = read_json(os.path.join(root, conf["file"]))
    traffic = read_json(os.path.join(files, "traffic",
                                     wl["traffic"] + ".json"))
    limits = read_json(os.path.join(files, "limits", name + ".json"))
    driver = load_module(os.path.join(HERE, "drivers",
                                      traffic["driver"] + ".py"),
                         "bench_driver_" + traffic["driver"])
    e2e = [m for m in bench["end_to_end"] if _reports(m, name, [])]
    names = [m["name"] for m in e2e]
    per_layer = [m for m in bench["per_layer"] if _reports(m, name, names)]
    return Cell(name, wl, config, traffic, limits, driver, e2e, per_layer)


@dataclasses.dataclass
class Context:
    """What a driver gets: the cell's files, the seed and the device."""
    cell: Cell
    seed: int
    device: torch.device
    control: bool = False     # the reference in lower precision judged
    trace: bool = False       # the traced run: drivers may time spans


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def timed_window(unit: Callable[[int], dict], seconds: float,
                 clock: Callable[[], float] = time.perf_counter):
    """Issue units (each ends synchronised) until `seconds` have passed;
    the window ends with the last unit. Returns (unit records, window s)."""
    recs = []
    t0 = clock()
    while True:
        recs.append(unit(len(recs)) or {})
        elapsed = clock() - t0
        if elapsed >= seconds:
            return recs, elapsed


def process_age_s() -> float:
    """Seconds since this process started (Linux: /proc/self/stat's start
    time against the boot clock), so set-up counts the interpreter's own
    start and every import."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    return time.clock_gettime(time.CLOCK_BOOTTIME) - start


def forbidden_modules(modules=None) -> List[str]:
    """Top-level names of loaded modules that are JAX or the JAX package,
    compared whole (`omnihuman_tpu_torch` is not `omnihuman_tpu`)."""
    modules = sys.modules if modules is None else modules
    tops = {m.split(".", 1)[0] for m in modules}
    return sorted(tops & set(FORBIDDEN))


def build_record(cell: Cell, recs: List[dict], window_s: float,
                 setup_s: float, peak_bytes: int,
                 events: Optional[list]) -> dict:
    """Everything the metric readers read: the window's units, their
    model FLOPs, kernel bounds, stage times and spans, and the trace."""
    rec = {"cell": cell.name, "unit": cell.traffic["unit"],
           "units": len(recs), "window_s": window_s, "setup_s": setup_s,
           "peak_bytes": peak_bytes,
           "flops": sum(r.get("flops", 0.0) for r in recs),
           "bounds_s": {}, "stages": {}, "events": events}
    for r in recs:
        for k, v in r.get("bounds_s", {}).items():
            rec["bounds_s"][k] = rec["bounds_s"].get(k, 0.0) + v
        for k, v in r.get("stages", {}).items():
            rec["stages"].setdefault(k, []).append(v)
    if events is not None:
        rec["group_s"] = tr.group_seconds(events)
        rec["busy_s"] = tr.busy_seconds(events)
    return rec


def compute_metrics(metrics: List[dict], rec: dict) -> Dict[str, dict]:
    """{name: {"value", "unit"}} of every metric whose reader finds
    something to read (`metrics/<name>.py`'s `compute(record)`)."""
    out = {}
    for m in metrics:
        mod = load_module(os.path.join(HERE, "metrics", m["name"] + ".py"),
                          "bench_metric_" + m["name"].replace(".", "_"))
        v = mod.compute(rec)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device, clock: Callable[[], float] = time.perf_counter,
             control: bool = False) -> dict:
    """Set up, time the window, read the metrics, free the program's
    state, then judge its outputs against the reference. Returns the
    result's fields (`checks` last)."""
    drv = cell.driver
    ctx = Context(cell, seed, torch.device(device), control, trace)
    cuda = ctx.device.type == "cuda"
    state = drv.setup(ctx)
    sync(device)
    setup_s = process_age_s()
    peak_setup = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    events = None
    if trace:
        with tr.DeviceTrace() as dt:
            recs, window_s = timed_window(lambda i: drv.unit(state, i),
                                          seconds, clock)
        events = dt.events
    else:
        recs, window_s = timed_window(lambda i: drv.unit(state, i),
                                      seconds, clock)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    rec = build_record(cell, recs, window_s, setup_s, peak, events)
    metrics = compute_metrics(cell.per_layer if trace else cell.end_to_end,
                              rec)
    drv.release(state)
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    checks = drv.check(state, ctx)
    rec["check_s"] = time.perf_counter() - t0
    limits = cell.limits["limits"]
    judged = {k: {"value": v, "limit": limits[k]} for k, v in checks.items()}
    correct = all(v["value"] <= v["limit"] for v in judged.values())
    out = {"correct": correct, "attempted": len(recs), "failed": 0,
           "metrics": metrics,
           "device": {"count": 1, "memory_peak_bytes": max(peak_setup, peak)},
           "record": rec}
    if trace:
        out["device"]["busy_s"] = rec["busy_s"]
        out["device"]["window_s"] = window_s
        out["breakdown"] = {"device_ops": tr.top_ops(events),
                            "idle_gaps": tr.idle_gaps(events)}
    out["checks"] = judged
    return out
