"""Spans: named intervals of the port's work on the profiler's clock.

`span(name, **attrs)` is a context manager opened where the work happens
(a request, a denoise step, a DiT block, a training step's backward).
Spans record only while a `torch.profiler` session is active: the
benchmark's traced window, `utils.logging.profile_trace` and
`cli.generate --profile`. Otherwise `span` reads one flag and returns a
shared object that does nothing, and under `torch.compile` or
`torch.export` tracing it always does, so a traced program holds no span
code.

A span records its name, its id, its parent's id (from a stack per
thread; autograd's worker threads start roots of their own), the id of
its root (shared by every span of one request, step or training step),
its attrs, and host start and end from `time.time_ns`, the clock the
profiler stamps its events with. Where CUDA is initialised it also
records a CUDA event at each end, on the current stream. Device times are
put on the host clock after the session, never inside it: the first span
of a session synchronises once and records an anchor event, and a device
time is the anchor's host time plus `elapsed_time` from the anchor.

`collected()` returns the closed spans, resolved; `clear()` drops them.
`stage(key, timings, device)` is a span that also fills
`timings[key]` with the host seconds of its block (`time.perf_counter`),
ended by a synchronise of `device`: the pipelines' stage times.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, List, Optional

import torch
from torch.autograd import profiler as _profiler


class _NoSpan:
    """The span of a process that is not profiling: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()
_ids = itertools.count(1)
_local = threading.local()
_spans: List["_Span"] = []               # in the order they opened
_anchors: Dict[int, tuple] = {}          # device index -> (event, host ns)
_anchor_lock = threading.Lock()


def _events_device() -> Optional[int]:
    """The CUDA device whose current stream a span's events go on, or None
    where this process has not initialised CUDA."""
    if not torch.cuda.is_initialized():
        return None
    dev = torch.cuda.current_device()
    if dev not in _anchors:
        with _anchor_lock:
            if dev not in _anchors:
                _anchors[dev] = _anchor(dev)
    return dev


def _anchor(dev: int) -> tuple:
    """(event, host ns) of an event recorded on the idle card: of three
    tries, the one whose record call took least, timed at the call's
    midpoint (the card stamps the event while the call runs)."""
    torch.cuda.synchronize(dev)
    best = None
    for _ in range(3):
        ev = torch.cuda.Event(enable_timing=True)
        t0 = time.time_ns()
        ev.record()
        t1 = time.time_ns()
        ev.synchronize()
        if best is None or t1 - t0 < best[2] - best[1]:
            best = (ev, t0, t1)
    return best[0], (best[1] + best[2]) // 2


def _timed_event():
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


class _Span:
    __slots__ = ("name", "id", "parent", "root", "thread", "attrs", "t0",
                 "t1", "device", "ev0", "ev1")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs
        self.t1 = self.ev0 = self.ev1 = None

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.id = next(_ids)
        self.parent = stack[-1].id if stack else None
        self.root = stack[0].id if stack else self.id
        self.thread = threading.get_ident()
        self.device = _events_device()
        stack.append(self)
        _spans.append(self)
        self.t0 = time.time_ns()
        if self.device is not None:
            self.ev0 = _timed_event()
        return self

    def __exit__(self, *exc):
        if self.device is not None:
            self.ev1 = _timed_event()
        self.t1 = time.time_ns()
        _local.stack.pop()
        return False


def span(name: str, **attrs):
    """A context manager recording `name` while a profiler session is
    active (module docstring); a shared no-op otherwise."""
    if not _profiler._is_profiler_enabled:
        return _NO_SPAN
    if torch.compiler.is_compiling():
        return _NO_SPAN
    return _Span(name, attrs)


def _sync(device) -> None:
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class stage:
    """`with stage("dit_s", timings, device, **attrs) as st:` the span
    "dit" around the block; on a normal exit, `device` is synchronised
    and the block's host seconds go to `st.seconds` and, where `timings`
    is a dict, to `timings[key]`. `device=None`: no synchronise."""

    def __init__(self, key: str, timings: Optional[dict], device,
                 **attrs):
        self.key, self.timings, self.device = key, timings, device
        self._span = span(key.removesuffix("_s"), **attrs)
        self.seconds = None

    def __enter__(self):
        self._span.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            _sync(self.device)
            self.seconds = time.perf_counter() - self._t0
            if self.timings is not None:
                self.timings[self.key] = self.seconds
        return self._span.__exit__(*exc)


def collected() -> List[dict]:
    """The closed spans in the order they opened, each {"name", "id",
    "parent", "root", "thread", "attrs", "host": (start ns, end ns),
    "device": (start ns, end ns) on the host clock, or None}. Waits for
    the card where spans recorded events on it."""
    done = [s for s in _spans if s.t1 is not None]
    for dev in {s.device for s in done if s.device is not None}:
        torch.cuda.synchronize(dev)
    out = []
    for s in done:
        device = None
        if s.device is not None:
            anchor, host = _anchors[s.device]
            device = tuple(host + int(anchor.elapsed_time(e) * 1e6)
                           for e in (s.ev0, s.ev1))
        out.append({"name": s.name, "id": s.id, "parent": s.parent,
                    "root": s.root, "thread": s.thread, "attrs": s.attrs,
                    "host": (s.t0, s.t1), "device": device})
    return out


def clear() -> None:
    """Drop the recorded spans and the anchors; the next span starts a new
    session."""
    _spans.clear()
    _anchors.clear()


def chrome_events(spans: List[dict], base_ns: int = 0) -> List[dict]:
    """Chrome-trace complete events of resolved spans: a host track per
    thread under the process "spans (host)" and, where spans have device
    times, one track under "spans (device)"; `ts` in us after `base_ns`
    (a chrome trace's `baseTimeNanoseconds`)."""
    out = []
    for s in spans:
        args = {"id": s["id"], "parent": s["parent"], "root": s["root"],
                **{k: v if isinstance(v, (int, float, str, bool))
                   else str(v) for k, v in s["attrs"].items()}}
        tracks = [("spans (host)", s["thread"], s["host"])]
        if s["device"] is not None:
            tracks.append(("spans (device)", 0, s["device"]))
        for pid, tid, (t0, t1) in tracks:
            out.append({"ph": "X", "cat": "span", "name": s["name"],
                        "pid": pid, "tid": tid, "ts": (t0 - base_ns) / 1e3,
                        "dur": (t1 - t0) / 1e3, "args": args})
    return out
