"""The device trace of a `--trace 1` window: torch.profiler with CUDA
activity only (recording host ops costs a long window tens of seconds),
read into (name, start, duration) of every kernel, copy and set on the
card, then grouped by the port's kernel names."""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

Event = Tuple[str, int, int]      # (name, start_ns, duration_ns)

# the port's kernels by their device names, then cuBLAS; the rest is
# elementwise work, norms, copies and sets
GROUPS = (("K1", ("flash_fwd",)),
          ("K2", ("flash_bwd",)),
          ("K3", ("vae_conv_kernel", "act_cache_kernel")),
          ("K4", ("vae_upsample",)),
          ("GEMM", ("gemm", "xmma", "cutlass", "cublas", "nvjet")))


def group_of(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


class DeviceTrace:
    """Context manager: profiles the card while open; `events` afterwards."""

    def __init__(self):
        self.events: List[Event] = []
        self._prof = None

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        # the card's activity; the host's ops only where there is no card
        # (the CPU tests drive this path)
        self._cuda = torch.cuda.is_available()
        self._prof = profile(activities=[
            ProfilerActivity.CUDA if self._cuda else ProfilerActivity.CPU])
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        import torch
        self._prof.__exit__(*exc)
        kind = (torch.autograd.DeviceType.CUDA if self._cuda
                else torch.autograd.DeviceType.CPU)
        self.events = [
            (e.name(), int(e.start_ns()), int(e.duration_ns()))
            for e in self._prof.profiler.kineto_results.events()
            if e.device_type() == kind and e.duration_ns() > 0]
        self._prof = None
        return False


def group_seconds(events: Sequence[Event]) -> Dict[str, float]:
    """Device seconds by kernel group."""
    out: Dict[str, float] = {}
    for name, _, dur in events:
        g = group_of(name)
        out[g] = out.get(g, 0.0) + dur * 1e-9
    return out


def merged(events: Sequence[Event]) -> List[Tuple[int, int, str, str]]:
    """The union of the events' intervals: (start, end, first name, last
    name) of each busy stretch, in time order."""
    spans = sorted((s, s + d, n) for n, s, d in events)
    out: List[list] = []
    for s, e, n in spans:
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1], out[-1][3] = e, n
        else:
            out.append([s, e, n, n])
    return [tuple(x) for x in out]


def busy_seconds(events: Sequence[Event]) -> float:
    """Seconds in which something ran on the card (overlaps counted once)."""
    return sum(e - s for s, e, _, _ in merged(events)) * 1e-9


def top_ops(events: Sequence[Event], n: int = 10) -> List[list]:
    """[[name, seconds], ...] of the n device operations that took most
    time in all, names cut to 100 characters."""
    tot: Dict[str, float] = {}
    for name, _, dur in events:
        tot[name[:100]] = tot.get(name[:100], 0.0) + dur * 1e-9
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(events: Sequence[Event], n: int = 10) -> List[list]:
    """[[label, seconds], ...] of the n longest idle gaps between busy
    stretches, each labelled by the operations on either side of it (the
    host was issuing or waiting in between)."""
    m = merged(events)
    gaps = [(m[i + 1][0] - m[i][1], m[i][3], m[i + 1][2])
            for i in range(len(m) - 1)]
    gaps.sort(key=lambda g: -g[0])
    return [[f"after {a[:45]} / before {b[:45]}", g * 1e-9]
            for g, a, b in gaps[:n]]
