"""The traced window's device time and idle time, split by the port's
spans (`omnihuman_tpu_torch.utils.spans`, recorded while the window's
profiler runs).

A device event (kernel, copy, set) goes to the innermost span whose
device interval holds the event's midpoint; an idle instant (between the
busy stretches of `trace.merged`) goes to the innermost span open on the
host at that instant. Innermost: the covering span that started last.
Time that no span covers goes to None. Where the program has no
recorder, or it recorded nothing in the window, there is nothing to
split and `attribution` returns None; the metrics that read it are then
left out of the line.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Sequence, Tuple

from benchmark import trace as tr

MEMO = "span_attribution"     # the record's key for the memoised result


def segments(intervals: Sequence[Tuple[int, int, str]]
             ) -> List[Tuple[int, int, Optional[str]]]:
    """The time line cut at every interval's ends, each piece labelled
    by the innermost interval covering it (None where none does)."""
    points = sorted({p for s, e, _ in intervals for p in (s, e)})
    starts = sorted(intervals)
    active: list = []
    out = []
    j = 0
    for a, b in zip(points, points[1:]):
        while j < len(starts) and starts[j][0] <= a:
            active.append(starts[j])
            j += 1
        active = [iv for iv in active if iv[1] > a]
        best = max(active, key=lambda iv: (iv[0], -iv[1]), default=None)
        out.append((a, b, None if best is None else best[2]))
    return out


def _label_at(segs, firsts, t) -> Optional[str]:
    i = bisect.bisect_right(firsts, t) - 1
    if i < 0 or t >= segs[i][1]:
        return None
    return segs[i][2]


def _split(segs, firsts, a: int, b: int, out: Dict) -> None:
    """Add the pieces of [a, b) to out[label] (ns)."""
    i = max(bisect.bisect_right(firsts, a) - 1, 0)
    covered = 0
    while i < len(segs) and segs[i][0] < b:
        lo, hi = max(a, segs[i][0]), min(b, segs[i][1])
        if hi > lo:
            out[segs[i][2]] = out.get(segs[i][2], 0) + hi - lo
            covered += hi - lo
        i += 1
    if b - a > covered:
        out[None] = out.get(None, 0) + b - a - covered


def attribute(spans: List[dict], events: Sequence[tr.Event]) -> dict:
    """{"device_s": {(span name or None, kernel group): s}, "idle_s":
    {span name or None: s}, "spans": n} of one window's events and the
    spans recorded over it (`utils.spans.collected()`)."""
    dev = [(s["device"][0], s["device"][1], s["name"]) for s in spans
           if s["device"] is not None]
    segs = segments(dev)
    firsts = [s[0] for s in segs]
    device: Dict[tuple, float] = {}
    for name, start, dur in events:
        key = (_label_at(segs, firsts, start + dur // 2), tr.group_of(name))
        device[key] = device.get(key, 0.0) + dur * 1e-9
    segs = segments([(s["host"][0], s["host"][1], s["name"])
                     for s in spans])
    firsts = [s[0] for s in segs]
    idle: Dict[Optional[str], int] = {}
    busy = tr.merged(events)
    for (_, end, _, _), (start, _, _, _) in zip(busy, busy[1:]):
        _split(segs, firsts, end, start, idle)
    return {"device_s": device,
            "idle_s": {k: v * 1e-9 for k, v in idle.items()},
            "spans": len(spans)}


def _recorded(events: Sequence[tr.Event]) -> Optional[List[dict]]:
    """The program's spans that overlap the window's events, taken out of
    its recorder; None without a recorder."""
    try:
        from omnihuman_tpu_torch.utils import spans as recorder
    except ImportError:
        return None
    got = recorder.collected()
    recorder.clear()
    if not events:
        return []
    lo = min(s for _, s, _ in events)
    hi = max(s + d for _, s, d in events)
    return [s for s in got if s["host"][1] >= lo and s["host"][0] <= hi]


def attribution(rec: dict) -> Optional[dict]:
    """`attribute` of a traced record, computed once per record; None
    where the run was not traced or no span was recorded."""
    if MEMO not in rec:
        got = (None if rec.get("events") is None
               else _recorded(rec["events"]))
        rec[MEMO] = attribute(got, rec["events"]) if got else None
    return rec[MEMO]


def device_ms_per_unit(rec: dict, unit: str, names: Sequence[str],
                       skip: Sequence[str] = ()) -> Optional[float]:
    """Device ms per unit of the events whose innermost span is one of
    `names`, leaving out the kernel groups in `skip`."""
    if rec["unit"] != unit or not rec["units"]:
        return None
    att = attribution(rec)
    if att is None:
        return None
    s = sum(v for (name, group), v in att["device_s"].items()
            if name in names and group not in skip)
    return 1e3 * s / rec["units"]


def idle_ms_per_unit(rec: dict, unit: str) -> Optional[float]:
    """Device-idle ms per unit that lie inside some span on the host."""
    if rec["unit"] != unit or not rec["units"]:
        return None
    att = attribution(rec)
    if att is None:
        return None
    s = sum(v for name, v in att["idle_s"].items() if name is not None)
    return 1e3 * s / rec["units"]
