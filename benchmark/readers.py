"""What the metric files share: reading a run's record (`harness.
build_record`). Each returns None where the record holds nothing to read,
and the harness then leaves the metric out of the line."""

from __future__ import annotations

from typing import Optional

from benchmark.flops import PEAK_BF16_FLOPS


def per_unit(rec: dict, unit: str) -> Optional[float]:
    """Window seconds per completed unit of the given kind."""
    if rec["unit"] != unit or not rec["units"]:
        return None
    return rec["window_s"] / rec["units"]


def traced(rec: dict, unit: str) -> bool:
    return rec["unit"] == unit and rec.get("events") is not None


def roofline(rec: dict, unit: str, *groups: str) -> Optional[float]:
    """% of the kernels' bound over their device time in the window
    (bound from each call's shapes; time from the trace by kernel name).
    None where the kernels did not run."""
    if not traced(rec, unit):
        return None
    bound = sum(rec["bounds_s"].get(g, 0.0) for g in groups)
    busy = sum(rec["group_s"].get(g, 0.0) for g in groups)
    if bound <= 0 or busy <= 0:
        return None
    return 100.0 * bound / busy


def idle_share(rec: dict, unit: str) -> Optional[float]:
    """% of the traced window with no kernel, copy or set on the card."""
    if not traced(rec, unit) or rec["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])


def mfu(rec: dict, unit: str) -> Optional[float]:
    """% of the bf16 peak: model FLOPs of the units completed over the
    window's seconds (traced run)."""
    if not traced(rec, unit) or rec["flops"] <= 0:
        return None
    return 100.0 * rec["flops"] / (rec["window_s"] * PEAK_BF16_FLOPS)


def stage_mean(rec: dict, unit: str, stage: str) -> Optional[float]:
    """Mean of a stage's seconds over the window's units."""
    vals = rec["stages"].get(stage)
    if rec["unit"] != unit or not vals:
        return None
    return sum(vals) / len(vals)


def group_ms_per_unit(rec: dict, unit: str, group: str) -> Optional[float]:
    """Device ms per unit in one kernel group."""
    if not traced(rec, unit) or not rec["units"]:
        return None
    return 1e3 * rec["group_s"].get(group, 0.0) / rec["units"]
