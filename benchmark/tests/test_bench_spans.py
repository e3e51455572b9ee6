"""The split of a traced window by the program's spans (`benchmark/
spans.py`) on synthetic events and spans: device time goes to the
innermost span holding each event's midpoint, and partitions the group
it splits; idle time goes to the innermost span open on the host; with
no recorder, or nothing recorded, the metrics that read it are left
out."""

from __future__ import annotations

import sys

import pytest

from benchmark import harness, spans

MS = 1_000_000                      # ns


def sp(name, host, device=None, id_=0, parent=None):
    return {"name": name, "id": id_, "parent": parent, "root": 0,
            "thread": 1, "attrs": {}, "host": host, "device": device}


def window():
    """Two steps of one block each: the block [0, 100) ms on the card
    holds self_attn [10, 40) and ffn [60, 80); the solver after it. The
    host issues each span 5 ms before the card runs it."""
    out_spans, events = [], []
    for k, t in enumerate((0, 200)):
        def at(a, b):
            return ((t + a - 5) * MS, (t + b - 5) * MS), ((t + a) * MS,
                                                          (t + b) * MS)
        for name, (a, b) in (("block", (0, 100)), ("self_attn", (10, 40)),
                             ("ffn", (60, 80)), ("solver", (110, 120))):
            host, dev = at(a, b)
            out_spans.append(sp(name, host, dev, id_=10 * k + len(out_spans)))
        events += [(name, (t + a) * MS, d * MS) for name, a, d in (
            ("elementwise_kernel", 2, 6),          # block: a LayerNorm
            ("cutlass_gemm_q", 10, 5),             # self_attn: GEMM
            ("elementwise_kernel", 15, 4),         # self_attn: RMSNorm
            ("flash_fwd_kernel", 20, 15),          # self_attn: K1
            ("elementwise_kernel", 45, 10),        # block: gate, residual
            ("nvjet_gemm", 60, 8),                 # ffn: GEMM
            ("vectorized_gelu", 69, 3),            # ffn: GELU
            ("nvjet_gemm", 72, 7),                 # ffn: GEMM
            ("elementwise_kernel", 110, 8),        # solver
            ("elementwise_kernel", 150, 10))]      # no span
    return out_spans, events


def record(events, unit="cfg_step", units=2):
    return {"unit": unit, "units": units, "events": events}


def test_device_time_partitions_by_innermost_span():
    got_spans, events = window()
    att = spans.attribute(got_spans, events)
    dev = {k: round(v * 1e3, 6) for k, v in att["device_s"].items()}
    assert dev == {("block", "other"): 32.0, ("self_attn", "GEMM"): 10.0,
                   ("self_attn", "other"): 8.0, ("self_attn", "K1"): 30.0,
                   ("ffn", "GEMM"): 30.0, ("ffn", "other"): 6.0,
                   ("solver", "other"): 16.0, (None, "other"): 20.0}
    # the parts of "other" add up to the trace's own group total
    other = sum(v for (_, g), v in att["device_s"].items() if g == "other")
    assert other == pytest.approx(harness.tr.group_seconds(events)["other"])
    rec = record(events)
    rec[spans.MEMO] = att
    assert spans.device_ms_per_unit(
        rec, "cfg_step", ("self_attn", "cross_attn"),
        skip=("K1", "GEMM")) == pytest.approx(4.0)
    assert spans.device_ms_per_unit(rec, "cfg_step", ("ffn",),
                                    skip=("GEMM",)) == pytest.approx(3.0)
    assert spans.device_ms_per_unit(rec, "cfg_step", ("block",),
                                    skip=("K1", "GEMM")) == pytest.approx(16)
    assert spans.device_ms_per_unit(rec, "request", ("block",)) is None


def test_idle_goes_to_the_innermost_open_host_span():
    """Each gap between busy stretches is cut where host spans open and
    close; time in no span goes to None."""
    got_spans, events = window()
    att = spans.attribute(got_spans, events)
    idle = {k: round(v * 1e3, 6) for k, v in att["idle_s"].items()}
    # step 1's gaps [8, 10) [19, 20) [35, 45) [55, 60) [68, 69)
    # [79, 110) [118, 150) [160, 202); step 2's the same but the last.
    # Host spans run 5 ms early: block [-5, 95), self_attn [5, 35), ffn
    # [55, 75), solver [105, 115), and the next block from 195
    assert idle == {"self_attn": 2 * 3.0, "block": 2 * (10 + 16) + 7.0,
                    "ffn": 2 * 6.0, "solver": 2 * 5.0,
                    None: 2 * (10 + 32) + 35.0}
    assert sum(idle.values()) == pytest.approx(124 + 82)
    rec = record(events)
    rec[spans.MEMO] = att
    assert spans.idle_ms_per_unit(rec, "cfg_step") == pytest.approx(
        (206 - 119) / 2)


def test_no_recorder_or_no_spans_reads_nothing(monkeypatch):
    """Without a recorder (the parent of the recorder's change), with an
    empty one, or untraced, every span metric is left out of the line;
    the result is computed once per record."""
    _, events = window()
    names = ["attn_other_ms.step", "ffn_other_ms.step",
             "block_other_ms.step", "vae_other_ms.request",
             "host_wait_ms.request", "optimizer_ms.train",
             "host_wait_ms.train"]
    metrics = [{"name": n, "unit": "ms"} for n in names]
    monkeypatch.setitem(sys.modules, "omnihuman_tpu_torch.utils.spans", None)
    for unit in ("cfg_step", "request", "train_step"):
        assert harness.compute_metrics(metrics, record(events, unit)) == {}
    monkeypatch.undo()

    from omnihuman_tpu_torch.utils import spans as recorder
    recorder.clear()
    rec = record(events)
    assert harness.compute_metrics(metrics, rec) == {}
    assert rec[spans.MEMO] is None
    assert harness.compute_metrics(metrics, record(None)) == {}

    calls = []
    monkeypatch.setattr(spans, "_recorded",
                        lambda ev: calls.append(1) or window()[0])
    rec = record(events, "train_step", 1)
    first = spans.idle_ms_per_unit(rec, "train_step")
    assert first > 0 and spans.idle_ms_per_unit(rec, "train_step") == first
    assert calls == [1]
