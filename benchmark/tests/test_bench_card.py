"""On the card: one short run of a cell through `run.py`, whose last line is
a result with every key it must hold. Marked `cuda`; skips without a card."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the benchmark runs only on the card")


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_run_prints_a_result(card, trace):
    out = subprocess.run(
        [sys.executable, os.path.join(BENCH, "run.py"), "--workload",
         "t2v-1.3B.cfg-step", "--seed", str(2 ** 31 + 3), "--seconds", "2",
         "--trace", str(trace)], capture_output=True, text=True,
        timeout=600, cwd=os.path.dirname(BENCH))
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True
    assert {"attempted", "failed", "metrics", "device"} <= set(res)
    assert list(res)[-1] == "checks"
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    if trace:
        assert res["device"]["busy_s"] > 0
        assert set(res["metrics"]) == {"k1_roofline.step", "mfu.step",
                                       "dit_other_ms.step",
                                       "idle_share.step"}
    else:
        assert set(res["metrics"]) == {"setup_s", "step_s", "peak_mem_gib"}
