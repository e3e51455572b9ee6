"""cli.generate --export_step on the CPU and the visualisation's
statistics: the slow cases of tests/test_torch_tools.py (whose helpers
they use), in a file of their own so that a `--dist loadfile` run
schedules them with the files of few tests, beside the longest ones,
instead of before them."""

import os

import numpy as np
import pytest
import torch

from omnihuman_tpu.utils import viz as jviz
from omnihuman_tpu_torch.cli.generate import main
from omnihuman_tpu_torch.utils import viz as pviz
from omnihuman_tpu_torch.utils.export import load_exported
# fixtures and helpers of the file these cases came from
from test_torch_tools import TINY


def test_cli_export_step_on_cpu(tmp_path):
    path = main(TINY + ["--export_step", str(tmp_path / "step.pt2")])
    step = load_exported(path)
    meta = step.metadata
    assert meta["platforms"] == ["cpu"] and meta["config"] == "tiny-test"
    assert meta["precision"] == "fast" and meta["frame_num"] == 5
    assert meta["out_avals"] == ["float32[1, 16, 2, 8, 8]"]
    with pytest.raises(SystemExit, match="JAX package"):
        main(TINY + ["--export_step", str(tmp_path / "tpu.pt2"),
                     "--export_platform", "tpu"])


def test_viz_output_stats_equal_jax_and_pngs_written(tmp_path):
    rng = np.random.default_rng(0)
    t = rng.normal(size=(1, 4, 3, 8, 10)).astype(np.float32)
    o = t + 0.1 * rng.normal(size=t.shape).astype(np.float32)
    got = pviz.detailed_model_output_visualization(
        torch.from_numpy(t), o, str(tmp_path / "p.png"), channel=1, frame=2)
    want = jviz.detailed_model_output_visualization(
        t, o, str(tmp_path / "j.png"), channel=1, frame=2)
    assert got == want
    assert os.path.getsize(tmp_path / "p.png") > 0
