"""The port's tools (ROADMAP item 20) on the CPU: `cli.generate` with
`--export_step`, `--profile` (its trace holds the port's spans) and
`--use_prompt_extend`; the device helpers of utils/logging.py against
JAX's; utils/viz.py and
`apt/generate.visualize_and_save_batch_with_vae` at tiny sizes.

- `debug_tensor` returns JAX's dict: exact but for the std, 1e-6
  relative (one fp32 reduction in another order);
  `detailed_model_output_visualization` JAX's statistics (the same numpy
  arithmetic: exact);
- `anomaly_detection` raises FloatingPointError at a forward op that makes
  a NaN, as `jax_debug_nans` does (JAX's own context manager reads the
  flag through an API this JAX version removed, so it is not called
  here), and at the backward's NaN (the same check on the CPU, where
  autograd runs in the caller's thread; `set_detect_anomaly` where it
  runs on device threads); clean ops and uninitialised allocations pass.
"""

import json
import logging
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnihuman_tpu.utils import logging as jlog
from omnihuman_tpu_torch.cli.generate import main
from omnihuman_tpu_torch.configs import TINY_TEST
from omnihuman_tpu_torch.utils import logging as plog
from omnihuman_tpu_torch.utils import viz as pviz

torch.set_num_threads(1)
TINY = ["--task", "tiny-test", "--size", "64*64", "--frame_num", "5",
        "--sample_steps", "2", "--base_seed", "0", "--device", "cpu"]


def test_cli_profile_and_prompt_extend_on_cpu(tmp_path, monkeypatch,
                                              caplog):
    monkeypatch.delenv("DASH_API_KEY", raising=False)
    trace_dir = tmp_path / "trace"
    with caplog.at_level(logging.INFO, logger="omnihuman_tpu_torch"):
        out = main(TINY + ["--profile", str(trace_dir),
                           "--use_prompt_extend", "--prompt", "a fox",
                           "--save_file", str(tmp_path / "clip.mp4")])
    assert os.path.exists(out)
    trace = json.load(open(trace_dir / "trace.json"))
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("omnihuman_tpu_torch::flash_fwd" in n for n in names)
    spans = {e["name"] for e in trace["traceEvents"] if e.get("cat") == "span"}
    assert {"request", "step", "cfg", "block", "self_attn",
            "vae_decode"} <= spans
    assert ("prompt extended (Qwen weights unavailable; template-expanded "
            "(offline fallback)): a fox." in caplog.text)


def test_debug_tensor_equals_jax():
    x = (np.arange(24, dtype=np.float32).reshape(2, 3, 4) - 8.0) / 4.0
    got = plog.debug_tensor(torch.from_numpy(x), "x")
    want = jlog.debug_tensor(jnp.asarray(x), "x")
    assert list(got) == list(want)
    assert got.pop("std") == pytest.approx(want.pop("std"), rel=1e-6)
    assert got == want
    bad = torch.tensor([1.0, float("nan"), float("inf")]).to(torch.bfloat16)
    info = plog.debug_tensor(bad, "bad")
    assert info["has_nan"] and info["has_inf"] and info["dtype"] == "bfloat16"


def test_anomaly_detection_raises_on_a_forward_nan():
    x = torch.tensor([1.0, 2.0])
    with plog.anomaly_detection():
        buf = torch.empty(1000)          # uninitialised: not a result
        buf[:2] = x * 2
        y = torch.softmax(x, 0)
        with pytest.raises(FloatingPointError, match="log"):
            torch.log(y - 1.0)
    assert torch.isnan(torch.log(y - 1.0)).all()      # trap off again


def test_anomaly_detection_checks_the_backward():
    class NaNGrad(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x * 1.0

        @staticmethod
        def backward(ctx, g):
            return g * float("nan")

    x = torch.ones(3, requires_grad=True)
    y = NaNGrad.apply(x).sum()
    with plog.anomaly_detection():
        with pytest.raises((FloatingPointError, RuntimeError),
                           match="(?i)nan"):
            y.backward()


def test_log_device_memory_needs_a_card():
    if torch.cuda.is_available():
        stats = plog.log_device_memory("t")
        assert len(stats) == torch.cuda.device_count()
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            plog.log_device_memory("t")


def test_visualization_hook_captures_taps_and_plots(tmp_path):
    from omnihuman_tpu_torch.models.wan_dit import build_wan_model
    from omnihuman_tpu_torch.ops.rope import rope_angles_3d
    model = build_wan_model(TINY_TEST.model, "cpu", torch.float32, seed=0)
    g = torch.Generator().manual_seed(0)
    x = torch.randn((1, 16, 2, 4, 6), generator=g)
    ctx = torch.randn((1, 16, 32), generator=g)
    sin, cos = rope_angles_3d((2, 2, 3), 16, seq_len=12)
    hook = pviz.VisualizationHook(str(tmp_path / "viz"))
    taps = hook.capture(model, x, torch.tensor([500.0]), ctx, seq_len=12,
                        rope_sin=sin, rope_cos=cos)
    assert sorted(taps) == [0, 1] and taps[0].shape == (1, 12, 64)
    assert taps[1].dtype == np.float32 and np.isfinite(taps[1]).all()
    for p in (hook.plot_layer_stats(taps),
              hook.plot_attention_token_norm(taps, 1)):
        assert os.path.getsize(p) > 0


def test_visualize_teacher_batch_with_vae(tmp_path):
    from omnihuman_tpu_torch.apt.generate import (
        visualize_and_save_batch_with_vae)
    from omnihuman_tpu_torch.pipelines.text2video import WanT2V
    pipe = WanT2V(TINY_TEST, device="cpu", param_dtype=torch.float32)
    rng = np.random.default_rng(1)
    data = {"noise": rng.normal(size=(3, 16, 1, 4, 4)).astype(np.float32),
            "v_teacher": rng.normal(size=(3, 16, 1, 4, 4)
                                    ).astype(np.float32)}
    out = visualize_and_save_batch_with_vae(
        data, pipe, str(tmp_path / "teacher.png"), num_samples=2)
    assert os.path.getsize(out) > 0
