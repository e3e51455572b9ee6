"""The exported serving steps (utils/export.py) against the eager port
step and JAX `_cfg_model_step` / `_i2v_cfg_model_step`: the slow cases of
tests/test_torch_export.py (whose helpers they use), in a file of their
own so that a `--dist loadfile` run schedules them with the files of few
tests, beside the longest ones, instead of before them."""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from omnihuman_tpu.configs.wan import TINY_TEST as JAX_TINY
from omnihuman_tpu.ops.rope import rope_angles_3d as jax_rope_angles
from omnihuman_tpu.pipelines.image2video import _i2v_cfg_model_step
from omnihuman_tpu.pipelines.text2video import _cfg_model_step
from omnihuman_tpu_torch.configs.wan import TINY_TEST
from omnihuman_tpu_torch.ops.quant import quantize_wan_model
from omnihuman_tpu_torch.pipelines.text2video import cfg_model_step
from omnihuman_tpu_torch.utils import export as ex
# fixtures and helpers of the file these cases came from
from test_torch_export import (
    _export_t2v, _inputs, _jax_params, _port, F32, FRAMES, GRID, I2V, JAX_F32,
    JAX_I2V_MODEL, SEQ, SIZE, t2v_params)


@pytest.mark.parametrize("precision,cfg_mode", [
    ("fast", "fused"), ("fast", "sequential"), ("int8", "fused")])
def test_exported_t2v_step_equals_eager(tmp_path, t2v_params, precision,
                                        cfg_mode):
    model = _port(t2v_params, TINY_TEST.model, torch.bfloat16)
    if precision == "int8":
        quantize_wan_model(model)
    path, step = _export_t2v(tmp_path, precision, precision=precision,
                             cfg_mode=cfg_mode, guide_scale=4.5)
    _, inp, sin, cos = _inputs(1, torch.bfloat16)
    got = step.call(model.state_dict(), inp["x"], inp["t"], inp["ctx2"],
                    sin, cos)
    policy = dataclasses.replace(TINY_TEST.policy, residual=torch.bfloat16)
    with torch.inference_mode():
        want = cfg_model_step(model, inp["x"], float(inp["t"]), inp["ctx2"],
                              sin, cos, policy=policy, seq_len=SEQ,
                              guide_scale=4.5, cfg_mode=cfg_mode)
    assert got.shape == (1, 16, 2, 4, 6) and got.dtype == torch.float32
    assert torch.isfinite(got).all() and got.abs().max() > 0
    assert torch.equal(got, want)
    meta = json.load(open(path + ".json"))
    assert meta["precision"] == precision and meta["cfg_mode"] == cfg_mode


def test_exported_t2v_step_matches_jax(tmp_path, t2v_params):
    cfg = dataclasses.replace(TINY_TEST, policy=F32)
    path = str(tmp_path / "ref.pt2")
    ex.export_t2v_denoise_step(cfg, SIZE, FRAMES, path, platforms=("cpu",),
                               precision="reference",
                               param_dtype=torch.float32)
    step = ex.load_exported(path)
    model = _port(t2v_params, TINY_TEST.model, torch.float32)
    raw, inp, sin, cos = _inputs(2, torch.float32)
    got = step.call(model.state_dict(), inp["x"], inp["t"], inp["ctx2"],
                    sin, cos).numpy()
    jsin, jcos = jax_rope_angles(GRID, 16, seq_len=SEQ)
    want = jax.jit(lambda p, x, t, c: _cfg_model_step(
        p, x, t, c, jsin, jcos, model_cfg=JAX_TINY.model, policy=JAX_F32,
        seq_len=SEQ, guide_scale=5.0))(
            t2v_params, raw["x"], raw["t"], raw["ctx2"])
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4)


def test_exported_i2v_step_round_trip(tmp_path):
    params = _jax_params(JAX_I2V_MODEL, 3)
    cfg = dataclasses.replace(I2V, policy=F32)
    path = str(tmp_path / "i2v.pt2")
    ex.export_i2v_denoise_step(cfg, SIZE, FRAMES, path, platforms=("cpu",),
                               precision="reference",
                               param_dtype=torch.float32)
    step = ex.load_exported(path)
    assert step.metadata["task"] == "i2v"
    model = _port(params, I2V.model, torch.float32)
    raw, inp, sin, cos = _inputs(4, torch.float32, i2v=True)
    args = (inp["x"], inp["t"], inp["ctx2"], inp["y2"], inp["clip2"], sin,
            cos)
    got = step.call(model.state_dict(), *args)
    with torch.inference_mode():
        want = cfg_model_step(model, inp["x"], inp["t"], inp["ctx2"], sin,
                              cos, policy=F32, seq_len=SEQ, guide_scale=5.0,
                              y=inp["y2"], clip_fea=inp["clip2"])
    assert torch.equal(got, want)
    jsin, jcos = jax_rope_angles(GRID, 16, seq_len=SEQ)
    jwant = jax.jit(lambda p, *a: _i2v_cfg_model_step(
        p, *a, jsin, jcos, model_cfg=JAX_I2V_MODEL, policy=JAX_F32,
        seq_len=SEQ, guide_scale=5.0))(
            params, raw["x"], raw["t"], raw["ctx2"], raw["y2"], raw["clip2"])
    np.testing.assert_allclose(got.numpy(), np.asarray(jwant), atol=1e-4)
