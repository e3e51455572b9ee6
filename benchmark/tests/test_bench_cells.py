"""The harness on the CPU at the port's tiny sizes: a cell made of files
alone loads and runs with no code edit, the window's arithmetic holds on
a fake clock, the program agrees with the reference, and the control and
each fault the cells can have come out not correct.

The limits here are the tiny sizes' own; the cells' limits, set from
readings at their full sizes on the card, are in `benchmark/limits/`."""

from __future__ import annotations

import json
import os

import pytest
import torch

from benchmark import harness, readers
from benchmark.tests.tiny import tiny_cell

HERE = os.path.dirname(os.path.abspath(__file__))
CFG_LIMITS = {"limits": {"dit_first": 0.02, "dit_last": 0.02,
                         "guide_solver": 1e-5}}
ONE_LIMITS = {"limits": {"context": 0.03, "latent": 0.03, "video": 0.1}}
SEED = 2 ** 31 + 77          # seeds reach past 32 signed bits


def caught(cell) -> bool:
    """A fault is caught where some run of three seeds is not correct:
    each check compares a row or clip drawn from its seed."""
    return not all(harness.run_cell(cell, SEED + i, 0.2, False,
                                    "cpu")["correct"] for i in range(3))


def one_step_traffic():
    path = os.path.join(os.path.dirname(HERE), "traffic",
                        "one-step-2x81f.json")
    with open(path) as f:
        tf = json.load(f)
    tf.update(size=[64, 64], frame_num=5, prompt_tokens=[4, 12],
              warmup_tokens=[5, 10])
    return tf


@pytest.fixture
def cfg_cell(tmp_path):
    return tiny_cell(tmp_path, limits=CFG_LIMITS)


@pytest.fixture
def one_cell(tmp_path):
    return tiny_cell(tmp_path, name="tiny.one-step",
                     traffic=one_step_traffic(), limits=ONE_LIMITS)


def test_timed_window_on_a_fake_clock():
    """Units are issued until the seconds have passed; the window ends
    with the unit that crossed them."""
    now = [100.0]

    def clock():
        return now[0]

    def unit(i):
        now[0] += 0.75
        return {"flops": 1.0}

    recs, window = harness.timed_window(unit, 2.0, clock)
    assert len(recs) == 3 and window == pytest.approx(2.25)
    rec = {"unit": "cfg_step", "units": 3, "window_s": window}
    assert readers.per_unit(rec, "cfg_step") == pytest.approx(0.75)
    assert readers.per_unit(rec, "request") is None


def test_a_cell_of_files_alone_runs_and_is_correct(cfg_cell):
    out = harness.run_cell(cfg_cell, SEED, 0.2, False, "cpu")
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"setup_s", "step_s"}   # no peak on CPU
    assert list(out)[-1] == "checks"
    assert out["record"]["flops"] > 0 and out["record"]["bounds_s"]["K1"] > 0


def test_cfg_step_control_is_not_correct(cfg_cell):
    out = harness.run_cell(cfg_cell, SEED, 0.2, False, "cpu", control=True)
    assert not out["correct"], out["checks"]


def test_same_seed_same_inputs(cfg_cell):
    a = harness.run_cell(cfg_cell, 5, 0.05, False, "cpu")
    b = harness.run_cell(cfg_cell, 5, 0.05, False, "cpu")
    assert a["checks"]["dit_first"] == b["checks"]["dit_first"]


def _solver_unchanged(monkeypatch):
    from omnihuman_tpu_torch.samplers import fm_solvers
    monkeypatch.setattr(fm_solvers._PlanSolver, "step",
                        lambda self, state, v, sample, i: (sample, state))


def _half_batch(monkeypatch):
    """The uncond half of the fused batch left out: its context replaced
    by the cond half's, so the guidance sees one half twice."""
    from omnihuman_tpu_torch.pipelines import text2video
    real = text2video.cfg_model_step

    def fault(model, x, t, ctx2, *a, **kw):
        return real(model, x, t, torch.cat([ctx2[:1], ctx2[:1]]), *a, **kw)
    monkeypatch.setattr(text2video, "cfg_model_step", fault)


def _altered_velocity(monkeypatch):
    """One latent frame of the DiT's answer altered where it is made."""
    from omnihuman_tpu_torch.models import wan_dit
    real = wan_dit.WanModel.forward

    def fault(self, *a, **kw):
        v = real(self, *a, **kw)
        v = v.clone()
        v[:, :, -1] += 1.0
        return v
    monkeypatch.setattr(wan_dit.WanModel, "forward", fault)


@pytest.mark.parametrize("fault", [_solver_unchanged, _half_batch,
                                   _altered_velocity])
def test_cfg_step_faults_are_not_correct(cfg_cell, monkeypatch, fault):
    fault(monkeypatch)
    assert caught(cfg_cell)


def test_one_step_cell_runs_and_is_correct(one_cell):
    out = harness.run_cell(one_cell, SEED, 0.2, False, "cpu")
    assert out["correct"], out["checks"]
    stages = out["record"]["stages"]
    assert set(stages) == {"text_encode_s", "dit_s", "vae_decode_s"}
    assert set(out["record"]["bounds_s"]) == {"K1", "K3", "K4"}


def test_one_step_control_is_not_correct(one_cell):
    out = harness.run_cell(one_cell, SEED, 0.2, False, "cpu", control=True)
    assert not out["correct"], out["checks"]


def _latents_unchanged(monkeypatch):
    """The one step returns its input: the noise is decoded."""
    from omnihuman_tpu_torch.pipelines import wan_inference
    real = wan_inference.one_step_latents

    def fault(model, noise, *a, **kw):
        real(model, noise, *a, **kw)
        return noise
    monkeypatch.setattr(wan_inference, "one_step_latents", fault)


def _half_batch_decoded(monkeypatch):
    """Half of the batch left out of the decode: clip 0 given twice."""
    from omnihuman_tpu_torch.pipelines import wan_inference
    real = wan_inference.vae_decode

    def fault(vae, z, *a, **kw):
        return real(vae, torch.cat([z[:1], z[:1]]), *a, **kw)
    monkeypatch.setattr(wan_inference, "vae_decode", fault)


def _altered_frame(monkeypatch):
    """One decoded frame altered where it is made."""
    from omnihuman_tpu_torch.pipelines import wan_inference
    real = wan_inference.vae_decode

    def fault(vae, z, *a, **kw):
        video = real(vae, z, *a, **kw).clone()
        video[:, :, -1] = -video[:, :, -1]
        return video
    monkeypatch.setattr(wan_inference, "vae_decode", fault)


@pytest.mark.parametrize("fault", [_latents_unchanged, _half_batch_decoded,
                                   _altered_frame])
def test_one_step_faults_are_not_correct(one_cell, monkeypatch, fault):
    fault(monkeypatch)
    assert caught(one_cell)


def test_metrics_are_read_by_name_and_silent_without_a_trace(cfg_cell):
    rec = {"unit": "cfg_step", "units": 2, "window_s": 3.0, "setup_s": 9.0,
           "peak_bytes": 2 ** 31, "flops": 1e15, "bounds_s": {"K1": 0.5},
           "stages": {}, "events": None}
    e2e = harness.compute_metrics(cfg_cell.end_to_end, rec)
    assert e2e["step_s"]["value"] == pytest.approx(1.5)
    assert e2e["peak_mem_gib"]["value"] == pytest.approx(2.0)
    assert harness.compute_metrics(cfg_cell.per_layer, rec) == {}
    events = [("flash_fwd_kernel<128>", 0, 400_000_000),
              ("nvjet_tst_gemm", 500_000_000, 1_000_000_000),
              ("elementwise_kernel", 1_400_000_000, 1_000_000_000)]
    rec.update(events=events, window_s=3.0)
    rec["group_s"] = harness.tr.group_seconds(events)
    rec["busy_s"] = harness.tr.busy_seconds(events)
    pl = harness.compute_metrics(cfg_cell.per_layer, rec)
    assert pl["mfu.step"]["value"] == pytest.approx(
        100 * 1e15 / (3.0 * 989e12))
    assert rec["busy_s"] == pytest.approx(2.3)   # the two overlaps once
    assert readers.roofline(rec, "cfg_step", "K1") == pytest.approx(125.0)
    assert readers.idle_share(rec, "cfg_step") == pytest.approx(
        100 * (1 - 2.3 / 3.0))
    gaps = harness.tr.idle_gaps(events)
    assert gaps[0][1] == pytest.approx(0.1)


# at the tiny sizes only the loss separates the program from the control:
# the gradient's and the change's leaf gaps swing on leaves of 64 channels
DISTILL_LIMITS = {"limits": {"loss": 2e-3, "grad": 0.5, "change": 0.5}}


@pytest.fixture
def distill_cell(tmp_path):
    path = os.path.join(os.path.dirname(HERE), "traffic", "distill-81f.json")
    with open(path) as f:
        tf = json.load(f)
    tf.update(size=[64, 64], frame_num=5)
    return tiny_cell(tmp_path, name="tiny.distill", traffic=tf,
                     limits=DISTILL_LIMITS)


def test_distill_cell_runs_and_is_correct(distill_cell):
    out = harness.run_cell(distill_cell, SEED, 0.2, True, "cpu")
    assert out["correct"], out["checks"]
    assert out["record"]["stages"]["optimizer_s"]
    assert set(out["record"]["bounds_s"]) == {"K1", "K2"}


def test_distill_control_is_not_correct(distill_cell):
    out = harness.run_cell(distill_cell, SEED, 0.2, False, "cpu",
                           control=True)
    assert not out["correct"], out["checks"]


def _optimizer_still(monkeypatch):
    """A step that leaves the parameters as they were."""
    from omnihuman_tpu_torch.apt import optim
    monkeypatch.setattr(optim.AdamW, "step",
                        lambda self, params, grads, state: None)


@pytest.mark.parametrize("fault", [_optimizer_still, _altered_velocity])
def test_distill_faults_are_not_correct(distill_cell, monkeypatch, fault):
    fault(monkeypatch)
    assert caught(distill_cell)


def _tiny_i2v():
    import dataclasses
    from omnihuman_tpu_torch.configs import TINY_TEST
    return dataclasses.replace(
        TINY_TEST, name="tiny-i2v",
        model=dataclasses.replace(TINY_TEST.model, model_type="i2v",
                                  in_dim=36, clip_embed_dim=32,
                                  clip_tokens=9))


@pytest.mark.parametrize("registry", ["tiny-test-hd128", "tiny-i2v"])
def test_cfg_step_agrees_at_other_tiny_models(tmp_path, monkeypatch,
                                              registry):
    """The reference against the port with the kernel's head_dim 128 and
    with the i2v model (image tokens, `y`), as test-only registry
    entries."""
    from omnihuman_tpu_torch import configs
    from benchmark.tests.tiny import tiny_config
    cfg = (configs.TINY_TEST_HD128 if registry == "tiny-test-hd128"
           else _tiny_i2v())
    monkeypatch.setitem(configs.WAN_CONFIGS, registry, cfg)
    cell = tiny_cell(tmp_path, config=tiny_config(registry),
                     limits=CFG_LIMITS)
    out = harness.run_cell(cell, SEED, 0.2, False, "cpu")
    assert out["correct"], out["checks"]
    assert harness.run_cell(cell, SEED, 0.2, False, "cpu",
                            control=True)["correct"] is False
