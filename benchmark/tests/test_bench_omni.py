"""The `omni.window-step` cell on the CPU at the port's tiny sizes: a cell
made of files alone runs and agrees with the reference, the control and
four planted faults come out not correct, `flops_omni.py` counts what a
hand count gives, the cell's configuration file agrees with the port,
and nothing the cell loads is JAX or the JAX package.

Each run here is a window of two steps, 0 and 1, on a clock that counts
units: at the tiny sizes the bf16 program's gaps swing from step to step
(0.0055-0.016 over a schedule) as the int8 control's do (0.012-0.047),
so the steps compared are fixed. The tiny limits are the tiny sizes' own
(readings at steps 0 and 1 over three seeds: program <= 0.0086 on the
velocities and 5.6e-4 on the stage, at step 1, where the program departs
from the published solver by design; the control >= 0.014 and 0.012);
the cell's limits, set from readings at its full size on the card, are
in `benchmark/limits/`."""

from __future__ import annotations

import itertools
import json
import os
import subprocess
import sys

import pytest

from benchmark import flops, flops_omni, harness
from benchmark.tests.tiny import tiny_cell, tiny_config

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
LIMITS = {"limits": {"dit_first": 0.011, "dit_last": 0.011,
                     "uncond_first": 0.011, "guide_solver": 3e-3}}
SEED = 2 ** 31 + 77          # seeds reach past 32 signed bits
OMNI = {"audio_dim": 1024, "num_keypoints": 308, "num_frames": 4,
        "pose_hidden": [128, 256]}


def omni_traffic():
    with open(os.path.join(BENCH, "traffic",
                           "omni-window-step-480p-13f.json")) as f:
        tf = json.load(f)
    tf.update(size=[64, 64], frame_num=9, prompt_tokens=[3, 12])
    return tf


@pytest.fixture
def cell(tmp_path):
    return tiny_cell(tmp_path, name="tiny.omni", traffic=omni_traffic(),
                     limits=LIMITS, config=dict(tiny_config(), omni=OMNI))


def run(cell, seed: int, control: bool = False) -> dict:
    """Two units: the clock reads one more second after each."""
    clock = itertools.count()
    return harness.run_cell(cell, seed, 2.0, False, "cpu",
                            clock=lambda: float(next(clock)),
                            control=control)


def caught(cell) -> bool:
    return not all(run(cell, SEED + i)["correct"] for i in range(3))


def test_omni_cell_runs_and_is_correct(cell):
    out = run(cell, SEED)
    assert out["attempted"] == 2
    assert out["correct"], out["checks"]
    assert set(out["checks"]) == {"dit_first", "dit_last", "uncond_first",
                                  "guide_solver"}
    rec = out["record"]
    assert rec["unit"] == "cfg_step" and rec["flops"] > 0
    assert rec["bounds_s"]["K1"] > 0


def test_omni_control_is_not_correct(cell):
    out = run(cell, SEED, control=True)
    assert not out["correct"], out["checks"]


def _dropping(key):
    def fault(monkeypatch):
        from omnihuman_tpu_torch.pipelines import omni
        real = omni.omni_model_forward

        def forward(*a, **kw):
            kw.pop(key, None)
            return real(*a, **kw)
        monkeypatch.setattr(omni, "omni_model_forward", forward)
    return fault


def _motion_at_the_video_offset(monkeypatch):
    """The motion frames' RoPE times those of the video's first frames
    (offset 3 with 2 motion frames, where they belong at 1)."""
    from omnihuman_tpu_torch.omni import model
    real = model.rope_angles_3d

    def angles(*a, time_offset=0, **kw):
        return real(*a, time_offset=3 if time_offset == 1 else time_offset,
                    **kw)
    monkeypatch.setattr(model, "rope_angles_3d", angles)


@pytest.mark.parametrize("fault", [
    _dropping("audio"), _dropping("pose"), _dropping("ref_latent"),
    _motion_at_the_video_offset],
    ids=["no_audio", "no_pose", "no_reference", "motion_offset"])
def test_omni_faults_are_not_correct(cell, monkeypatch, fault):
    fault(monkeypatch)
    assert caught(cell)


def test_omni_flops_match_a_hand_count():
    """One window step at the tiny sizes: 3 latent frames of 8 x 8 (48
    video tokens), 2 motion frames and the reference (32 more), 3 audio
    tokens, heatmaps [308, 3, 16, 16], text of 5 and 9 tokens."""
    m = tiny_config()["model"]
    d, ff, layers = m["dim"], m["ffn_dim"], m["num_layers"]
    nv, nx, na, lc, lu = 48, 32, 3, 5, 9
    n = nv + nx

    def dit(tokens, text, audio):
        per_layer = (2 * tokens * 4 * d * d          # self q, k, v, o
                     + 2 * tokens * 2 * d * d        # cross q, o
                     + 2 * text * 2 * d * d          # cross k, v
                     + 2 * tokens * 2 * d * ff       # FFN
                     + 4 * d * tokens * tokens       # self-attention
                     + 4 * d * tokens * text)        # cross-attention
        if audio:
            per_layer += (2 * tokens * 2 * d * d     # audio q, o
                          + 2 * audio * 2 * d * d    # audio k, v
                          + 4 * d * tokens * audio)  # audio attention
        return (layers * per_layer
                + 2 * tokens * (4 * m["in_dim"] * d + d * 4 * m["out_dim"])
                + 2 * text * (m["text_dim"] * d + d * d)
                + 2 * (m["freq_dim"] * d + d * d + d * 6 * d))

    guider = (2 * 27 * 308 * 128 * 3 * 16 * 16
              + 2 * 27 * 128 * 256 * 3 * 8 * 8
              + 2 * 27 * 256 * (d // 4) * 3 * 4 * 4
              + 2 * 3 * 4 * 4 * (d // 4 * 4) * d)
    audio = 2 * na * (1024 * d + d * d + 2 * d * d)
    hand = dit(n, lc, na) + guider + audio + dit(nv, lu, 0)
    got = flops_omni.step_flops(OMNI, m, nv, nx, [lc, lu], na, (3, 16, 16))
    assert got == pytest.approx(hand)

    heads, hd = m["num_heads"], d // m["num_heads"]
    k1 = layers * sum(flops.attention_bound(1, lq, heads, hd, [k])[0]
                      for lq, k in ((80, n), (80, lc), (80, na), (48, nv),
                                    (48, lu)))
    assert flops_omni.step_k1_bound_s(m, (80, 48), nv, nx, [lc, lu],
                                      na) == pytest.approx(k1)


def test_omni_step_flops_at_the_cell():
    """~3.1e14 FLOP a window step at 480x832 (the prediction's count): a
    cond forward over 24,960 packed tokens, an uncond one over 20,280."""
    with open(os.path.join(BENCH, "configs", "omnihuman-1.3B.json")) as f:
        conf = json.load(f)
    fl = flops_omni.step_flops(conf["omni"], conf["model"], 20280, 4680,
                               [128, 128], 13, (13, 120, 208))
    assert 2.9e14 < fl < 3.3e14


def test_the_cell_file_agrees_with_the_port():
    """The configuration's sizes are the port's registry entry and the
    OmniModelConfig the pipeline serves; a changed size raises."""
    from benchmark.drivers import common, omni_window_step
    cell = harness.load_cell("omni.window-step")
    cfg = common.port_config(cell.config)
    ocfg = omni_window_step.omni_config(cell.config, cfg.model)
    assert ocfg.num_frames == 13 and ocfg.audio_dim == 1024
    bad = dict(cell.config, omni=dict(cell.config["omni"], num_keypoints=17))
    with pytest.raises(ValueError, match="num_keypoints"):
        omni_window_step.omni_config(bad, cfg.model)


def test_the_omni_cell_loads_no_jax():
    code = ("import sys; sys.path.insert(0, %r); "
            "from benchmark import harness; "
            "import benchmark.drivers.omni_window_step, "
            "benchmark.reference.omni, benchmark.reference.dpmpp; "
            "import omnihuman_tpu_torch.pipelines.omni, "
            "omnihuman_tpu_torch.native; "
            "print(harness.forbidden_modules())" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
