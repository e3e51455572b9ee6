"""The port's OmniHuman forward and window step against the benchmark's
plain fp32 reference (`benchmark/reference/omni.py`, `dpmpp.py`), on the
CPU at a tiny size, on seeded random fp32 weights: every leaf drawn by
`benchmark/weights.py`, so the adapters' `o` and gate and `pose_proj`
are non-zero (the reference init zeroes them, which would make audio and
pose no-ops).

Tolerances, relative L2 against the reference: the forward 1e-4 (fp32
both sides; the matmuls, convs and attention sum in other orders, the
port's RoPE tables are fp32 where the reference rotates in float64: each
~1e-6). The step, against the size of its update: 1e-4 at step 0; 2e-3 at
step 1, where the program departs from the published DPM-Solver++ by
design (`dpmpp.py`'s note: its lambda at sigma = 1 is -690.8, not -inf,
which leaves ~3e-4 of the update at 25 steps). Leaving out the audio
adapter, the pose delta or the RoPE time offset moves the forward by far
more (the faults below)."""

import numpy as np
import pytest
import torch

from benchmark import weights
from benchmark.reference import dpmpp as ref_dpm
from benchmark.reference import omni as ref_omni
from benchmark.reference.common import rel_l2
from omnihuman_tpu_torch.configs.wan import DTypePolicy, WanModelConfig
from omnihuman_tpu_torch.omni import model as omni_model
from omnihuman_tpu_torch.omni.model import (
    OmniModel, OmniModelConfig, omni_model_forward)
from omnihuman_tpu_torch.pipelines import omni as omni_pipe
from omnihuman_tpu_torch.samplers.fm_solvers import get_solver

torch.set_num_threads(1)

BASE = WanModelConfig(dim=32, ffn_dim=64, num_heads=4, num_layers=2,
                      freq_dim=16, text_dim=24, text_len=8)
CFG = OmniModelConfig(base=BASE, audio_dim=20, num_keypoints=8,
                      num_frames=4, pose_hidden=(16, 16))
M = {"dim": 32, "num_heads": 4, "num_layers": 2, "freq_dim": 16,
     "patch_size": [1, 2, 2], "eps": 1e-6, "out_dim": 16,
     "model_type": "t2v"}
F32 = DTypePolicy(compute=torch.float32)
C, F, H, W = 16, 3, 8, 8
LENS = (6, 8)
FWD_TOL = 1e-4
STEPS, CFG_SCALE = 25, 7.5


@pytest.fixture(scope="module")
def omni():
    with torch.device("meta"):
        model = OmniModel(CFG)
    sd = weights.make_weights(weights.shapes_of(model), 11, "cpu",
                              torch.float32)
    model = weights.load_into(model, sd).eval().requires_grad_(False)
    gen = torch.Generator().manual_seed(3)

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen) * scale

    inputs = dict(
        x=rnd(1, C, F, H, W), ctx=rnd(1, BASE.text_len, BASE.text_dim),
        ctx_null=rnd(1, BASE.text_len, BASE.text_dim),
        audio=rnd(1, F, CFG.audio_dim),
        pose=rnd(1, CFG.num_keypoints, F, 2 * H, 2 * W).abs_(),
        ref=rnd(1, C, 1, H, W), motion=rnd(1, C, 2, H, W))
    return model, sd, inputs


def _port(model, inp, t, cond=True, **kw):
    """The port's velocity: the cond forward (audio, pose, reference, 2
    motion frames; the packed 96 tokens padded to 98 by seq_align 7) or
    the uncond one (the negative prompt alone)."""
    tb = torch.tensor([t])
    if cond:
        return omni_model_forward(
            model, inp["x"], tb, inp["ctx"], audio=inp["audio"],
            pose=inp["pose"], ref_latent=inp["ref"],
            motion_latent=inp["motion"],
            context_lens=torch.tensor(LENS[:1]), policy=F32, remat=False,
            seq_align=7, **kw)[0]
    return omni_model_forward(model, inp["x"], tb, inp["ctx_null"],
                              context_lens=torch.tensor(LENS[1:]),
                              policy=F32, remat=False, **kw)[0]


def _ref(sd, inp, t, cond=True, x=None):
    x = inp["x"] if x is None else x
    if cond:
        return ref_omni.omni_forward(
            sd, M, x[0], t, inp["ctx"][0], LENS[0], audio=inp["audio"][0],
            pose=inp["pose"][0], ref_latent=inp["ref"][0],
            motion_latent=inp["motion"][0])
    return ref_omni.omni_forward(sd, M, x[0], t, inp["ctx_null"][0],
                                 LENS[1])


@pytest.mark.parametrize("cond", [True, False], ids=["cond", "uncond"])
def test_forward_matches_the_reference(omni, cond):
    model, sd, inp = omni
    got = _port(model, inp, 731.0, cond)
    assert got.shape == (16, F, H, W)
    assert rel_l2(got, _ref(sd, inp, 731.0, cond)) < FWD_TOL


def _no_audio(monkeypatch, model, inp):
    return _port(model, dict(inp, audio=None), 731.0)


def _no_pose(monkeypatch, model, inp):
    return _port(model, dict(inp, pose=None), 731.0)


def _no_time_offset(monkeypatch, model, inp):
    real = omni_model.rope_angles_3d
    monkeypatch.setattr(omni_model, "rope_angles_3d",
                        lambda *a, time_offset=0, **kw: real(*a, **kw))
    monkeypatch.setattr(model, "rope_tables", {})   # tables built anew
    return _port(model, inp, 731.0)


@pytest.mark.parametrize("fault", [_no_audio, _no_pose, _no_time_offset],
                         ids=["audio", "pose", "rope_offset"])
def test_each_condition_moves_the_forward_past_the_tolerance(
        omni, monkeypatch, fault):
    """The port with one part of the mathematics left out against the
    whole reference: off by far more than the tolerance."""
    model, sd, inp = omni
    assert rel_l2(fault(monkeypatch, model, inp),
                  _ref(sd, inp, 731.0)) > 100 * FWD_TOL


def test_rope_tables_are_built_once_per_geometry(omni, monkeypatch):
    """The packed RoPE tables come from the model's store after the first
    forward of a geometry: later forwards build none, and give the same
    velocity."""
    model, _, inp = omni
    monkeypatch.setattr(model, "rope_tables", {})
    first = _port(model, inp, 731.0)
    built = []
    real = omni_model.rope_angles_3d
    monkeypatch.setattr(omni_model, "rope_angles_3d",
                        lambda *a, **kw: built.append(a) or real(*a, **kw))
    assert torch.equal(_port(model, inp, 731.0), first) and not built
    _port(model, inp, 731.0, cond=False)
    assert len(built) == 1 and len(model.rope_tables) == 2


def _step_kw(inp):
    return dict(cfg_scale=CFG_SCALE, policy=F32, audio=inp["audio"],
                pose=inp["pose"], ref_latent=inp["ref"],
                motion_latent=inp["motion"],
                context_lens=torch.tensor(LENS[:1]),
                null_lens=torch.tensor(LENS[1:]))


def test_cfg_step_matches_the_reference_at_steps_0_and_1(omni):
    """Two steps of `omni_cfg_step` from the noise: each against the
    reference's forwards, annealed guidance and DPM++ update from the
    step's input and the program's own x0 history."""
    model, sd, inp = omni
    sol = get_solver("dpm++", STEPS, 1.0)
    ts = ref_dpm.timesteps(STEPS, 1.0)
    x, state = inp["x"], sol.init_state(inp["x"])
    for i, tol in ((0, 1e-4), (1, 2e-3)):
        x_prev, x0_prev = x, state["hist"][-1]
        x, state = omni_pipe.omni_cfg_step(model, x, state, i, sol,
                                           inp["ctx"], inp["ctx_null"],
                                           **_step_kw(inp))
        t = float(np.float32(ts[i]))
        v = ref_dpm.guide(_ref(sd, inp, t, True, x_prev),
                          _ref(sd, inp, t, False, x_prev),
                          ref_dpm.cfg_scale(i, STEPS, CFG_SCALE))
        want = ref_dpm.step(i, STEPS, 1.0, x_prev[0], v, x0_prev[0])
        assert rel_l2(x[0], want, want - x_prev[0].double()) < tol, i


def test_omni_generate_is_a_loop_of_cfg_steps(omni):
    """`omni_generate` runs every step through `omni_cfg_step`: equal bit
    for bit to the loop written out."""
    model, _, inp = omni
    kw = _step_kw(inp)
    got = omni_pipe.omni_generate(model, inp["x"], inp["ctx"],
                                  inp["ctx_null"], sampling_steps=3,
                                  shift=1.0, **kw)
    sol = get_solver("dpm++", 3, 1.0)
    x, state = inp["x"], sol.init_state(inp["x"])
    for i in range(3):
        x, state = omni_pipe.omni_cfg_step(model, x, state, i, sol,
                                           inp["ctx"], inp["ctx_null"], **kw)
    assert torch.equal(got, x)
