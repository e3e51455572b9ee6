"""The spans of OmniHuman's forward and window step (`omni/model.py`,
`pipelines/omni.py:omni_cfg_step`), on the CPU at a tiny size: under a
profiler the conditional forward records `pose_guider`, `audio_proj` and
`pack` with its counts, the step records `step` over `cond`, `uncond`
and `solver`; without a profiler nothing is recorded."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from omnihuman_tpu_torch.configs.wan import DTypePolicy, WanModelConfig
from omnihuman_tpu_torch.omni.model import (
    OmniModelConfig, build_omni_model, omni_model_forward)
from omnihuman_tpu_torch.pipelines.omni import omni_cfg_step
from omnihuman_tpu_torch.samplers.fm_solvers import get_solver
from omnihuman_tpu_torch.utils import spans

CFG = OmniModelConfig(
    base=WanModelConfig(dim=32, ffn_dim=64, num_heads=4, num_layers=2,
                        freq_dim=16, text_dim=24, text_len=8),
    audio_dim=20, num_keypoints=8, num_frames=4, pose_hidden=(8, 8))
F32 = DTypePolicy(compute=torch.float32)


@pytest.fixture(autouse=True)
def fresh():
    spans.clear()
    yield
    spans.clear()


@pytest.fixture(scope="module")
def omni():
    model = build_omni_model(CFG, "cpu", torch.float32, seed=0)
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((1, 16, 3, 8, 8), generator=gen)
    kw = dict(audio=torch.randn((1, 3, 20), generator=gen),
              pose=torch.rand((1, 8, 3, 16, 16), generator=gen),
              ref_latent=torch.randn((1, 16, 1, 8, 8), generator=gen),
              motion_latent=torch.randn((1, 16, 2, 8, 8), generator=gen),
              policy=F32)
    ctx = torch.randn((1, 8, 24), generator=gen)
    return model, x, ctx, kw


def by_name(recorded):
    out = {}
    for s in recorded:
        out.setdefault(s["name"], []).append(s)
    return out


def test_forward_records_the_condition_spans(omni):
    """96 packed tokens (48 video, 32 motion, 16 reference), 2 pad rows at
    seq_align 7, 3 audio tokens; the uncond forward packs nothing."""
    model, x, ctx, kw = omni
    t = torch.tensor([500.0])
    with profile(activities=[ProfilerActivity.CPU]), torch.no_grad():
        omni_model_forward(model, x, t, ctx, seq_align=7, remat=False, **kw)
        omni_model_forward(model, x, t, ctx, policy=F32, remat=False)
    got = by_name(spans.collected())
    assert [len(got[n]) for n in ("pose_guider", "audio_proj", "pack")] \
        == [1, 1, 2]
    assert [p["attrs"] for p in got["pack"]] == [
        {"tokens": 96, "pad": 2, "audio_tokens": 3},
        {"tokens": 48, "pad": 0, "audio_tokens": 0}]
    assert len(got["audio_attn"]) == CFG.base.num_layers
    for name in ("pose_guider", "audio_proj", "pack"):
        assert all(s["parent"] is None for s in got[name])


def test_step_records_cond_uncond_and_solver(omni):
    model, x, ctx, kw = omni
    sol = get_solver("dpm++", 4, 1.0)
    with profile(activities=[ProfilerActivity.CPU]):
        omni_cfg_step(model, x, sol.init_state(x), 1, sol, ctx, ctx, **kw)
    got = by_name(spans.collected())
    (step,) = got["step"]
    assert step["attrs"] == {"index": 1} and step["parent"] is None
    for name in ("cond", "uncond", "solver"):
        (s,) = got[name]
        assert s["parent"] == step["id"] and s["root"] == step["id"]
    cond = got["cond"][0]["id"]
    assert {s["parent"] for s in got["pose_guider"] + got["audio_proj"]} \
        == {cond}
    assert len(got["block"]) == 2 * CFG.base.num_layers


def test_nothing_is_recorded_without_a_profiler(omni):
    model, x, ctx, kw = omni
    sol = get_solver("dpm++", 4, 1.0)
    omni_cfg_step(model, x, sol.init_state(x), 0, sol, ctx, ctx, **kw)
    assert spans.collected() == []
