"""The port's evaluation suite against the JAX package on the CPU:
`omni/inception.py`, `omni/i3d.py`, `omni/syncc.py`, `omni/evaluate.py`
and `cli/evaluate.py`, on the same weights: the port's random init
carried to JAX's tree by JAX's converters and back by `utils/convert.py`'s
carriers (which must give the state dict again), or state-dict files
both packages read.

Tolerances: Inception features and logits rtol 1e-4 of each output's
peak (fp32 convolutions summed in another order, 94 layers deep), the
resize to 299 1e-4 absolute (both antialias when they shrink; fp32
weights and sums in another order); I3D tiny-test features and
logits rtol 1e-4 of the peak; Sync-C tiny-test embeddings 1e-5 absolute
(unit vectors); frechet_distance, inception_score, HandQualityEvaluator
and the evaluator's batch, model, compare and ablation runs on the same
features rtol 1e-6. The evaluator's runs and `cli.evaluate` against JAX's
suite are in tests/test_torch_eval_suite.py."""


import jax
import numpy as np
import pytest
import torch

from omnihuman_tpu.cli import evaluate as jax_cli
from omnihuman_tpu.omni import evaluate as jax_ev
from omnihuman_tpu.omni import i3d as jax_i3d
from omnihuman_tpu.omni import inception as jax_inc
from omnihuman_tpu.omni import syncc as jax_syncc
from omnihuman_tpu_torch.cli import evaluate as cli
from omnihuman_tpu_torch.omni import evaluate as ev
from omnihuman_tpu_torch.omni import i3d, inception, syncc
from omnihuman_tpu_torch.utils.convert import (
    i3d_state_dict_from_jax, inception_state_dict_from_jax,
    syncc_state_dict_from_jax)

torch.set_num_threads(4)


def _close_to_peak(got, want, rtol):
    err = np.abs(np.asarray(got) - np.asarray(want)).max()
    assert err <= rtol * max(np.abs(want).max(), 1e-6), err


@pytest.fixture(scope="module")
def inception_pair():
    """The port's random InceptionV3 (random BN statistics too) and its
    weights in JAX's tree, through JAX's converter."""
    model = inception.build_inception("cpu", seed=3)
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.weight.uniform_(0.5, 1.5, generator=g)
                m.bias.normal_(0.0, 0.1, generator=g)
                m.running_mean.normal_(0.0, 0.1, generator=g)
                m.running_var.uniform_(0.5, 1.5, generator=g)
    params = jax_inc.convert_inception_torch(
        {k: v.numpy() for k, v in model.state_dict().items()})
    return params, model


def test_inception_matches_jax(inception_pair):
    """At 299 after the resize from 24 (the shape the CLI test's
    evaluator runs, so JAX compiles it once): features, and the logits
    against JAX's head on JAX's features."""
    params, model = inception_pair
    x = np.random.default_rng(0).uniform(-1, 1, (8, 3, 24, 24)).astype(
        np.float32)
    want_f = np.asarray(jax_inc.inception_forward(params, x))
    with torch.no_grad():
        got_f, got_l = inception.inception_forward(
            model, torch.from_numpy(x), with_logits=True)
    assert got_f.shape == (8, 2048) and got_l.shape == (8, 1008)
    _close_to_peak(got_f.numpy(), want_f, 1e-4)
    want_l = want_f @ np.asarray(params["fc"]["w"]) + np.asarray(
        params["fc"]["b"])
    _close_to_peak(got_l.numpy(), want_l, 1e-4)


@pytest.mark.parametrize("hw", [(24, 24), (480, 300)])
def test_inception_resize_matches_jax(hw):
    """The resize to 299: jax.image.resize bilinear (antialiased when it
    shrinks) against F.interpolate's antialiased bilinear."""
    x = np.random.default_rng(1).uniform(-1, 1, (1, 3) + hw).astype(
        np.float32)
    want = np.asarray(jax.image.resize(x.transpose(0, 2, 3, 1),
                                       (1, 299, 299, 3), "bilinear"))
    got = torch.nn.functional.interpolate(
        torch.from_numpy(x), size=(299, 299), mode="bilinear",
        align_corners=False, antialias=True)
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), want,
                               atol=1e-4)


def test_inception_state_dict_round_trips(inception_pair):
    params, model = inception_pair
    sd = inception_state_dict_from_jax(params)
    want = model.state_dict()
    assert set(want) - set(sd) == {k for k in want
                                   if k.endswith("num_batches_tracked")}
    for k, v in sd.items():
        torch.testing.assert_close(v, want[k], rtol=0, atol=0)


def test_i3d_tiny_matches_jax():
    """Odd T, H and W: TF-SAME pads asymmetrically (zeros for the convs,
    -inf for the max pools)."""
    cfg = jax_i3d.I3D_PRESETS["tiny-test"]
    model = i3d.build_i3d(i3d.I3D_PRESETS["tiny-test"], "cpu", seed=1)
    g = torch.Generator().manual_seed(2)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm3d):
                m.weight.uniform_(0.5, 1.5, generator=g)
                m.bias.normal_(0.0, 0.1, generator=g)
                m.running_mean.normal_(0.0, 0.1, generator=g)
                m.running_var.uniform_(0.5, 1.5, generator=g)
        model.logits.conv3d.bias.normal_(0.0, 1.0, generator=g)
    params = jax_i3d.convert_i3d(model.state_dict(), cfg)
    v = np.random.default_rng(3).uniform(-1, 1, (2, 3, 7, 29, 27)).astype(
        np.float32)
    want_f, want_l = jax.jit(lambda p, x: jax_i3d.i3d_forward(
        p, x, cfg, with_logits=True))(params, v.transpose(0, 2, 3, 4, 1))
    with torch.no_grad():
        got_f, got_l = i3d.i3d_forward(model, torch.from_numpy(v),
                                       with_logits=True)
    assert got_f.shape == (2, 128) and got_l.shape == (2, 11)
    _close_to_peak(got_f.numpy(), want_f, 1e-4)
    _close_to_peak(got_l.numpy(), want_l, 1e-4)
    sd = i3d_state_dict_from_jax(params)
    for k, v in model.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            torch.testing.assert_close(sd[k], v, rtol=0, atol=0)


def test_syncc_tiny_matches_jax():
    cfg = jax_syncc.SYNCC_PRESETS["tiny-test"]
    params = jax.tree.map(np.asarray, jax_syncc.init_syncc(
        jax.random.key(4), cfg, audio_dim=24))
    ref = jax_syncc.SyncCEmbedders(params=params, cfg=cfg, audio_dim=24)
    port = syncc.SyncCEmbedders(
        model=_loaded(syncc.build_syncc(syncc.SYNCC_PRESETS["tiny-test"],
                                        "cpu", 24, seed=None),
                      syncc_state_dict_from_jax(params, cfg)),
        preset="tiny-test", audio_dim=24, device="cpu")
    rng = np.random.default_rng(5)
    for audio in (rng.normal(size=(9, 24)), rng.normal(size=(3, 10)),
                  rng.normal(size=(7,))):
        np.testing.assert_allclose(port.audio_embed_fn(audio),
                                   ref.audio_embed_fn(audio), atol=1e-5)
    for video in (rng.uniform(-1, 1, (3, 9, 64, 56)),
                  rng.uniform(-1, 1, (1, 3, 20, 30))):
        np.testing.assert_allclose(port.visual_embed_fn(video),
                                   ref.visual_embed_fn(video), atol=1e-5)


def _loaded(model, sd):
    model.load_state_dict(sd, strict=True)
    return model


def test_frechet_and_inception_score_match_jax():
    rng = np.random.default_rng(6)
    a = rng.normal(size=(40, 16))
    b = rng.normal(size=(40, 16)) * 1.3 + 0.2
    for x, y in ((a, b), (a, a), (a[:5], b[:7])):
        np.testing.assert_allclose(ev.frechet_distance(x, y),
                                   jax_ev.frechet_distance(x, y),
                                   rtol=1e-6, atol=1e-9)
    probs = rng.dirichlet(np.ones(10), size=30)
    np.testing.assert_allclose(ev.inception_score(probs),
                               jax_ev.inception_score(probs), rtol=1e-6)


class _FixedKeypoints:
    """A processor double: fixed keypoints per call, None every third."""

    def __init__(self):
        self.rng = np.random.default_rng(7)
        self.calls = 0

    def extract_keypoints(self, img):
        self.calls += 1
        if self.calls % 3 == 0:
            return None
        return self.rng.uniform(0, 1, (308, 3)).astype(np.float32)


def test_hand_quality_evaluator_matches_jax():
    video = np.random.default_rng(8).uniform(-1, 1, (3, 7, 16, 16))
    got = ev.HandQualityEvaluator(_FixedKeypoints()).evaluate(video)
    want = jax_ev.HandQualityEvaluator(_FixedKeypoints()).evaluate(video)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6)
    assert np.isnan(ev.HandQualityEvaluator().evaluate(video)["hkc"])


def test_load_clips_matches_jax_without_cv2(tmp_path, monkeypatch):
    d = tmp_path / "clips"
    d.mkdir()
    rng = np.random.default_rng(10)
    np.save(d / "a.npy", rng.uniform(-1, 1, (3, 2, 16, 16)).astype(
        np.float32))
    np.save(d / "b.npy", rng.uniform(0, 255, (5, 24, 20, 3)).astype(
        np.float32))
    np.savez(d / "c.npz", x=rng.uniform(-1, 1, (3, 6, 32, 32)).astype(
        np.float32))
    want = jax_cli.load_clips(str(d), num_frames=4, size=(32, 28))
    monkeypatch.setitem(__import__("sys").modules, "cv2", None)
    got = cli.load_clips(str(d), num_frames=4, size=(32, 28))
    assert got.shape == want.shape == (3, 3, 4, 32, 28)
    np.testing.assert_allclose(got, want, atol=1e-5)
    with pytest.raises(FileNotFoundError):
        cli.load_clips(str(tmp_path / "missing"), 4, (32, 32))
