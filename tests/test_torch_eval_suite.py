"""The port's evaluation suite against the JAX package's, on the CPU: the
slow cases of tests/test_torch_eval.py, in a file of their own so that a
`--dist loadfile` run schedules them with the files of few tests, beside
the longest ones, instead of before them.

- `OmniHumanEvaluator` batch / model / compare / ablation runs on the
  pixel proxy: rtol 1e-6 on the same features.
- `cli.evaluate` on .npy clips with --inception_weights, --i3d_weights
  and --keypoints, the same Inception, I3D and Sapiens weights on both
  sides: FID / FVD rtol 1e-3 (a Frechet distance of 8 frames in 2,048
  dimensions goes through sqrtm of rank-deficient covariances, four of
  them here, which magnifies the features' 1e-5 differences), HKC / HKV
  within 1e-3."""

import json
import os

import numpy as np
import torch

from omnihuman_tpu.cli import evaluate as jax_cli
from omnihuman_tpu.omni import evaluate as jax_ev
from omnihuman_tpu.omni import keypoints as jax_kp
from omnihuman_tpu.omni import sapiens as jax_sap
from omnihuman_tpu_torch.cli import evaluate as cli
from omnihuman_tpu_torch.omni import evaluate as ev
from omnihuman_tpu_torch.omni import i3d, inception, sapiens
# a helper of the file these cases came from
from test_torch_eval import _FixedKeypoints

torch.set_num_threads(4)


def test_evaluator_runs_match_jax(tmp_path):
    """batch / model / compare / ablation on the pixel proxy (no Inception):
    the same metrics, tags and JSON files as JAX's."""
    rng = np.random.default_rng(9)
    data = [{"frames": rng.uniform(-1, 1, (3, 4, 8, 8)).astype(np.float32),
             "conditions": {"audio": rng.normal(size=(6,)).astype(
                 np.float32)}} for _ in range(3)]

    def factory(dropped):
        shift = 0.1 * (1 + len(dropped))
        return lambda s: np.clip(s["frames"] + shift, -1, 1)

    out = {}
    for name, mod in (("port", ev), ("jax", jax_ev)):
        e = mod.OmniHumanEvaluator(use_inception=False,
                                   keypoint_processor=_FixedKeypoints(),
                                   output_dir=str(tmp_path / name))
        assert e.feature_space == "pixel_proxy"
        res = e.run_ablation_study(factory, ["audio", "pose"], data,
                                   num_samples=3)
        res["compare"] = e.compare_models({"a": factory("x")}, data, 2)
        out[name] = res
    assert out["port"].keys() == out["jax"].keys()
    for key in out["port"]:
        got, want = out["port"][key], out["jax"][key]
        if "a" in got:
            got, want = got["a"], want["a"]
        assert got.keys() == want.keys()
        for k, v in got.items():
            if isinstance(v, str):
                assert v == want[k]
            else:
                np.testing.assert_allclose(v, want[k], rtol=1e-6)
    assert sorted(os.listdir(tmp_path / "port")) == sorted(
        os.listdir(tmp_path / "jax"))


def _write_clips(d, seed, n=2, t=4, hw=24):
    d.mkdir()
    rng = np.random.default_rng(seed)
    for i in range(n):
        clip = rng.uniform(-1, 1, (t, hw, hw, 3)).astype(np.float32)
        clip[:, 8:16, 8:16] = 0.95                  # a bright "person"
        np.save(d / f"clip{i}.npy", clip)


def test_cli_evaluate_matches_jax(tmp_path, monkeypatch):
    """`cli.evaluate` on .npy clips with --inception_weights,
    --i3d_weights and --keypoints (patched to a tiny Sapiens with 308
    keypoints), against JAX's suite on the same files and weights (JAX's
    --keypoints raises ImportError, so its evaluator gets the processor
    directly)."""
    real_d, fake_d = tmp_path / "real", tmp_path / "fake"
    _write_clips(real_d, 11)
    _write_clips(fake_d, 12)
    inc = inception.build_inception("cpu", seed=5)
    torch.save(inc.state_dict(), tmp_path / "inception.pth")
    i3d_model = i3d.build_i3d(i3d.I3D_PRESETS["kinetics-400"], "cpu", seed=6)
    torch.save(i3d_model.state_dict(), tmp_path / "i3d.pt")
    cfg = dict(img_size=(64, 48), embed_dim=32, depth=1, num_heads=2,
               num_keypoints=308, deconv_channels=(8, 8),
               conv_channels=(8,))
    monkeypatch.setitem(sapiens.SAPIENS_PRESETS, "tiny-308",
                        sapiens.SapiensConfig(**cfg))
    monkeypatch.setattr(cli, "KEYPOINT_PRESET", "tiny-308")
    # the random Sapiens --keypoints builds (seed 0), carried to JAX
    jax_cfg = jax_sap.SapiensConfig(**cfg)
    params = jax_sap.convert_sapiens(
        {k: v.numpy() for k, v in sapiens.build_sapiens(
            sapiens.SAPIENS_PRESETS["tiny-308"], "cpu").state_dict().items()},
        jax_cfg)

    out = cli.main(["--real_dir", str(real_d), "--fake_dir", str(fake_d),
                    "--num_frames", "4", "--size", "24*24",
                    "--inception_weights", str(tmp_path / "inception.pth"),
                    "--i3d_weights", str(tmp_path / "i3d.pt"),
                    "--keypoints", "--output_dir", str(tmp_path / "ev"),
                    "--device", "cpu"])
    got = json.load(open(out))

    kp = jax_kp.SapiensKeypointProcessor(
        backbone=jax_sap.JaxSapiensBackbone(cfg=jax_cfg, params=params),
        input_size=(48, 64), heatmap_size=(12, 16))
    ref = jax_ev.OmniHumanEvaluator(
        inception_weights=str(tmp_path / "inception.pth"),
        i3d_weights=str(tmp_path / "i3d.pt"), keypoint_processor=kp,
        output_dir=str(tmp_path / "jax"))
    want = ref.evaluate_batch(jax_cli.load_clips(str(real_d), 4, (24, 24)),
                              jax_cli.load_clips(str(fake_d), 4, (24, 24)))
    assert got["feature_space"] == want["feature_space"] == \
        "inception_v3_pretrained"
    assert got["fvd_feature_space"] == want["fvd_feature_space"] == \
        "i3d_kinetics"
    for k in ("fid", "fvd"):
        assert np.isfinite(got[k]) and got[k] > 0
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3)
    for k in ("hkc", "hkv"):
        assert 0.0 <= got[k] <= 1.0
        np.testing.assert_allclose(got[k], want[k], atol=1e-3)
    assert got["hkc"] > 0
