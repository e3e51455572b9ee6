"""cli.extract_feature.run against the JAX main's files: the slow cases of
tests/test_torch_pose.py (whose helpers they use), in a file of their own
so that a `--dist loadfile` run schedules them with the files of few
tests, beside the longest ones, instead of before them."""

import functools
import os

import multiprocessing
import numpy as np

from omnihuman_tpu.omni import keypoints as jax_kp
from omnihuman_tpu.omni import worker_pool as jax_wp
from omnihuman_tpu_torch.omni import keypoints as kp_mod
# fixtures and helpers of the file these cases came from
from test_torch_pose import _two_person_frame, IntensityBackbone


def test_extract_feature_run_writes_jax_mains_files(tmp_path, monkeypatch):
    """The same images through JAX's main (cv2 reads the files) and the
    port's run (arrays): the same .npy heatmaps, file for file."""
    import cv2
    from omnihuman_tpu.cli import extract_feature as jax_cli
    from omnihuman_tpu_torch.cli import extract_feature
    rng = np.random.default_rng(10)
    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    images = []
    for i in range(3):
        img = _two_person_frame()
        img[rng.integers(0, 200):, rng.integers(0, 300):] //= 2
        cv2.imwrite(str(img_dir / f"f{i}.png"), img[..., ::-1])
        images.append((f"f{i}.png", img))
    kw = dict(backbone=IntensityBackbone(), num_keypoints=4,
              input_size=(96, 128), heatmap_size=(24, 32))
    monkeypatch.setattr(
        jax_kp, "SapiensKeypointProcessor",
        lambda checkpoint_path=None, _cls=jax_kp.SapiensKeypointProcessor:
        _cls(**kw))
    # JAX's pool forks, which a process running JAX's threads must not
    monkeypatch.setattr(jax_wp, "WorkerPool", functools.partial(
        jax_wp.WorkerPool, context=multiprocessing.get_context("spawn")))
    n = jax_cli.main(["--image_dir", str(img_dir), "--output_dir",
                      str(tmp_path / "jax"), "--num_workers", "1",
                      "--heatmap_size", "16", "24"])
    got = extract_feature.run(
        images, str(tmp_path / "port"),
        kp_mod.SapiensKeypointProcessor(device="cpu", **kw),
        heatmap_size=(16, 24), num_workers=2)
    assert n == got == 3
    for name, _ in images:
        stem = os.path.splitext(name)[0] + ".npy"
        want = np.load(tmp_path / "jax" / stem)
        assert want.shape == (4, 16, 24) and want.any()
        np.testing.assert_array_equal(np.load(tmp_path / "port" / stem),
                                      want)
