"""The port's pose data plane against the JAX package (and cv2, which the
JAX package calls) on the CPU: `omni/pose_utils.py`, `native.py`,
`omni/sapiens.py`, `omni/keypoints.py`, `omni/worker_pool.py`,
`omni/dataset.py:Wav2VecFeatureExtractor`, `cli/extract_feature.py` and
`cli/omni_inference.py`'s `pose_heatmaps_from_frames`.

Tolerances: the blur 1e-6 absolute (fp32 separable sums in another
order); UDP / DARK keypoints 1e-4 heatmap-input pixels, scores exact; the
crop against cv2.warpAffine and the resize against cv2.resize at most 2
uint8 levels (cv2 rounds its uint8 path in fixed point); labels, stats,
NMS and native heatmaps exact; Sapiens tiny-test heatmaps rtol 1e-5
(fp32, dense attention in another order); the processor end to end with
the same cv2-free backbone in both packages: keypoints within one
heatmap pixel, scores within 1e-3; extract_feature's files and the
wav2vec features equal."""

import multiprocessing
import sys
from dataclasses import asdict

import jax
import numpy as np
import pytest
import torch

from omnihuman_tpu import native as jax_native
from omnihuman_tpu.omni import keypoints as jax_kp
from omnihuman_tpu.omni import pose_utils as jax_pu
from omnihuman_tpu.omni import sapiens as jax_sap
from omnihuman_tpu.omni import worker_pool as jax_wp
from omnihuman_tpu.omni.dataset import Wav2VecFeatureExtractor as JaxW2V
from omnihuman_tpu.omni.dataset import generate_heatmaps as jax_heatmaps
from omnihuman_tpu_torch import native
from omnihuman_tpu_torch.omni import keypoints as kp_mod
from omnihuman_tpu_torch.omni import pose_utils as pu
from omnihuman_tpu_torch.omni import sapiens as sap
from omnihuman_tpu_torch.utils.convert import sapiens_state_dict_from_jax

torch.set_num_threads(1)
TINY = sap.SAPIENS_PRESETS["tiny-test"]


def _peaked_heatmaps(rng, k=9, h=64, w=48):
    """Gaussian bumps at random sub-pixel centres, an all-zero map, a map
    peaked at an edge (no DARK step there)."""
    yy, xx = np.mgrid[0:h, 0:w]
    hm = np.stack([np.exp(-((xx - rng.uniform(3, w - 4)) ** 2
                            + (yy - rng.uniform(3, h - 4)) ** 2)
                          / (2 * rng.uniform(1.0, 3.0) ** 2))
                   for _ in range(k)]).astype(np.float32)
    hm[0] = 0.0
    hm[1] = 0.0
    hm[1, 0, 1] = 0.7
    return hm * rng.uniform(0.2, 1.5, (k, 1, 1)).astype(np.float32)


def _two_person_frame():
    """tests/test_person_detector.py's frame."""
    img = np.zeros((240, 320, 3), np.uint8)
    img[40:80, 40:80] = 180        # person A (dimmer)
    img[120:200, 200:280] = 250    # person B (brighter, bigger)
    return img


class IntensityBackbone:
    """Response = normalized brightness, pooled 4x4 (numpy; no cv2): a crop
    [H, W, 3] uint8 (array or CPU tensor) -> [K, H/4, W/4]."""

    def __init__(self, k=2):
        self.k = k

    def __call__(self, crop):
        g = np.asarray(crop).mean(axis=-1).astype(np.float32) / 255.0
        h, w = g.shape[0] // 4, g.shape[1] // 4
        hm = g[:h * 4, :w * 4].reshape(h, 4, w, 4).mean(axis=(1, 3))
        return np.stack([hm * (1.0 - 0.05 * i) for i in range(self.k)])


@pytest.mark.parametrize("seed", [0, 1])
def test_gaussian_blur_matches_jax(seed):
    rng = np.random.default_rng(seed)
    for hm in (_peaked_heatmaps(rng),
               (rng.random((5, 40, 30)) ** 4).astype(np.float32)):
        got = pu.gaussian_blur(hm).numpy()
        np.testing.assert_allclose(got, jax_pu.gaussian_blur(hm), atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_udp_decode_matches_jax(seed):
    hm = _peaked_heatmaps(np.random.default_rng(seed))
    want_kp, want_s = jax_pu.udp_decode(hm, (192, 256))
    got_kp, got_s = pu.udp_decode(hm, (192, 256))
    np.testing.assert_allclose(got_kp, want_kp, atol=1e-4)
    np.testing.assert_array_equal(got_s, want_s)
    locs, _ = jax_pu.get_heatmap_maximum(hm)
    np.testing.assert_allclose(
        pu.refine_keypoints_dark_udp(locs, torch.from_numpy(hm)),
        jax_pu.refine_keypoints_dark_udp(locs, hm), atol=1e-4)


@pytest.mark.parametrize("bbox,size", [
    ((30.3, 20.7, 200.2, 180.9), (48, 64)),
    ((-50.0, -30.0, 400.5, 300.1), (192, 256)),     # past every edge
    ((100.0, 50.0, 110.0, 70.0), (192, 256)),       # a 20x upscale
])
def test_crop_matches_cv2_warp_affine(bbox, size):
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (240, 320, 3), dtype=np.uint8)
    img[100:160, 120:200] = 250                     # hard edges
    box = np.array(bbox + (1.0,), np.float32)
    want, wc, ws = jax_pu.top_down_affine_transform(img, box, size)
    got, gc, gs = pu.top_down_affine_transform(img, box, size)
    assert got.dtype == torch.uint8 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(gc, wc)
    np.testing.assert_array_equal(gs, ws)
    diff = np.abs(got.numpy().astype(int) - want.astype(int))
    assert diff.max() <= 2, diff.max()


def test_resize_matches_cv2():
    import cv2
    img = _two_person_frame()
    img[::7] = 90
    for size in ((160, 128), (768, 1024), (57, 33)):
        want = cv2.resize(img, size)
        got = pu.resize_image(img, size).numpy()
        assert got.shape == want.shape
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 2


def test_connected_components_match_cv2():
    import cv2
    rng = np.random.default_rng(4)
    det = jax_kp.HeatmapPersonDetector(IntensityBackbone(),
                                       input_size=(160, 128))
    resp = np.asarray(IntensityBackbone()(cv2.resize(
        _two_person_frame(), det.input_size))).max(0)
    masks = [(resp >= det.threshold).astype(np.uint8)]
    masks += [(rng.random(rng.integers(5, 70, 2)) > rng.uniform(0.3, 0.9)
               ).astype(np.uint8) for _ in range(12)]
    for mask in masks:
        n, labels, stats, _ = cv2.connectedComponentsWithStats(mask)
        got_n, got_labels, got_stats = pu.connected_components(mask)
        assert got_n == n
        np.testing.assert_array_equal(got_labels, labels)
        np.testing.assert_array_equal(got_stats, stats)


def test_nms_matches_jax():
    rng = np.random.default_rng(5)
    xy = rng.uniform(0, 100, (40, 2))
    wh = rng.uniform(5, 60, (40, 2))
    dets = np.concatenate([xy, xy + wh, rng.random((40, 1))], 1)
    for thr in (0.1, 0.3, 0.7):
        assert pu.nms(dets, thr) == jax_pu.nms(dets, thr)
    assert pu.nms(np.zeros((0, 5)), 0.3) == []


def test_native_heatmaps_match_jax(monkeypatch):
    rng = np.random.default_rng(6)
    kp = rng.uniform(-0.1, 1.1, (3, 17, 3)).astype(np.float32)
    want = jax_native.gaussian_heatmaps(kp, (24, 40))
    np.testing.assert_array_equal(native.gaussian_heatmaps(kp, (24, 40)),
                                  want)
    assert native.available() == jax_native.available()
    fr = rng.integers(0, 256, (2, 8, 6, 3), dtype=np.uint8)
    np.testing.assert_array_equal(native.frames_to_float(fr),
                                  jax_native.frames_to_float(fr))
    pcm = rng.integers(-32768, 32767, 64).astype(np.int16)
    np.testing.assert_array_equal(native.pcm16_to_float_mono(pcm, 2),
                                  jax_native.pcm16_to_float_mono(pcm, 2))
    # the numpy fallback: the port's generate_heatmaps, JAX's equal
    monkeypatch.setattr(native, "load_library", lambda: None)
    np.testing.assert_array_equal(
        native.gaussian_heatmaps(kp, (24, 40)),
        np.stack([jax_heatmaps(k, (24, 40)) for k in kp]))


@pytest.fixture(scope="module")
def tiny_sapiens():
    """The port's random tiny Sapiens (random norms and BN statistics too)
    and its weights in JAX's tree, through JAX's converter."""
    model = sap.build_sapiens(TINY, "cpu", seed=0)
    g = torch.Generator().manual_seed(7)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (torch.nn.BatchNorm2d, torch.nn.LayerNorm)):
                m.weight.uniform_(0.5, 1.5, generator=g)
                m.bias.normal_(0.0, 0.1, generator=g)
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0.0, 0.1, generator=g)
                m.running_var.uniform_(0.5, 1.5, generator=g)
        model.head.final_layer.bias.normal_(0.0, 0.1, generator=g)
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    params = jax_sap.convert_sapiens({k: v.numpy() for k, v in sd.items()},
                                     TINY)
    return params, sd, model


def test_sapiens_tiny_matches_jax(tiny_sapiens):
    params, sd, model = tiny_sapiens
    x = np.random.default_rng(8).normal(size=(2, *TINY.img_size, 3)
                                        ).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, x: jax_sap.sapiens_forward(
        p, x, TINY))(params, x))
    with torch.no_grad():
        got = sap.sapiens_forward(model, torch.from_numpy(x)).numpy()
    assert got.shape == (2, TINY.num_keypoints, *TINY.heatmap_size)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # JAX's tree back to the released names: the state dict again
    back = sapiens_state_dict_from_jax(params, TINY)
    for k, v in sd.items():
        if not k.endswith("num_batches_tracked"):
            torch.testing.assert_close(back[k], v, rtol=0, atol=0)


def test_sapiens_backbone_loads_a_file_with_a_cls_slot(tiny_sapiens,
                                                       tmp_path):
    """A released file's pos_embed carries a cls slot: both packages drop
    it, size the model from the file and give the same heatmaps."""
    _, sd, _ = tiny_sapiens
    sd = dict(sd)
    pos = sd["backbone.pos_embed"]
    sd["backbone.pos_embed"] = torch.cat([torch.randn(1, 1, pos.shape[2]),
                                          pos], dim=1)
    sd["head.deconv_layers.1.num_batches_tracked"] = torch.tensor(3)
    path = str(tmp_path / "sapiens.pth")
    torch.save(sd, path)
    assert asdict(sap.infer_sapiens_config(sd)) == asdict(
        jax_sap.infer_sapiens_config(sd))
    got = sap.SapiensBackbone(path, device="cpu")
    want = jax_sap.JaxSapiensBackbone(path)
    assert asdict(got.cfg) == asdict(want.cfg) == asdict(TINY)
    crop = np.random.default_rng(9).integers(0, 256, (*TINY.img_size, 3),
                                             dtype=np.uint8)
    np.testing.assert_allclose(got(crop).numpy(), want(crop), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got.batch(np.stack([crop, crop]))[1].numpy(),
                               want(crop), rtol=1e-5, atol=1e-5)
    del sd["backbone.layers.1.attn.proj.bias"]
    with pytest.raises(KeyError, match="attn.proj.bias"):
        sap.load_sapiens_state_dict(sap.build_sapiens(TINY, "cpu"), sd)


def _processors(**kw):
    common = dict(num_keypoints=4, input_size=(96, 128),
                  heatmap_size=(24, 32), **kw)
    port = kp_mod.SapiensKeypointProcessor(backbone=IntensityBackbone(),
                                           device="cpu", **common)
    ref = jax_kp.SapiensKeypointProcessor(backbone=IntensityBackbone(),
                                          **common)
    return port, ref


@pytest.mark.parametrize("self_detect", [True, False])
def test_processor_end_to_end_matches_jax(self_detect):
    """Detection, crop, heatmaps, UDP decode, the map back to the frame:
    both packages with the same cv2-free backbone."""
    port, ref = _processors(self_detect=self_detect)
    frames = [_two_person_frame()]
    frame = _two_person_frame()
    frame[60:70, 250:300] = 120
    frames.append(frame)
    for img in frames:
        box = ref.detect_person(img)
        np.testing.assert_allclose(port.detect_person(img), box, atol=1.0,
                                   rtol=0)
        want = ref.extract_keypoints(img)
        got = port.extract_keypoints(img)
        assert got.shape == (4, 3) and want is not None
        _, _, scale = jax_pu.top_down_affine_transform(img, box, (96, 128))
        px = scale / np.array([24, 32])      # one heatmap pixel, frame px
        err = np.abs(got[:, :2] - want[:, :2]) * np.array([320, 240])
        assert (err <= px).all(), (err, px)
        np.testing.assert_allclose(got[:, 2], want[:, 2], atol=1e-3)


def test_detector_boxes_match_jax():
    """tests/test_person_detector.py's frames: two boxes, equal to JAX's
    within a frame pixel; a blank frame falls back to the full frame."""
    det = kp_mod.HeatmapPersonDetector(IntensityBackbone(),
                                       input_size=(160, 128), device="cpu")
    ref = jax_kp.HeatmapPersonDetector(IntensityBackbone(),
                                       input_size=(160, 128))
    img = _two_person_frame()
    got, want = det(img), ref(img)
    assert got.shape == want.shape == (2, 5)
    np.testing.assert_allclose(got, want, atol=1.0)
    blank = np.zeros((100, 150, 3), np.uint8)
    np.testing.assert_array_equal(det(blank), ref(blank))


def test_processor_runs_with_cv2_blocked(monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError):
        import cv2  # noqa: F401
    port, _ = _processors()
    out = port.extract_keypoints(torch.from_numpy(_two_person_frame()))
    assert out is not None and np.isfinite(out).all()
    # the brighter person's crop (two maps; rows 2-3 are the zero padding)
    assert np.all(out[:2, 0] > 0.5) and np.all(out[:2, 1] > 0.4), out
    assert not out[2:].any()


def test_processor_without_backbone_returns_none():
    proc = kp_mod.SapiensKeypointProcessor(device="cpu")
    assert proc.detector is kp_mod.full_frame_detector
    assert proc.extract_keypoints(_two_person_frame()) is None
    bad = kp_mod.SapiensKeypointProcessor(checkpoint_path="/nonexistent.pth",
                                          device="cpu")
    assert bad.backbone is None


class _TinyPose(torch.nn.Module):
    """A TorchScript-able pose net: [1, 3, H, W] -> [1, 2, H/4, W/4]."""

    def forward(self, x):
        return torch.sigmoid(torch.nn.functional.avg_pool2d(x, 4)[:, :2])


def test_pt2_routes_to_torchscript_like_jax(tmp_path):
    """A `.pt2` checkpoint goes to `TorchScriptPoseBackbone` in both
    packages: the same normalisation and heatmaps, the same keypoints."""
    path = str(tmp_path / "pose.pt2")
    torch.jit.script(_TinyPose()).save(path)
    kw = dict(num_keypoints=2, input_size=(96, 128), heatmap_size=(24, 32))
    port = kp_mod.SapiensKeypointProcessor(checkpoint_path=path,
                                           device="cpu", **kw)
    ref = jax_kp.SapiensKeypointProcessor(checkpoint_path=path, **kw)
    assert isinstance(port.backbone, kp_mod.TorchScriptPoseBackbone)
    crop = np.random.default_rng(12).integers(0, 256, (128, 96, 3),
                                              dtype=np.uint8)
    np.testing.assert_array_equal(port.backbone(crop).numpy(),
                                  ref.backbone(crop))
    img = _two_person_frame()
    np.testing.assert_allclose(port.extract_keypoints(img),
                               ref.extract_keypoints(img), atol=1e-3)


def test_pose_heatmaps_from_frames_match_jax():
    """`--pose_video`: with no backbone (what both CLIs build) every frame
    fails, so the heatmaps are zero; JAX cli/omni_inference.py:189-213
    on the same frames is the reference."""
    from omnihuman_tpu_torch.cli.omni_inference import (
        pose_heatmaps_from_frames)
    frames = [_two_person_frame()] * 3
    f_total, h_lat, w_lat = 5, 6, 8
    got = pose_heatmaps_from_frames(
        iter(frames), f_total, h_lat, w_lat,
        kp_mod.SapiensKeypointProcessor(device="cpu"))
    kp_proc, kps = jax_kp.SapiensKeypointProcessor(), []
    for frame in frames[:f_total]:
        k = kp_proc.extract_keypoints(frame)
        kps.append(k if k is not None else np.zeros((308, 3), np.float32))
    while len(kps) < f_total:
        kps.append(kps[-1])
    want = jax_native.gaussian_heatmaps(np.stack(kps), (h_lat * 2, w_lat * 2))
    want = want.transpose(1, 0, 2, 3)[None]
    assert got.shape == (1, 308, f_total, 12, 16)
    np.testing.assert_array_equal(got, want)
    assert not got.any()
    # with a backbone: the last frame's keypoints repeat past the frames
    port, _ = _processors()
    hm = pose_heatmaps_from_frames(frames[:2], 4, 8, 8, port)
    assert hm.shape == (1, 4, 4, 16, 16) and hm.any()
    np.testing.assert_array_equal(hm[:, :, 3], hm[:, :, 1])


def test_worker_pool_child_exception_reaches_parent(tmp_path):
    from omnihuman_tpu_torch.cli.extract_feature import _save_npy
    from omnihuman_tpu_torch.omni.worker_pool import (
        AsyncWorkerExceptionsWrapper, WorkerPool)
    # in process: the same exception type and message as JAX's wrapper
    errs = []
    for wrap in (AsyncWorkerExceptionsWrapper,
                 jax_wp.AsyncWorkerExceptionsWrapper):
        with pytest.raises(ValueError) as e:
            wrap(int)("x")
        errs.append(str(e.value).split("\n--- child traceback ---")[0])
    assert errs[0] == errs[1]
    bad = str(tmp_path / "missing_dir" / "x.npy")
    with WorkerPool(processes=1,
                    context=multiprocessing.get_context("spawn")) as pool:
        r = pool.apply_async(_save_npy, (bad, np.zeros(2)))
        with pytest.raises(FileNotFoundError, match="child traceback"):
            r.get(timeout=60)
        assert pool.map(abs, [-1, 2]) == [1, 2]
        assert pool.starmap(max, [(1, 3), (4, 2)]) == [3, 4]


class _StubWav2Vec(torch.nn.Module):
    """Fixed features of a waveform: [1, N / 320, 6] (frames of 320
    samples, six statistics each), as both packages' models are called."""

    def forward(self, x):
        n = x.shape[1] // 320
        f = x[:, :n * 320].reshape(1, n, 320)
        return torch.stack([f.mean(-1), f.std(-1), f.amax(-1), f.amin(-1),
                            f[..., 0], f[..., -1]], dim=-1)


class _JaxStubOutput:
    def __init__(self, model):
        self.model = model

    def __call__(self, x):
        class Out:
            last_hidden_state = self.model(x)
        return Out()


@pytest.mark.parametrize("sr,n_frames", [(16000, 13), (22050, 7),
                                         (8000, 40)])
def test_wav2vec_feature_extractor_matches_jax(sr, n_frames):
    from omnihuman_tpu_torch.omni.dataset import Wav2VecFeatureExtractor
    wav = np.random.default_rng(11).normal(size=int(1.3 * sr)).astype(
        np.float32)
    ref = JaxW2V.__new__(JaxW2V)      # skip its transformers download
    ref.torch, ref.model = torch, _JaxStubOutput(_StubWav2Vec())
    ref.dim, ref.fps = 20, 16.0
    got = Wav2VecFeatureExtractor(model=_StubWav2Vec(), dim=20,
                                  device="cpu")(wav, sr, n_frames)
    want = ref(wav, sr, n_frames)
    assert got.shape == (n_frames, 20)
    np.testing.assert_array_equal(got, want)
