"""OmniHuman evaluation suite: FID / IS / FVD / Sync-C / HKC / HKV (port of
omnihuman_tpu/omni/evaluate.py, reference Omnihuman/omnihuman-eval.py:15-314).

  - FID / FVD: the Frechet distance of two feature sets (numpy, scipy's
    `sqrtm` on the host), over pluggable feature extractors: by default
    the port's InceptionV3 pool3 features per frame (FID) and their
    temporal mean ++ std per clip (FVD), or I3D's Mixed_5c features for
    FVD where I3D weights are given; a downsampled-pixel proxy without
    Inception.
  - IS from class probabilities.
  - Sync-C: the cosine of audio and mouth-crop embeddings (the port's
    `omni/syncc.py` towers, or a pixel proxy).
  - HKC / HKV: hand-keypoint confidence and the share of frames with
    visible hands, from a keypoint processor (`omni/keypoints.py`); NaN
    without one.
  - batch / model / compare / ablation runs with JSON export; every
    metric dict is tagged with the feature space that made it, so
    random-init proxy numbers are never compared with pretrained ones.

The feature networks run on `device` (the GPU unless the caller asks for
the CPU); the statistics run in numpy on the host, as in JAX.
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
from scipy import linalg

from omnihuman_tpu_torch.utils.logging import logger


# ---------------------------------------------------------------------------
# Frechet distance core


def frechet_distance(feats_a: np.ndarray, feats_b: np.ndarray,
                     eps: float = 1e-6) -> float:
    """FID/FVD core: ||mu_a - mu_b||^2 + Tr(Ca + Cb - 2 sqrt(Ca Cb)).

    When N < feature dim the covariances are rank-deficient and
    `sqrtm` can return non-finite values — stabilized with the standard
    pytorch-fid eps-offset retry (sqrt((Ca+εI)(Cb+εI)))."""
    mu_a, mu_b = feats_a.mean(0), feats_b.mean(0)
    ca = np.cov(feats_a, rowvar=False)
    cb = np.cov(feats_b, rowvar=False)
    diff = mu_a - mu_b

    def _sqrtm(a, b):
        m = linalg.sqrtm(a @ b)
        if isinstance(m, tuple):   # older scipy returns (sqrtm, errest)
            m = m[0]
        return m

    covmean = _sqrtm(ca, cb)
    if not np.all(np.isfinite(covmean)):
        off = eps * np.eye(ca.shape[0])
        covmean = _sqrtm(ca + off, cb + off)
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(ca + cb - 2.0 * covmean))


def _pixel_features(frames: np.ndarray, dim: int = 256) -> np.ndarray:
    """Deterministic fallback features: downsampled pixels.

    Stand-in for InceptionV3/I3D (the reference used torch.randn
    placeholders for video features, omnihuman-eval.py:30-33); this at
    least makes the metric deterministic and sensitive to content.
    frames: [N, C, H, W] or [N, C, T, H, W] in [-1, 1].
    """
    n = frames.shape[0]
    flat = frames.reshape(n, -1).astype(np.float64)
    if flat.shape[1] < dim:
        flat = np.pad(flat, ((0, 0), (0, dim - flat.shape[1])))
    idx = np.linspace(0, flat.shape[1] - 1, dim).astype(int)
    return flat[:, idx]


# ---------------------------------------------------------------------------
# metric components


class VideoFrechetInceptionDistance:
    """FVD (omnihuman-eval.py:15-68) with a pluggable feature extractor."""

    def __init__(self, feature_fn: Optional[Callable] = None,
                 feature_dim: int = 256):
        self.feature_fn = feature_fn or (
            lambda v: _pixel_features(v, feature_dim))
        self.real: List[np.ndarray] = []
        self.fake: List[np.ndarray] = []

    def update(self, videos: np.ndarray, real: bool):
        feats = np.asarray(self.feature_fn(videos))
        (self.real if real else self.fake).append(feats)

    def compute(self) -> float:
        if not self.real or not self.fake:
            return float("nan")
        return frechet_distance(np.concatenate(self.real),
                                np.concatenate(self.fake))

    def reset(self):
        self.real, self.fake = [], []


class FrechetInceptionDistance(VideoFrechetInceptionDistance):
    """Image FID — same machinery over per-frame features."""


def inception_score(probs: np.ndarray, eps: float = 1e-12) -> float:
    """IS from class probabilities [N, C]: exp(E KL(p(y|x) || p(y)))."""
    py = probs.mean(0, keepdims=True)
    kl = (probs * (np.log(probs + eps) - np.log(py + eps))).sum(1)
    return float(np.exp(kl.mean()))


class LipSyncEvaluator:
    """Sync-C (omnihuman-eval.py:71-109): cosine confidence between audio
    and mouth-crop embeddings; both extractors pluggable (the reference's
    are placeholders)."""

    def __init__(self, audio_embed_fn: Optional[Callable] = None,
                 visual_embed_fn: Optional[Callable] = None):
        self.audio_embed_fn = audio_embed_fn or (
            lambda a: _pixel_features(a[:, None], 64))
        self.visual_embed_fn = visual_embed_fn or (
            lambda v: _pixel_features(v, 64))

    def sync_confidence(self, video: np.ndarray,
                        audio: np.ndarray) -> float:
        av = np.asarray(self.audio_embed_fn(audio), np.float64)
        vv = np.asarray(self.visual_embed_fn(video), np.float64)
        n = min(len(av), len(vv))
        av, vv = av[:n], vv[:n]
        num = (av * vv).sum(-1)
        den = np.linalg.norm(av, axis=-1) * np.linalg.norm(vv, axis=-1)
        return float(np.mean(num / np.maximum(den, 1e-8)))


class HandQualityEvaluator:
    """HKC/HKV (omnihuman-eval.py:111-154).

    With a real keypoint processor: HKC = mean hand-keypoint confidence,
    HKV = fraction of frames with visible hands — the paper's metrics.
    Without one, returns NaN (explicit, instead of random placeholders).
    """

    # Sapiens-308 hand keypoint index span (left+right hands)
    HAND_RANGE = (91, 133)

    def __init__(self, keypoint_processor=None,
                 conf_threshold: float = 0.3):
        self.kp = keypoint_processor
        self.thr = conf_threshold

    def evaluate(self, video: np.ndarray) -> Dict[str, float]:
        """video: [C, T, H, W] in [-1, 1]."""
        if self.kp is None:
            return {"hkc": float("nan"), "hkv": float("nan")}
        lo, hi = self.HAND_RANGE
        confs, visible = [], []
        for t in range(video.shape[1]):
            img = ((video[:, t].transpose(1, 2, 0) + 1) * 127.5
                   ).astype(np.uint8)
            kps = self.kp.extract_keypoints(img)
            if kps is None:
                visible.append(0.0)
                continue
            hand = kps[lo:hi]
            confs.append(float(hand[:, 2].mean()))
            visible.append(float((hand[:, 2] > self.thr).mean() > 0.5))
        return {
            "hkc": float(np.mean(confs)) if confs else 0.0,
            "hkv": float(np.mean(visible)) if visible else 0.0,
        }


# ---------------------------------------------------------------------------
# evaluation runs


class OmniHumanEvaluator:
    """Batch / model / compare / ablation runs (omnihuman-eval.py:156-314)."""

    def __init__(self, fid_feature_fn: Optional[Callable] = None,
                 fvd_feature_fn: Optional[Callable] = None,
                 keypoint_processor=None,
                 audio_embed_fn: Optional[Callable] = None,
                 visual_embed_fn: Optional[Callable] = None,
                 output_dir: str = "eval_results",
                 use_inception: bool = True,
                 inception_weights: Optional[str] = None,
                 i3d_weights: Optional[str] = None, device=None):
        # FVD's temporal backbone: when I3D weights are supplied, video
        # features come from the real Kinetics I3D (omni/i3d.py) instead
        # of the per-frame Inception stand-in — the reference's "I3D"
        # is a torch.randn placeholder (omnihuman-eval.py:30-33)
        self.fvd_feature_space = None
        if fvd_feature_fn is None and i3d_weights is not None:
            from omnihuman_tpu_torch.omni.i3d import I3DVideoFeatures
            fvd_feature_fn = I3DVideoFeatures(i3d_weights,
                                             device=device)
            self.fvd_feature_space = "i3d_kinetics"
        if fid_feature_fn is not None or fvd_feature_fn is not None:
            self.feature_space = "custom"
        elif use_inception:
            self.feature_space = "inception_v3"  # refined below
        else:
            self.feature_space = "pixel_proxy"
        if use_inception and (fid_feature_fn is None
                              or fvd_feature_fn is None):
            # real InceptionV3 pool3 features (reference used torchmetrics'
            # InceptionV3, omnihuman-eval.py:20-28); converted torch
            # weights via `inception_weights`, else deterministic random
            # init (documented content-sensitive proxy)
            from omnihuman_tpu_torch.omni.inception import InceptionFeatures
            self.inception = InceptionFeatures(inception_weights,
                                               device=device)
            self.feature_space = (
                "inception_v3_pretrained" if self.inception.pretrained
                else "inception_v3_random_init_proxy")
            if not self.inception.pretrained:
                logger.warning(
                    "no InceptionV3 weights supplied: FID/FVD use a "
                    "deterministic random-init Inception (pass "
                    "inception_weights=<pt_inception .pth> for standard "
                    "FID)")
            fid_feature_fn = fid_feature_fn or self.inception
            fvd_feature_fn = fvd_feature_fn or self.inception.video_features
        else:
            self.inception = None
        self.fid = FrechetInceptionDistance(fid_feature_fn)
        self.fvd = VideoFrechetInceptionDistance(fvd_feature_fn)
        self.lip = LipSyncEvaluator(audio_embed_fn, visual_embed_fn)
        # tag the sync-c backend like feature_space tags FID/FVD: real
        # two-tower embedders (omni/syncc.py) vs the pixel proxy
        self.sync_backend = ("embedders" if (audio_embed_fn is not None
                                             and visual_embed_fn is not None)
                             else "pixel_proxy")
        self.hands = HandQualityEvaluator(keypoint_processor)
        self.output_dir = output_dir
        os.makedirs(output_dir, exist_ok=True)

    def evaluate_batch(self, real_videos: np.ndarray,
                       fake_videos: np.ndarray,
                       audio: Optional[np.ndarray] = None
                       ) -> Dict[str, float]:
        """[B, C, T, H, W] pairs → metric dict."""
        # frame-level FID over all frames
        rf = real_videos.transpose(0, 2, 1, 3, 4).reshape(
            -1, *real_videos.shape[1:2], *real_videos.shape[3:])
        ff = fake_videos.transpose(0, 2, 1, 3, 4).reshape(
            -1, *fake_videos.shape[1:2], *fake_videos.shape[3:])
        self.fid.reset()
        self.fid.update(rf, real=True)
        self.fid.update(ff, real=False)
        self.fvd.reset()
        self.fvd.update(real_videos, real=True)
        self.fvd.update(fake_videos, real=False)

        metrics = {"fid": self.fid.compute(), "fvd": self.fvd.compute()}
        if audio is not None:
            metrics["sync_c"] = float(np.mean([
                self.lip.sync_confidence(fake_videos[i], audio[i])
                for i in range(len(fake_videos))]))
            metrics["sync_backend"] = self.sync_backend
        hand = [self.hands.evaluate(v) for v in fake_videos]
        # explicit NaN when no keypoint processor produced any values —
        # avoids numpy's "Mean of empty slice" warning masquerading as data
        hkc = [h["hkc"] for h in hand if np.isfinite(h["hkc"])]
        hkv = [h["hkv"] for h in hand if np.isfinite(h["hkv"])]
        metrics["hkc"] = float(np.mean(hkc)) if hkc else float("nan")
        metrics["hkv"] = float(np.mean(hkv)) if hkv else float("nan")
        # tag which feature space produced the FID/FVD numbers so reports
        # from the random-init proxy can never be silently compared with
        # pretrained-Inception (paper-comparable) numbers
        metrics["feature_space"] = self.feature_space
        if self.fvd_feature_space is not None:
            metrics["fvd_feature_space"] = self.fvd_feature_space
        return metrics

    def evaluate_model(self, generate_fn: Callable, dataset,
                       num_samples: int = 8,
                       name: str = "model") -> Dict[str, float]:
        reals, fakes, audios = [], [], []
        for i in range(num_samples):
            sample = dataset[i % len(dataset)]
            reals.append(sample["frames"])
            fakes.append(np.asarray(generate_fn(sample)))
            aud = sample["conditions"].get("audio")
            audios.append(aud)
        real = np.stack(reals)
        fake = np.stack(fakes)
        audio = (np.stack(audios)
                 if all(a is not None for a in audios) else None)
        metrics = self.evaluate_batch(real, fake, audio)
        self._export(metrics, name)
        return metrics

    def compare_models(self, generate_fns: Dict[str, Callable], dataset,
                       num_samples: int = 8) -> Dict[str, Dict[str, float]]:
        return {name: self.evaluate_model(fn, dataset, num_samples, name)
                for name, fn in generate_fns.items()}

    def run_ablation_study(self, generate_fn_factory: Callable,
                           conditions: Sequence[str], dataset,
                           num_samples: int = 8) -> Dict[str, Dict]:
        """Drop one condition at a time (omnihuman-eval.py:290-314)."""
        results = {}
        for dropped in ["none"] + list(conditions):
            fn = generate_fn_factory(dropped)
            results[f"drop_{dropped}"] = self.evaluate_model(
                fn, dataset, num_samples, name=f"ablation_drop_{dropped}")
        self._export(results, "ablation_study")
        return results

    def _export(self, payload: Any, name: str):
        path = os.path.join(self.output_dir, f"{name}.json")
        with open(path, "w") as f:
            json.dump(payload, f, indent=1, default=float)
        logger.info(f"eval results → {path}")
