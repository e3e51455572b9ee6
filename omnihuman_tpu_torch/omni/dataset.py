"""The OmniHuman data plane: numpy copies of omnihuman_tpu/omni/dataset.py's
`read_wav` (`:49`), `AudioFeatureExtractor` (`:68`), `generate_heatmaps`
(`:132`) and `OmniHumanDataset` (`:155-412`), the same arithmetic line
for line, so both packages turn the same files into the same arrays.

`OmniHumanDataset` scans a directory for `*.mp4`, writes or reads its
`annotations.json`, caches each video's audio status (a sidecar `.wav`),
filters, draws each sample's window from `np.random.default_rng(seed)`,
reads frames with OpenCV (imported where it is used, so the module
imports without it), log-mel audio features and keypoint heatmaps
(keypoints cached as `.npy`), falls back to a zero sample on any failure
and reports it to the `ProblematicVideoTracker`. Samples are numpy arrays; `cli.train_omni`
turns them into device batches.
"""

from __future__ import annotations

import json
import wave
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from omnihuman_tpu_torch.omni.tracker import (
    ProblematicVideoTracker, VideoEvent)
from omnihuman_tpu_torch.utils.logging import logger


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """Mono float32 waveform + sample rate via stdlib wave."""
    with wave.open(str(path), "rb") as w:
        sr = w.getframerate()
        n = w.getnframes()
        raw = w.readframes(n)
        width = w.getsampwidth()
        ch = w.getnchannels()
    if width == 2:
        x = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    elif width == 4:
        x = np.frombuffer(raw, np.int32).astype(np.float32) / 2147483648.0
    else:
        x = np.frombuffer(raw, np.uint8).astype(np.float32) / 128.0 - 1.0
    if ch > 1:
        x = x.reshape(-1, ch).mean(-1)
    return x, sr


class AudioFeatureExtractor:
    """Log-mel features [num_frames, dim] aligned to video frames: the mel
    spectrogram averaged over each frame's audio span, tiled / truncated
    to `dim`."""

    def __init__(self, dim: int = 1024, n_mels: int = 128,
                 n_fft: int = 512, fps: float = 16.0):
        self.dim = dim
        self.n_mels = n_mels
        self.n_fft = n_fft
        self.fps = fps

    def _mel_filter(self, sr: int) -> np.ndarray:
        n_bins = self.n_fft // 2 + 1
        f = np.linspace(0, sr / 2, n_bins)
        mel_pts = np.linspace(self._hz2mel(0), self._hz2mel(sr / 2),
                              self.n_mels + 2)
        hz_pts = self._mel2hz(mel_pts)
        fb = np.zeros((self.n_mels, n_bins), np.float32)
        for m in range(self.n_mels):
            lo, ce, hi = hz_pts[m], hz_pts[m + 1], hz_pts[m + 2]
            up = (f - lo) / max(ce - lo, 1e-8)
            down = (hi - f) / max(hi - ce, 1e-8)
            fb[m] = np.clip(np.minimum(up, down), 0, 1)
        return fb

    @staticmethod
    def _hz2mel(f):
        return 2595.0 * np.log10(1.0 + np.asarray(f) / 700.0)

    @staticmethod
    def _mel2hz(m):
        return 700.0 * (10.0 ** (np.asarray(m) / 2595.0) - 1.0)

    def __call__(self, waveform: np.ndarray, sr: int,
                 num_frames: int) -> np.ndarray:
        hop = self.n_fft // 2
        if len(waveform) < self.n_fft:
            waveform = np.pad(waveform, (0, self.n_fft - len(waveform)))
        win = np.hanning(self.n_fft)
        starts = np.arange(0, len(waveform) - self.n_fft + 1, hop)
        frames = np.stack([waveform[s:s + self.n_fft] * win for s in starts])
        spec = np.abs(np.fft.rfft(frames, axis=-1)) ** 2       # [S, bins]
        mel = np.log(spec @ self._mel_filter(sr).T + 1e-6)     # [S, mels]

        # pool spectrogram rows into per-video-frame features
        out = np.zeros((num_frames, self.dim), np.float32)
        spf = max(1, int(round(sr / self.fps / hop)))          # spec/frame
        reps = int(np.ceil(self.dim / self.n_mels))
        for t in range(num_frames):
            seg = mel[t * spf:(t + 1) * spf]
            row = seg.mean(0) if len(seg) else np.zeros(self.n_mels)
            out[t] = np.tile(row, reps)[:self.dim]
        return out


def generate_heatmaps(keypoints: np.ndarray, heatmap_size: Tuple[int, int],
                      sigma: float = 2.0,
                      conf_threshold: float = 0.1) -> np.ndarray:
    """[K, 3] normalized keypoints (x, y, conf) -> [K, H, W] Gaussians."""
    K = keypoints.shape[0]
    H, W = heatmap_size
    gy, gx = np.mgrid[0:H, 0:W].astype(np.float32)
    hm = np.zeros((K, H, W), np.float32)
    for k in range(K):
        x, y, c = keypoints[k]
        if c <= conf_threshold:
            continue
        xs, ys = int(x * W), int(y * H)
        if 0 <= xs < W and 0 <= ys < H:
            d2 = (gx - xs) ** 2 + (gy - ys) ** 2
            hm[k] = np.exp(-d2 / (2.0 * sigma ** 2))
    return hm


class OmniHumanDataset:
    """Map-style dataset over a directory of videos."""

    def __init__(
        self,
        data_dir: str,
        condition_ratios: Optional[Dict[str, float]] = None,
        num_frames: int = 49,
        frame_size: Tuple[int, int] = (256, 256),
        num_keypoints: int = 308,
        heatmap_size: Tuple[int, int] = (64, 64),
        audio_dim: int = 1024,
        fps: float = 16.0,
        cache_dir: Optional[str] = None,
        keypoint_processor=None,
        audio_feature_fn: Optional[Callable] = None,
        tracker: Optional[ProblematicVideoTracker] = None,
        min_quality_score: float = 0.0,
        min_motion_score: float = 0.0,
        seed: int = 0,
    ):
        self.data_dir = Path(data_dir)
        self.condition_ratios = condition_ratios or {
            "text": 1.0, "reference": 1.0, "audio": 0.0, "pose": 0.0}
        self.num_frames = num_frames
        self.frame_size = frame_size
        self.num_keypoints = num_keypoints
        self.heatmap_size = heatmap_size
        self.audio_dim = audio_dim
        self.fps = fps
        self.cache_dir = Path(cache_dir or (self.data_dir / ".omni_cache"))
        self.cache_dir.mkdir(parents=True, exist_ok=True)
        self.keypoint_processor = keypoint_processor
        self.audio_feature_fn = audio_feature_fn or AudioFeatureExtractor(
            dim=audio_dim, fps=fps)
        self.tracker = tracker
        self.rng = np.random.default_rng(seed)

        self.videos = sorted(self.data_dir.rglob("*.mp4"))
        self.annotations = self._load_or_create_annotations()
        self.filtered_data = self._filter(min_quality_score,
                                          min_motion_score)
        logger.info(f"OmniHumanDataset: {len(self.videos)} videos, "
                    f"{len(self.filtered_data)} after filtering")

    # -- probing / annotations ----------------------------------------------

    def _audio_status(self, video: Path) -> bool:
        """Audio availability with a JSON cache (":149-259"). Without
        ffprobe we look for a sidecar .wav."""
        cache = self.cache_dir / "audio_status.json"
        status = {}
        if cache.exists():
            status = json.loads(cache.read_text())
        key = str(video)
        if key not in status:
            has = video.with_suffix(".wav").exists()
            if not has and self.tracker:
                self.tracker.track(key, VideoEvent.NO_AUDIO,
                                   {"reason": "no sidecar wav / no ffprobe"})
            status[key] = has
            cache.write_text(json.dumps(status))
        return status[key]

    def _video_meta(self, video: Path) -> Dict[str, Any]:
        import cv2
        cap = cv2.VideoCapture(str(video))
        meta = {
            "total_frames": int(cap.get(cv2.CAP_PROP_FRAME_COUNT)),
            "fps": cap.get(cv2.CAP_PROP_FPS) or self.fps,
            "width": int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
            "height": int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)),
        }
        cap.release()
        return meta

    def _load_or_create_annotations(self) -> List[Dict]:
        """annotations.json auto-generation (":315-382")."""
        path = self.data_dir / "annotations.json"
        if path.exists():
            return json.loads(path.read_text())
        ann = []
        for v in self.videos:
            try:
                meta = self._video_meta(v)
                if meta["total_frames"] < self.num_frames:
                    if self.tracker:
                        self.tracker.track(str(v),
                                           VideoEvent.VIDEO_TOO_SHORT,
                                           meta)
                ann.append({
                    "relative_path": str(v.relative_to(self.data_dir)),
                    "video_name": v.name,
                    "text": v.stem.replace("_", " "),
                    "has_audio": self._audio_status(v),
                    "has_pose": self.keypoint_processor is not None,
                    "quality_score": 1.0,
                    "motion_score": 1.0,
                    **meta,
                })
            except Exception as e:
                if self.tracker:
                    self.tracker.track(str(v), VideoEvent.PROCESSING_ERROR,
                                       {"error": str(e)})
        if ann:
            path.write_text(json.dumps(ann, indent=1))
        return ann

    def _filter(self, min_q: float, min_m: float) -> List[Dict]:
        """quality/motion + condition availability (":384-408")."""
        out = []
        for item in self.annotations:
            if item.get("quality_score", 1.0) < min_q:
                continue
            if item.get("motion_score", 1.0) < min_m:
                continue
            if (self.condition_ratios.get("audio", 0) >= 1.0
                    and not item.get("has_audio", False)):
                continue
            out.append(item)
        return out

    # -- loading --------------------------------------------------------

    def _load_frames(self, video: Path, start: int) -> np.ndarray:
        """[C, T, H, W] float32 in [-1, 1]."""
        import cv2
        cap = cv2.VideoCapture(str(video))
        cap.set(cv2.CAP_PROP_POS_FRAMES, start)
        frames = []
        for _ in range(self.num_frames):
            ok, frame = cap.read()
            if not ok:
                break
            frame = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
            frame = cv2.resize(frame, self.frame_size[::-1])
            frames.append(frame)
        cap.release()
        if not frames:
            raise RuntimeError("no frames decoded")
        while len(frames) < self.num_frames:   # repeat-pad short clips
            frames.append(frames[-1])
        x = np.stack(frames).astype(np.float32) / 127.5 - 1.0  # [T,H,W,C]
        return x.transpose(3, 0, 1, 2)

    def _load_audio_features(self, video: Path) -> np.ndarray:
        wav_path = video.with_suffix(".wav")
        cache = (self.cache_dir
                 / f"{video.stem}_audio_{self.num_frames}.npy")
        if cache.exists():
            return np.load(cache)
        waveform, sr = read_wav(str(wav_path))
        feats = self.audio_feature_fn(waveform, sr, self.num_frames)
        np.save(cache, feats)
        return feats

    def _keypoints_path(self, video: Path, frame_idx: int) -> Path:
        return self.cache_dir / "keypoints" / (
            f"{video.stem}_{frame_idx:06d}.npy")

    def _load_keypoints(self, video: Path, frames: np.ndarray,
                        start: int) -> np.ndarray:
        """[T, K, 3] from cache or processor (":559-667")."""
        kps = np.zeros((self.num_frames, self.num_keypoints, 3), np.float32)
        for t in range(self.num_frames):
            p = self._keypoints_path(video, start + t)
            if p.exists():
                kps[t] = np.load(p)
            elif self.keypoint_processor is not None:
                img = ((frames[:, t].transpose(1, 2, 0) + 1) * 127.5
                       ).astype(np.uint8)
                k = self.keypoint_processor.extract_keypoints(img)
                if k is None:
                    if self.tracker:
                        self.tracker.track(
                            str(video),
                            VideoEvent.LANDMARK_DETECTION_FAILED,
                            {"frame": start + t})
                    continue
                kps[t] = k
                p.parent.mkdir(parents=True, exist_ok=True)
                np.save(p, k)
        return kps

    # -- sampling -------------------------------------------------------

    def __len__(self) -> int:
        return len(self.filtered_data)

    def _empty_sample(self) -> Dict[str, Any]:
        """zero-filled fallback (":1056-1069")."""
        c = 3
        return {
            "frames": np.zeros((c, self.num_frames, *self.frame_size),
                               np.float32),
            "conditions": {
                "text": "",
                "reference": np.zeros((c, 1, *self.frame_size), np.float32),
            },
            "metadata": {"empty": True},
        }

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        if not 0 <= idx < len(self.filtered_data):
            raise IndexError(idx)
        try:
            item = self.filtered_data[idx]
            video = self.data_dir / item["relative_path"]

            start = 0
            total = item.get("total_frames", 0)
            if total > self.num_frames:
                start = int(self.rng.integers(0, total - self.num_frames))

            frames = self._load_frames(video, start)
            conditions: Dict[str, Any] = {
                "text": item.get("text", ""),
                # first frame as reference (":957")
                "reference": frames[:, :1],
            }
            if (item.get("has_audio") and
                    self.condition_ratios.get("audio", 0) > 0):
                try:
                    conditions["audio"] = self._load_audio_features(video)
                except Exception as e:
                    logger.error(f"audio load failed for {video}: {e}")
                    conditions["audio"] = np.zeros(
                        (self.num_frames, self.audio_dim), np.float32)
            if (item.get("has_pose") and
                    self.condition_ratios.get("pose", 0) > 0):
                kps = self._load_keypoints(video, frames, start)
                hm = np.stack([
                    generate_heatmaps(kps[t], self.heatmap_size)
                    for t in range(self.num_frames)])   # [T, K, H, W]
                conditions["pose"] = hm.transpose(1, 0, 2, 3)  # [K,T,H,W]
            return {"frames": frames, "conditions": conditions,
                    "metadata": {"video": str(video), "start": start}}
        except Exception as e:
            if self.tracker:
                self.tracker.track(
                    str(self.filtered_data[idx].get("relative_path", idx)),
                    VideoEvent.PROCESSING_ERROR, {"error": str(e)})
            logger.error(f"sample {idx} failed: {e}")
            return self._empty_sample()

    def batches(self, batch_size: int, shuffle: bool = True):
        """Host-side batch iterator (stacks numpy, drops remainder)."""
        idx = np.arange(len(self))
        while True:
            if shuffle:
                self.rng.shuffle(idx)
            for i in range(0, len(idx) - batch_size + 1, batch_size):
                samples = [self[j] for j in idx[i:i + batch_size]]
                yield {
                    "frames": np.stack([s["frames"] for s in samples]),
                    "conditions": samples[0]["conditions"].keys(),
                    "samples": samples,
                }


class Wav2VecFeatureExtractor:
    """wav2vec 2.0 features per video frame (JAX `dataset.py:415-449`, the
    reference README's intended extractor): the waveform linearly
    resampled to 16 kHz, the encoder's last hidden state (~50 Hz tokens),
    `num_frames` tokens picked at evenly spaced indices, each tiled /
    truncated to `dim`. The encoder is the port's Wav2Vec2
    (`omni/wav2vec.py`), loaded as `Wav2Vec2AudioFeatures` loads it
    (`model`, a local `checkpoint_path`, or random at `preset`), where
    JAX's calls `transformers.from_pretrained`, which downloads."""

    def __init__(self, checkpoint_path: Optional[str] = None,
                 preset: str = "base", dim: int = 1024, fps: float = 16.0,
                 model=None, device=None):
        from omnihuman_tpu_torch.omni.wav2vec import Wav2Vec2AudioFeatures
        from omnihuman_tpu_torch.pipelines.text2video import resolve_device
        self.device = resolve_device(device)
        self.model = (model.to(self.device) if model is not None else
                      Wav2Vec2AudioFeatures(checkpoint_path, preset=preset,
                                            device=self.device).model)
        self.dim = dim
        self.fps = fps

    def __call__(self, waveform: np.ndarray, sr: int,
                 num_frames: int) -> np.ndarray:
        import torch
        if sr != 16000:   # wav2vec expects 16 kHz
            idx = np.linspace(0, len(waveform) - 1,
                              int(len(waveform) * 16000 / sr))
            waveform = np.interp(idx, np.arange(len(waveform)), waveform)
        with torch.inference_mode():
            out = self.model(torch.from_numpy(np.asarray(
                waveform, np.float32))[None].to(self.device))[0]
        feats = out.float().cpu().numpy()            # [T50hz, hidden]
        # 50 Hz tokens onto video frames, tiled to dim
        idx = np.linspace(0, len(feats) - 1, num_frames).astype(int)
        sel = feats[idx]
        reps = int(np.ceil(self.dim / sel.shape[1]))
        return np.tile(sel, (1, reps))[:, :self.dim].astype(np.float32)
