"""The serving half of omnihuman_tpu/omni/dataset.py: numpy copies of
`read_wav` (`:49`), `AudioFeatureExtractor` (`:68`) and
`generate_heatmaps` (`:132`), the same arithmetic line for line, so both
packages turn the same wav and keypoints into the same arrays.
`OmniHumanDataset` (the training data plane) is not ported yet.
"""

from __future__ import annotations

import wave
from typing import Tuple

import numpy as np


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
