"""The port's audio and pose inputs against the JAX package, on the CPU:
`read_wav`, the log-mel `AudioFeatureExtractor` and `generate_heatmaps`
(numpy copies, held exactly equal), and the Wav2Vec2 encoder and its
per-frame features (held to 1e-4 in fp32 against JAX, the port's weights
carried across by the JAX package's own `convert_wav2vec`, and to 1e-4
against HF transformers' `Wav2Vec2Model`, whose state dict the port loads
strictly)."""

import wave

import numpy as np
import pytest
import torch

from omnihuman_tpu.omni import dataset as jds
from omnihuman_tpu_torch.omni import dataset as pds
from omnihuman_tpu_torch.omni import wav2vec as pw

torch.set_num_threads(1)


def _write_wav(path, data: bytes, width: int, channels: int, sr: int):
    with wave.open(str(path), "wb") as f:
        f.setnchannels(channels)
        f.setsampwidth(width)
        f.setframerate(sr)
        f.writeframes(data)


@pytest.mark.parametrize("width,channels", [(2, 1), (2, 2), (4, 1), (1, 1)])
def test_read_wav_equals_jax(tmp_path, width, channels):
    rng = np.random.default_rng(width * 10 + channels)
    dt = {1: np.uint8, 2: np.int16, 4: np.int32}[width]
    info = np.iinfo(dt)
    raw = rng.integers(info.min, info.max, 3000 * channels).astype(dt)
    path = tmp_path / "a.wav"
    _write_wav(path, raw.tobytes(), width, channels, 22050)
    got, sr = pds.read_wav(str(path))
    want, want_sr = jds.read_wav(str(path))
    assert sr == want_sr == 22050 and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("sr,samples,frames", [(16000, 24000, 24),
                                               (44100, 300, 5)])
def test_log_mel_features_equal_jax(sr, samples, frames):
    wav = np.random.default_rng(sr).normal(size=samples).astype(np.float32)
    got = pds.AudioFeatureExtractor(dim=1024)(wav, sr, frames)
    want = jds.AudioFeatureExtractor(dim=1024)(wav, sr, frames)
    assert got.shape == (frames, 1024)
    np.testing.assert_array_equal(got, want)


def test_heatmaps_equal_jax():
    rng = np.random.default_rng(2)
    kps = rng.uniform(-0.1, 1.1, (40, 3)).astype(np.float32)
    kps[::5, 2] = 0.05                       # below the confidence floor
    got = pds.generate_heatmaps(kps, (24, 40))
    np.testing.assert_array_equal(got, jds.generate_heatmaps(kps, (24, 40)))
    assert got.shape == (40, 24, 40) and got.max() > 0.9


def _port_model(preset, seed=0):
    return pw.build_wav2vec(pw.WAV2VEC2_PRESETS[preset], "cpu", seed=seed)
