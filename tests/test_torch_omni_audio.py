"""The port's audio and pose inputs against the JAX package, on the CPU:
`read_wav`, the log-mel `AudioFeatureExtractor` and `generate_heatmaps`
(numpy copies, held exactly equal), and the Wav2Vec2 encoder and its
per-frame features (held to 1e-4 in fp32 against JAX, the port's weights
carried across by the JAX package's own `convert_wav2vec`, and to 1e-4
against HF transformers' `Wav2Vec2Model`, whose state dict the port loads
strictly)."""

import dataclasses
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnihuman_tpu.omni import dataset as jds
from omnihuman_tpu.omni import wav2vec as jw
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


@pytest.mark.parametrize("preset", ["tiny-test", "tiny-test-stable"])
def test_wav2vec_forward_matches_jax(preset):
    """The port's random weights -> JAX params through the JAX package's
    `convert_wav2vec`. The config inferred from the port's state dict is
    the preset but for the head count, which no state dict holds (both
    packages take hidden // 64 off the released sizes); JAX also takes
    the positional conv to be the released models' (kernel 128, 16
    groups)."""
    model = _port_model(preset)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    cfg = jw.WAV2VEC2_PRESETS[preset]
    assert pw.infer_wav2vec_config(sd) == dataclasses.replace(
        pw.WAV2VEC2_PRESETS[preset], heads=1)
    assert jw.infer_wav2vec_config(sd) == dataclasses.replace(
        cfg, heads=1, num_conv_pos_embeddings=128,
        num_conv_pos_embedding_groups=16)
    params = jw.convert_wav2vec(sd, cfg)
    wav = np.random.default_rng(1).normal(size=(2, 3000)).astype(np.float32)
    want = jax.jit(lambda p, w: jw.wav2vec_forward(p, w, cfg))(
        params, jnp.asarray(wav))
    with torch.no_grad():
        got = model(torch.from_numpy(wav))
    assert got.shape == (2, cfg.num_tokens(3000), cfg.hidden)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("preset", ["tiny-test", "tiny-test-stable"])
def test_wav2vec_loads_hf_state_dict(preset):
    from transformers import Wav2Vec2Config as HFConfig
    from transformers import Wav2Vec2Model as HFModel
    cfg = pw.WAV2VEC2_PRESETS[preset]
    torch.manual_seed(0)
    hf = HFModel(HFConfig(
        conv_dim=list(cfg.conv_dim), conv_stride=list(cfg.conv_stride),
        conv_kernel=list(cfg.conv_kernel), conv_bias=cfg.conv_bias,
        feat_extract_norm=cfg.feat_extract_norm, hidden_size=cfg.hidden,
        num_hidden_layers=cfg.layers, num_attention_heads=cfg.heads,
        intermediate_size=cfg.ffn,
        num_conv_pos_embeddings=cfg.num_conv_pos_embeddings,
        num_conv_pos_embedding_groups=cfg.num_conv_pos_embedding_groups,
        do_stable_layer_norm=cfg.do_stable_layer_norm, hidden_dropout=0.0,
        attention_dropout=0.0, feat_proj_dropout=0.0, layerdrop=0.0)).eval()
    model = pw.build_wav2vec(cfg, "cpu", seed=None)
    model.load_state_dict(pw._port_names(hf.state_dict()), strict=True)
    wav = torch.from_numpy(np.random.default_rng(3).normal(
        size=(1, 2500)).astype(np.float32))
    with torch.no_grad():
        want = hf(wav).last_hidden_state
        got = model(wav)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4)


def test_wav2vec_features_match_jax(tmp_path):
    """Resampling from 22.05 kHz, normalisation and per-frame pooling; the
    checkpoint path (a local torch file) gives the same features."""
    model = _port_model("tiny-test", seed=4)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    cfg = jw.WAV2VEC2_PRESETS["tiny-test"]
    wav = np.random.default_rng(5).normal(size=22050).astype(np.float32)
    want = jw.Wav2Vec2AudioFeatures(
        dim=48, params=jw.convert_wav2vec(sd, cfg), cfg=cfg)(wav, 22050, 21)
    got = pw.Wav2Vec2AudioFeatures(dim=48, model=model, device="cpu")(
        wav, 22050, 21)
    assert got.shape == (21, 48) and np.std(got, axis=0).max() > 0
    np.testing.assert_allclose(got, want, atol=1e-4)
    path = tmp_path / "w2v.pt"
    torch.save(model.state_dict(), path)
    again = pw.Wav2Vec2AudioFeatures(
        checkpoint_path=str(path), dim=48, device="cpu",
        cfg=pw.WAV2VEC2_PRESETS["tiny-test"])(wav, 22050, 21)
    np.testing.assert_array_equal(again, got)
    short = pw.Wav2Vec2AudioFeatures(dim=16, model=model, device="cpu")(
        np.zeros(10, np.float32), 16000, 4)
    assert short.shape == (4, 16) and np.isfinite(short).all()
