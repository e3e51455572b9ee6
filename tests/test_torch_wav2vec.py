"""Wav2Vec2 against the JAX package and an HF state dict: the slow cases
of tests/test_torch_omni_audio.py (whose helpers they use), in a file of
their own so that a `--dist loadfile` run schedules them with the files of
few tests, beside the longest ones, instead of before them."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnihuman_tpu.omni import wav2vec as jw
from omnihuman_tpu_torch.omni import wav2vec as pw
# fixtures and helpers of the file these cases came from
from test_torch_omni_audio import _port_model


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
