"""omni_generate, its windows and cli.omni_inference on the CPU against
the JAX package: the slow cases of tests/test_torch_omni.py (whose helpers
they use), in a file of their own so that a `--dist loadfile` run
schedules them with the files of few tests, beside the longest ones,
instead of before them."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from omnihuman_tpu.pipelines.omni import omni_generate as jax_generate
from omnihuman_tpu.pipelines.omni import omni_generate_windowed as jax_windowed
from omnihuman_tpu_torch.pipelines import omni as omni_pipe
# fixtures and helpers of the file these cases came from
from test_torch_omni import (
    _contexts, _j, _run_exact, _t, _write_inputs, B, C, F, H, JCFG, JFP32,
    omni, PFP32, W)


def test_omni_generate_matches_jax(omni):
    params, model, batch = omni
    rng = np.random.default_rng(5)
    noise = rng.normal(size=(B, C, F, H, W)).astype(np.float32)
    ctx, ctx_null = _contexts(rng, B)
    lens = np.array([6, 8], np.int32)
    nlens = np.array([3, 7], np.int32)
    kw = dict(sampling_steps=2, cfg_scale=5.0, shift=1.0)

    def ref(p, noise, ctx, ctx_null, audio, pose, ref_lat, lens, nlens):
        return jax_generate(p, noise, ctx, ctx_null, cfg=JCFG, policy=JFP32,
                            audio=audio, pose=pose, ref_latent=ref_lat,
                            context_lens=lens, null_lens=nlens, **kw)

    want = _run_exact(ref, _j(params), noise, ctx, ctx_null,
                      batch["audio"], batch["pose"], batch["ref_latent"],
                      lens, nlens)
    got = omni_pipe.omni_generate(
        model, _t(noise), _t(ctx), _t(ctx_null), policy=PFP32,
        audio=_t(batch["audio"]), pose=_t(batch["pose"]),
        ref_latent=_t(batch["ref_latent"]), context_lens=_t(lens),
        null_lens=_t(nlens), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3)


def test_omni_generate_windowed_matches_jax(omni, monkeypatch):
    """Two windows of 3 latent frames trimmed to 5, audio and pose tracks
    of 4 frames (the second window repeats their last frame), motion
    tokens of 1 frame; the port draws each window's noise from JAX's key,
    as the JAX package does (`fold_in(key, window)`)."""
    params, model, _ = omni
    rng = np.random.default_rng(9)
    f_win, total, seed = 3, 5, 17
    shape = (1, C, f_win, H, W)
    ctx, ctx_null = _contexts(rng, 1)
    audio = rng.normal(size=(1, 4, 20)).astype(np.float32)
    pose = (rng.normal(size=(1, 8, 4, 2 * H, 2 * W)) * 0.1).astype(
        np.float32)
    ref_lat = rng.normal(size=(1, C, 1, H, W)).astype(np.float32)
    kw = dict(sampling_steps=2, cfg_scale=4.0, shift=1.0)

    want = jax_windowed(
        _j(params), jax.random.key(seed), cfg=JCFG, latent_shape=shape,
        context=jnp.asarray(ctx), context_null=jnp.asarray(ctx_null),
        total_frames=total, motion_frames=1, audio=jnp.asarray(audio),
        pose=jnp.asarray(pose), ref_latent=jnp.asarray(ref_lat),
        policy=JFP32, **kw)

    def jax_noise(s, window, shp, device):
        key = jax.random.fold_in(jax.random.key(s), window)
        return _t(np.asarray(jax.random.normal(key, shp, jnp.float32)))

    monkeypatch.setattr(omni_pipe, "window_noise", jax_noise)
    timings = {}
    got = omni_pipe.omni_generate_windowed(
        model, seed, latent_shape=shape, context=_t(ctx),
        context_null=_t(ctx_null), total_frames=total, motion_frames=1,
        audio=_t(audio), pose=_t(pose), ref_latent=_t(ref_lat),
        timings=timings, policy=PFP32, **kw)
    assert got.shape == (1, C, total, H, W)
    assert len(timings["windows_s"]) == 2
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3)


@pytest.mark.parametrize("precision", ["fast", "int8"])
def test_cli_writes_video_on_cpu(tmp_path, precision):
    """Two windows (3 latent frames, 2 a window, 1 motion frame), log-mel
    audio, through `main`; int8 quantizes the base blocks."""
    from omnihuman_tpu_torch.cli.omni_inference import main
    img, wav = _write_inputs(tmp_path)
    out = main(["--task", "tiny-test", "--reference_image", img,
                "--audio", wav, "--size", "64*64", "--num_frames", "2",
                "--total_frames", "3", "--motion_frames", "1",
                "--num_inference_steps", "2", "--precision", precision,
                "--device", "cpu", "--output", str(tmp_path / "o.mp4")])
    assert os.path.exists(out) and os.path.getsize(out) > 0
