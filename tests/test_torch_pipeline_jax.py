"""The t2v pipeline's sampling, decode and hash-tokenizer generation
against the JAX package: the slow cases of tests/test_torch_pipeline.py
(whose fixtures and helpers they use), in a file of their own so that a
`--dist loadfile` run schedules them with the files of few tests, beside
the longest ones, instead of before them."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from omnihuman_tpu.configs.wan import DTypePolicy as JaxPolicy
from omnihuman_tpu.configs.wan import TINY_TEST as JAX_TINY
from omnihuman_tpu.models.vae import vae_decode as jax_vae_decode
from omnihuman_tpu.pipelines.text2video import sample as jax_sample
from omnihuman_tpu_torch.models.vae import vae_decode
# fixtures and helpers of the file these cases came from
from test_torch_pipeline import (
    _inputs, _port_sample, CTX_LENS, pipe, SEQ, weights)


def test_sample_and_decode_match_jax(weights):
    params, vae_params, model, vae = weights
    noise, ctx, ctx_null = _inputs()
    want = jax_sample(
        jax.tree.map(jnp.asarray, params), jnp.asarray(noise),
        jnp.asarray(ctx), jnp.asarray(ctx_null), model_cfg=JAX_TINY.model,
        policy=JaxPolicy(compute=jnp.float32), patch_size=(1, 2, 2),
        seq_len=SEQ, shift=5.0, solver="unipc", steps=3, guide_scale=5.0,
        num_train_timesteps=1000,
        context_lens=jnp.asarray(np.array(CTX_LENS, np.int32)))
    got = _port_sample(model, noise, ctx, ctx_null)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3)

    video_want = jax_vae_decode(jax.tree.map(jnp.asarray, vae_params),
                                want, JAX_TINY.vae, streaming=True)
    video_got = vae_decode(vae, got, streaming=True)
    assert video_got.shape == (1, 3, 9, 64, 64)
    np.testing.assert_allclose(video_got.numpy(), np.asarray(video_want),
                               atol=1e-3)


def test_generate_end_to_end_through_hash_tokenizer(pipe):
    video = pipe.generate("a cat walking in the rain", size=(64, 64),
                          frame_num=5, sampling_steps=2, seed=3)
    assert video.shape == (3, 5, 64, 64)
    assert torch.isfinite(video).all()
    assert video.min() >= -1.0 and video.max() <= 1.0
    assert pipe._t5 is not None                  # encoder kept after use
    again = pipe.generate("a cat walking in the rain", size=(64, 64),
                          frame_num=5, sampling_steps=2, seed=3)
    torch.testing.assert_close(video, again, rtol=0, atol=0)
    assert set(pipe.timings) >= {"t5_encode_s", "denoise_s", "vae_decode_s"}
