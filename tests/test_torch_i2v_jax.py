"""The i2v DiT, the i2v mask and the one-step forward against the JAX
package: the slow cases of tests/test_torch_i2v.py (whose helpers they
use), in a file of their own so that a `--dist loadfile` run schedules
them with the files of few tests, beside the longest ones, instead of
before them."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from omnihuman_tpu.configs.wan import TINY_TEST as JAX_TINY
from omnihuman_tpu.models.vae import vae_decode as jax_vae_decode
from omnihuman_tpu.ops.rope import rope_angles_3d as jax_rope_angles
from omnihuman_tpu.pipelines import image2video as jax_i2v
from omnihuman_tpu.pipelines.wan_inference import _one_step as jax_one_step
from omnihuman_tpu_torch.configs.wan import TINY_TEST
from omnihuman_tpu_torch.models.vae import vae_decode
from omnihuman_tpu_torch.ops.rope import rope_angles_3d
from omnihuman_tpu_torch.pipelines.image2video import WanI2V
from omnihuman_tpu_torch.pipelines.wan_inference import one_step_latents
# fixtures and helpers of the file these cases came from
from test_torch_i2v import (
    _i2v_inputs, _jax_forward, _port_forward, F32, GRID, i2v_pair, JAX_F32,
    SEQ, t2v_pair)


def test_i2v_dit_matches_jax(i2v_pair):
    params, model = i2v_pair
    inp, t = _i2v_inputs(), np.array([999.0, 312.5], np.float32)
    want = np.asarray(_jax_forward(params, inp["x"], t, inp["ctx"],
                                   inp["clip"], inp["y"], None))
    got = _port_forward(model, inp, t, inp["ctx"])
    assert got.shape == (2, 16, 2, 4, 6)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_first_frame_mask_and_latent_size_match_jax():
    for frames, lh, lw in ((9, 4, 4), (81, 60, 104), (1, 2, 2)):
        want = np.asarray(jax_i2v.WanI2V.first_frame_mask(frames, lh, lw))
        got = WanI2V.first_frame_mask(frames, lh, lw).numpy()
        np.testing.assert_array_equal(got, want)
    jax_pipe = jax_i2v.WanI2V.__new__(jax_i2v.WanI2V)
    jax_pipe.vae_stride, jax_pipe.patch_size = (4, 8, 8), (1, 2, 2)
    port_pipe = WanI2V.__new__(WanI2V)
    port_pipe.vae_stride, port_pipe.patch_size = (4, 8, 8), (1, 2, 2)
    for hw, area in (((480, 832), 480 * 832), ((1080, 1920), 720 * 1280),
                     ((40, 40), 32 * 32), ((333, 517), 480 * 832)):
        assert port_pipe.latent_size_for(hw, area) == \
            jax_pipe.latent_size_for(hw, area)


def test_one_step_matches_jax(t2v_pair):
    params, vae_params, pipe = t2v_pair
    rng = np.random.default_rng(10)
    noise = rng.normal(size=(2, 16, 2, 4, 6)).astype(np.float32)
    ctx = rng.normal(size=(2, 16, 32)).astype(np.float32)
    lens = np.array([9, 16], np.int32)
    sin, cos = jax_rope_angles(GRID, JAX_TINY.model.head_dim, seq_len=SEQ)
    v = jax_one_step(params, jnp.asarray(noise), jnp.asarray(ctx),
                     JAX_TINY.model, SEQ, sin, cos, JAX_F32, 1000.0,
                     context_lens=jnp.asarray(lens))
    want = np.asarray(jax.jit(lambda p, z: jax_vae_decode(
        p, z, JAX_TINY.vae, streaming=True))(vae_params, noise - v))
    psin, pcos = rope_angles_3d(GRID, TINY_TEST.model.head_dim, seq_len=SEQ)
    lat = one_step_latents(pipe.model, torch.from_numpy(noise),
                           torch.from_numpy(ctx), seq_len=SEQ, rope_sin=psin,
                           rope_cos=pcos, policy=F32, t_final=1000.0,
                           context_lens=torch.from_numpy(lens))
    got = vae_decode(pipe.vae, lat, streaming=True)
    assert got.shape == (2, 3, 5, 32, 48)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3)
