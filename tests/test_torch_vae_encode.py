"""The port's VAE encode against JAX `vae_encode` at TINY_TEST, fp32,
streaming and full, and the encode -> decode round trip of the two.

Tolerance: fp32 1e-4 on the latent (same convolutions, other summation
order; the latent is de-normalised by stds down to 1.1, so it is ~3x the
pixel-level error of the decode test)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnihuman_tpu.configs.wan import TINY_TEST as JAX_TINY
from omnihuman_tpu.models.vae import init_vae
from omnihuman_tpu.models.vae import vae_encode as jax_vae_encode
from omnihuman_tpu_torch.configs.wan import TINY_TEST
from omnihuman_tpu_torch.models.vae import build_vae, vae_decode, vae_encode
from omnihuman_tpu_torch.utils.convert import vae_state_dict_from_jax

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def vae_pair():
    params = jax.tree.map(np.asarray,
                          init_vae(jax.random.key(2), JAX_TINY.vae))
    rng = np.random.default_rng(6)
    for layer in params["encoder"]:     # a contributing attention block
        if "proj" in layer:
            layer["proj"]["w"] = (rng.normal(size=layer["proj"]["w"].shape)
                                  * 0.2).astype(np.float32)
    vae = build_vae(TINY_TEST.vae, "cpu", torch.float32, seed=None)
    vae.load_state_dict(vae_state_dict_from_jax(params, TINY_TEST.vae),
                        strict=True)
    return jax.tree.map(jnp.asarray, params), vae


@functools.partial(jax.jit, static_argnames=("streaming",))
def _jax_encode(params, x, streaming):
    return jax_vae_encode(params, x, JAX_TINY.vae, streaming=streaming)


@pytest.mark.parametrize("streaming", [True, False])
def test_vae_encode_matches_jax(vae_pair, streaming):
    params, vae = vae_pair
    x = (np.random.default_rng(4).normal(size=(1, 3, 9, 16, 24)) * 0.5
         ).astype(np.float32)
    want = np.asarray(_jax_encode(params, jnp.asarray(x), streaming))
    got = vae_encode(vae, torch.from_numpy(x), streaming=streaming)
    assert got.shape == (1, 16, 3, 2, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


def test_vae_encode_streaming_equals_full(vae_pair):
    _, vae = vae_pair
    x = torch.from_numpy((np.random.default_rng(8).normal(
        size=(1, 3, 5, 8, 8)) * 0.5).astype(np.float32))
    a = vae_encode(vae, x, streaming=True)
    b = vae_encode(vae, x, streaming=False)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)


def test_encode_then_decode_shapes(vae_pair):
    """[B, 3, 1 + 4k, H, W] -> latent [B, 16, 1 + k, H/8, W/8] -> video of
    the input's shape."""
    _, vae = vae_pair
    x = torch.zeros((2, 3, 5, 16, 8))
    z = vae_encode(vae, x)
    assert z.shape == (2, 16, 2, 2, 1)
    assert vae_decode(vae, z).shape == x.shape
