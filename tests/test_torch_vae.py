"""The port's VAE decode against JAX `vae_decode`, streaming and full.

Tolerance: fp32 1e-4 on pixels in [-1, 1] (same convolutions, other
summation order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnihuman_tpu.configs.wan import TINY_TEST as JAX_TINY
from omnihuman_tpu.models.vae import init_vae, vae_decode as jax_vae_decode
from omnihuman_tpu.utils.convert import convert_vae
from omnihuman_tpu_torch.configs.wan import TINY_TEST
from omnihuman_tpu_torch.models.vae import build_vae, vae_decode
from omnihuman_tpu_torch.utils.convert import vae_state_dict_from_jax

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def vae_pair():
    params = jax.tree.map(np.asarray,
                          init_vae(jax.random.key(0), JAX_TINY.vae))
    # the attention projection is zero-initialised: randomise it so the
    # middle attention block contributes
    rng = np.random.default_rng(5)
    for layer in params["decoder"]:
        if "proj" in layer:
            layer["proj"]["w"] = (rng.normal(size=layer["proj"]["w"].shape)
                                  * 0.2).astype(np.float32)
    vae = build_vae(TINY_TEST.vae, "cpu", torch.float32, seed=None)
    vae.load_state_dict(vae_state_dict_from_jax(params, TINY_TEST.vae),
                        strict=True)
    return params, vae


@pytest.mark.parametrize("streaming", [True, False])
def test_vae_decode_matches_jax(vae_pair, streaming):
    params, vae = vae_pair
    z = np.random.default_rng(1).normal(size=(1, 16, 3, 4, 6)
                                        ).astype(np.float32)
    want = jax_vae_decode(jax.tree.map(jnp.asarray, params), jnp.asarray(z),
                          JAX_TINY.vae, streaming=streaming)
    got = vae_decode(vae, torch.from_numpy(z), streaming=streaming)
    assert got.shape == (1, 3, 9, 32, 48)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_vae_streaming_equals_full_unclamped(vae_pair):
    _, vae = vae_pair
    z = torch.from_numpy(np.random.default_rng(2).normal(
        size=(1, 16, 3, 2, 2)).astype(np.float32))
    a = vae_decode(vae, z, streaming=True, clamp=False)
    b = vae_decode(vae, z, streaming=False, clamp=False)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)


def test_vae_state_dict_round_trips_through_jax_converter(vae_pair):
    params, vae = vae_pair
    sd = {k: v.numpy() for k, v in vae.state_dict().items()}
    back = convert_vae(sd, JAX_TINY.vae)
    for part in ("encoder", "conv1", "decoder", "conv2"):
        flat_a = jax.tree_util.tree_leaves_with_path(params[part])
        flat_b = dict(jax.tree_util.tree_leaves_with_path(back[part]))
        assert len(flat_a) == len(flat_b)
        for path, leaf in flat_a:
            np.testing.assert_array_equal(np.asarray(flat_b[path]), leaf)
