"""The port's W-sharded VAE (`vae_decode / vae_encode(spatial=)`, models/
vae.py over parallel/spatial.py) on `VirtualRanks` against the JAX package.

The decode and encode at R = 2, 4, 8 and an uneven R = 3, with conv_impl
"torch" against JAX's `vae_decode / vae_encode(spatial_sharding=P(None,
None, None, ("data", "fsdp", "sp"), None))` on its 8-device CPU mesh,
tests/test_vae_mesh.py's config and shapes (the attention projection
randomised so the middle block counts): 2e-4, that test's tolerance; with
conv_impl "plain" (the kernels' plain versions, which round to bf16 where
K3 / K4 do) against the port's unsharded "plain" pass: every conv stage is
bit-equal, and the gathered attention's products at another query count
differ by rounding only, held to 1e-6. A recorded run's ranks replayed
alone give their shards of the same video.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from omnihuman_tpu.configs.wan import VAEConfig as JaxVAEConfig
from omnihuman_tpu.models.vae import init_vae
from omnihuman_tpu.models.vae import vae_decode as jax_decode
from omnihuman_tpu.models.vae import vae_encode as jax_encode
from omnihuman_tpu.parallel import MeshConfig as JaxMeshConfig
from omnihuman_tpu.parallel import create_mesh as jax_create_mesh
from omnihuman_tpu_torch.configs.wan import VAEConfig
from omnihuman_tpu_torch.models.vae import build_vae, vae_decode, vae_encode
from omnihuman_tpu_torch.parallel.spatial import VirtualRanks
from omnihuman_tpu_torch.utils.convert import vae_state_dict_from_jax

torch.set_num_threads(1)

VAE_KW = dict(base_dim=8, z_dim=16, dim_mult=(1, 1, 1, 1), num_res_blocks=1,
              temporal_downsample=(False, True, True))
JCFG_VAE, PCFG_VAE = JaxVAEConfig(**VAE_KW), VAEConfig(**VAE_KW)
RANKS = (2, 4, 8, 3)


def _t(a):
    return torch.from_numpy(np.array(a))


def _compiled(fn, *args):
    """fn(*args) as one program compiled without XLA's costly passes."""
    return jax.jit(fn).lower(*args).compile(compiler_options={
        "xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True})(*args)


@pytest.fixture(scope="module")
def vae_setup():
    params = jax.tree.map(np.asarray, _compiled(
        lambda k: init_vae(k, JCFG_VAE), jax.random.key(0)))
    rng = np.random.default_rng(5)
    for part in ("encoder", "decoder"):
        for layer in params[part]:
            if "proj" in layer:
                layer["proj"]["w"] = (rng.normal(size=layer["proj"]["w"].shape)
                                      * 0.2).astype(np.float32)
    vae = build_vae(PCFG_VAE, "cpu", torch.float32, seed=None)
    vae.load_state_dict(vae_state_dict_from_jax(params, PCFG_VAE),
                        strict=True)
    rng = np.random.default_rng(0)
    z = rng.normal(size=(1, 16, 3, 8, 16)).astype(np.float32)
    vid = (rng.normal(size=(1, 3, 9, 64, 128)) * 0.3).astype(np.float32)
    mesh = jax_create_mesh(JaxMeshConfig(data=2, fsdp=2, sp=2))
    sh = NamedSharding(mesh, P(None, None, None, ("data", "fsdp", "sp"),
                               None))
    jp = jax.tree.map(jnp.asarray, params)
    want_dec = np.asarray(_compiled(lambda p, z: jax_decode(
        p, z, JCFG_VAE, streaming=True, conv_impl="xla",
        spatial_sharding=sh), jp, jnp.asarray(z)))
    want_enc = np.asarray(_compiled(lambda p, v: jax_encode(
        p, v, JCFG_VAE, streaming=True, conv_impl="xla",
        spatial_sharding=sh), jp, jnp.asarray(vid)))
    plain = {"decode": vae_decode(vae, _t(z), conv_impl="plain"),
             "encode": vae_encode(vae, _t(vid), conv_impl="plain")}
    return vae, z, vid, want_dec, want_enc, plain


@pytest.mark.parametrize("impl", ["torch", "plain"])
def test_w_sharded_decode_matches_jax(vae_setup, impl):
    vae, z, _, want, _, plain = vae_setup
    for ranks in RANKS:
        got = vae_decode(vae, _t(z), conv_impl=impl,
                         spatial=VirtualRanks(ranks))
        assert got.shape == (1, 3, 9, 64, 128)
        if impl == "torch":
            np.testing.assert_allclose(got.numpy(), want, atol=2e-4,
                                       rtol=2e-4, err_msg=f"R = {ranks}")
        else:
            torch.testing.assert_close(got, plain["decode"], rtol=0,
                                       atol=1e-6, msg=f"R = {ranks}")


@pytest.mark.parametrize("impl", ["torch", "plain"])
def test_w_sharded_encode_matches_jax(vae_setup, impl):
    vae, _, vid, _, want, plain = vae_setup
    for ranks in RANKS:
        got = vae_encode(vae, _t(vid), conv_impl=impl,
                         spatial=VirtualRanks(ranks))
        assert got.shape == (1, 16, 3, 8, 16)
        if impl == "torch":
            np.testing.assert_allclose(got.numpy(), want, atol=2e-4,
                                       rtol=2e-4, err_msg=f"R = {ranks}")
        else:
            torch.testing.assert_close(got, plain["encode"], rtol=0,
                                       atol=1e-6, msg=f"R = {ranks}")


def test_w_sharded_decode_replays_each_rank_alone(vae_setup):
    """A recorded run's ranks replay alone (the smoke times them so) and
    give their shards of the same video."""
    from omnihuman_tpu_torch.models.vae import (
        WShard, shard_inputs, vae_decode_shard)
    vae, z, _, _, _, _ = vae_setup
    vr = VirtualRanks(4, record=True)
    whole = vae_decode(vae, _t(z), conv_impl="plain", spatial=vr)
    widths, shards = shard_inputs(_t(z), 4, 1)
    for r in range(4):
        out = vae_decode_shard(vae, shards[r], WShard(vr.replay(r), widths),
                               conv_impl="plain")
        start = 8 * sum(widths[:r])
        torch.testing.assert_close(out, whole[..., start:start + out.shape[-1]],
                                   rtol=0, atol=0)
