"""The VAE's fused path (conv_impl="plain", the plain K3 / K4) against JAX
"pallas_interpret" over whole decode and encode passes: the slow cases of
tests/test_torch_vae_kernels.py (whose fixture and helpers they use), in
a file of their own so that a `--dist loadfile` run schedules them with
the files of few tests, beside the longest ones, instead of before them."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from omnihuman_tpu.configs.wan import TINY_TEST as JAX_TINY
from omnihuman_tpu.models.vae import vae_decode as jax_vae_decode
from omnihuman_tpu.models.vae import vae_encode as jax_vae_encode
from omnihuman_tpu_torch.configs.wan import TINY_TEST
from omnihuman_tpu_torch.models import vae as vae_mod
# fixtures and helpers of the file these cases came from
from test_torch_vae_kernels import _close, _record_layouts, tiny_vae


def test_decode_plain_matches_pallas_interpret(tiny_vae, monkeypatch):
    jparams, vae = tiny_vae
    z = np.random.default_rng(7).normal(size=(1, 16, 3, 4, 4))
    want = jax.jit(lambda p, z: jax_vae_decode(
        p, z, JAX_TINY.vae, streaming=True, clamp=False,
        conv_impl="pallas_interpret"))(jparams, jnp.asarray(z, jnp.bfloat16))
    seen = _record_layouts(monkeypatch)
    got = vae_mod.vae_decode(vae, torch.from_numpy(z).to(torch.bfloat16),
                             streaming=True, clamp=False, conv_impl="plain")
    # 3 latent frames x (2 convs a resblock + the upsamples), every one
    # handed over channels-last
    spec = [it[0] for it in vae_mod.decoder_spec(TINY_TEST.vae)]
    assert len(seen) == 3 * (2 * spec.count("res") + spec.count("resample"))
    assert all(seen)
    _close(got, want)


def test_encode_plain_matches_pallas_interpret(tiny_vae, monkeypatch):
    jparams, vae = tiny_vae
    x = np.random.default_rng(5).normal(size=(1, 3, 5, 16, 16)) * 0.5
    want = jax.jit(lambda p, x: jax_vae_encode(
        p, x, JAX_TINY.vae, streaming=True,
        conv_impl="pallas_interpret"))(jparams, jnp.asarray(x, jnp.bfloat16))
    seen = _record_layouts(monkeypatch)
    got = vae_mod.vae_encode(vae, torch.from_numpy(x).to(torch.bfloat16),
                             streaming=True, conv_impl="plain")
    spec = [it[0] for it in vae_mod.encoder_spec(TINY_TEST.vae)]
    assert len(seen) == 2 * 2 * spec.count("res") and all(seen)   # 2 chunks
    _close(got, want)


def test_fused_path_at_batch_2(tiny_vae, monkeypatch):
    """Time slices of a batch > 1 are not channels_last_3d-contiguous: the
    fused path must still hand the kernels channels-last tensors, and
    each sample must come out as it does alone (to a bf16 ulp: the CPU
    convs block a batch of 2 otherwise)."""
    _, vae = tiny_vae
    rng = np.random.default_rng(8)
    z = torch.from_numpy(rng.normal(size=(2, 16, 2, 2, 2))).to(torch.bfloat16)
    x = torch.from_numpy(rng.normal(size=(2, 3, 5, 16, 16)) * 0.5
                         ).to(torch.bfloat16)
    seen = _record_layouts(monkeypatch)
    for fn, inp in ((vae_mod.vae_decode, z), (vae_mod.vae_encode, x)):
        both = fn(vae, inp, conv_impl="plain")
        for i in range(2):
            one = fn(vae, inp[i:i + 1], conv_impl="plain")
            peak = one.float().abs().max().item()
            torch.testing.assert_close(both[i:i + 1].float(), one.float(),
                                       atol=2 ** -7 * peak, rtol=0)
    assert seen and all(seen)
