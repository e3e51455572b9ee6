"""The plain versions of K3 and K4 (ops/vae_kernels.py) against the JAX
Pallas kernels in interpret mode, the weight packers bit for bit, and the
VAE's fused path (conv_impl="plain") against JAX "pallas_interpret".

Inputs are made from seeded numpy and handed to both; JAX arrays are
channels-last [B, T, H, W, C], the port's [B, C, T, H, W] in
channels_last_3d memory is the same buffer permuted.

Tolerances (bf16 outputs): a single kernel call within 2^-7 of the
output's own peak (half an ulp at the peak: both versions sum the same
bf16 products in fp32 in other orders, and the SiLU's fp32 sigmoid may
round one activation one bf16 ulp apart); the cache output equal but for
such one-ulp activations. A whole TINY decode / encode: the JAX test's
own bound for its Pallas path against XLA (tests/test_vae.py: atol 0.15,
RMS 2e-2), since JAX's `fused_viable` sends some TINY layers to XLA with
other bf16 rounding while the port fuses every resblock conv."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnihuman_tpu.configs.wan import TINY_TEST as JAX_TINY
from omnihuman_tpu.models.vae import init_vae
from omnihuman_tpu.models.vae import vae_decode as jax_vae_decode
from omnihuman_tpu.models.vae import vae_encode as jax_vae_encode
from omnihuman_tpu.ops import vae_pallas
from omnihuman_tpu_torch.configs.wan import TINY_TEST
from omnihuman_tpu_torch.models import vae as vae_mod
from omnihuman_tpu_torch.ops import vae_kernels as vk
from omnihuman_tpu_torch.utils.convert import vae_state_dict_from_jax

torch.set_num_threads(1)
CL3D = torch.channels_last_3d


def _port(a: np.ndarray) -> torch.Tensor:
    """JAX channels-last [B, T, H, W, C] -> port [B, C, T, H, W] view."""
    return torch.from_numpy(np.array(a)).permute(0, 4, 1, 2, 3)


def _jax(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 4, 1).float().numpy()


def _bf16(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_packers_bit_equal_to_jax(dtype):
    rng = np.random.default_rng(0)
    w3 = rng.normal(size=(3, 3, 3, 16, 24)).astype(np.float32)
    w2 = rng.normal(size=(3, 3, 32, 16)).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want3 = np.asarray(vae_pallas.pack_conv_weights(
        jnp.asarray(w3, jd)).astype(jnp.float32))
    want4 = np.asarray(vae_pallas.pack_upsample_weights(
        jnp.asarray(w2, jd)).astype(jnp.float32))
    got3 = vk.pack_conv_weights(torch.from_numpy(w3).to(td))
    got4 = vk.pack_upsample_weights(torch.from_numpy(w2).to(td))
    assert got3.dtype == got4.dtype == torch.bfloat16
    np.testing.assert_array_equal(got3.float().numpy(), want3)
    np.testing.assert_array_equal(got4.float().numpy(), want4)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_kmajor_weight_copy_matches_packers(dtype):
    """K3's kernel layout [27, Cout, Cin] holds, element for element, the
    K-packed rows of the port's and the JAX packer: wk[tap, co, ci] =
    w2[tap * Cin + ci, co]."""
    rng = np.random.default_rng(4)
    cin, cout = 32, 24
    w3 = rng.normal(size=(3, 3, 3, cin, cout)).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(vae_pallas.pack_conv_weights(
        jnp.asarray(w3, jd)).astype(jnp.float32))
    w2 = vk.pack_conv_weights(torch.from_numpy(w3).to(td))
    wk = vk.conv_weights_kmajor(w2)
    assert wk.dtype == torch.bfloat16 and wk.is_contiguous()
    assert wk.shape == (27, cout, cin)
    got = wk.float().numpy()
    for tap in range(27):
        for ci in range(cin):
            np.testing.assert_array_equal(got[tap, :, ci],
                                          want[tap * cin + ci])
            np.testing.assert_array_equal(
                got[tap, :, ci], w2[tap * cin + ci].float().numpy())


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_upsample_kmajor_weight_copy_matches_packers(dtype):
    """K4's kernel layout [2, 2, 4, Cout, Cin] holds, element for element,
    the parity rows of the port's and the JAX packer:
    wk[a, b, tap, co, ci] = w4[a, b, tap * Cin + ci, co]."""
    rng = np.random.default_rng(6)
    cin, cout = 32, 24
    w = rng.normal(size=(3, 3, cin, cout)).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(vae_pallas.pack_upsample_weights(
        jnp.asarray(w, jd)).astype(jnp.float32))
    w4 = vk.pack_upsample_weights(torch.from_numpy(w).to(td))
    wk = vk.upsample_weights_kmajor(w4)
    assert wk.dtype == torch.bfloat16 and wk.is_contiguous()
    assert wk.shape == (2, 2, 4, cout, cin)
    got = wk.float().numpy()
    for a in range(2):
        for b in range(2):
            for tap in range(4):
                for ci in range(cin):
                    np.testing.assert_array_equal(
                        got[a, b, tap, :, ci], want[a, b, tap * cin + ci])
                    np.testing.assert_array_equal(
                        got[a, b, tap, :, ci],
                        w4[a, b, tap * cin + ci].float().numpy())


@pytest.mark.parametrize("t", [1, 4])
def test_act_cache_plain_matches_jax_silu_rms(t):
    """K3's pre-pass (a, the activated frames, and the new cache, the last
    two frames of [cache, a]) against the JAX kernel's own activation
    `_silu_rms` with the cache concatenated."""
    rng = np.random.default_rng(20 + t)
    B, H, W, C = 2, 5, 7, 48
    x = np.array(_bf16(rng.normal(size=(B, t, H, W, C)) * 3.0))
    x[0, 0, 0, 0] = 0.0                  # a zero pixel: the 1e-12 floor
    cache = _bf16(rng.normal(size=(B, 2, H, W, C)))
    gamma = (rng.normal(size=(C,)) * 0.5 + 1.0).astype(np.float32)
    act = np.asarray(jax.jit(lambda x, g: vae_pallas._silu_rms(
        x.astype(jnp.float32), g, C))(jnp.asarray(x, jnp.bfloat16), gamma),
        np.float32)
    want = np.concatenate([cache, act], axis=1)
    bf = torch.bfloat16
    a, cnew = vk.act_cache_plain(_port(x).to(bf), _port(cache).to(bf),
                                 torch.from_numpy(gamma))
    assert a.dtype == cnew.dtype == bf
    assert a.shape == (B, C, t, H, W) and cnew.shape == (B, C, 2, H, W)
    assert a.is_contiguous(memory_format=CL3D)
    assert cnew.is_contiguous(memory_format=CL3D)
    # exact but for one-ulp activations (the fp32 sigmoids differ)
    diff = np.abs(_jax(a) - act)
    assert (diff <= 2 ** -7 * np.maximum(np.abs(act), 1.0)).all()
    assert (diff > 0).mean() < 1e-2
    np.testing.assert_array_equal(_jax(cnew), np.concatenate(
        [cache, _jax(a)], axis=1)[:, -2:])
    np.testing.assert_allclose(_jax(cnew), want[:, -2:], rtol=2 ** -7,
                               atol=2 ** -7)


def _k3_inputs(t, residual, seed=11):
    rng = np.random.default_rng(seed)
    B, H, W, Ci, Co = 2, 9, 13, 16, 24
    x = _bf16(rng.normal(size=(B, t, H, W, Ci)))
    cache = _bf16(rng.normal(size=(B, 2, H, W, Ci)))
    gamma = (rng.normal(size=(Ci,)) * 0.5 + 1.0).astype(np.float32)
    w = _bf16(rng.normal(size=(3, 3, 3, Ci, Co)) * 0.1)
    b = (rng.normal(size=(Co,)) * 0.1).astype(np.float32)
    res = _bf16(rng.normal(size=(B, t, H, W, Co))) if residual else None
    return x, cache, gamma, w, b, res


@functools.partial(jax.jit, static_argnames=("residual",))
def _jax_k3(x, cache, gamma, w, b, res, residual):
    xb = x.astype(jnp.bfloat16)
    return vae_pallas.fused_act_causal_conv3d(
        xb, cache.astype(jnp.bfloat16), gamma,
        vae_pallas.pack_conv_weights(w), b,
        residual=res.astype(jnp.bfloat16) if residual else None,
        interpret=True, out_dtype=jnp.bfloat16)


@pytest.mark.parametrize("t,residual", [(4, False), (1, True), (2, True)])
def test_k3_plain_matches_pallas_interpret(t, residual):
    x, cache, gamma, w, b, res = _k3_inputs(t, residual)
    y_want, c_want = _jax_k3(x, cache, gamma, w, b,
                             res if residual else x, residual)
    y_want, c_want = np.asarray(y_want, np.float32), np.asarray(c_want,
                                                                np.float32)
    bf = torch.bfloat16
    y, c = vk.fused_act_causal_conv3d(
        _port(x).to(bf), _port(cache).to(bf), torch.from_numpy(gamma),
        vk.pack_conv_weights(torch.from_numpy(w)), torch.from_numpy(b),
        residual=None if res is None else _port(res).to(bf))
    assert y.dtype == bf and c.dtype == bf
    assert y.shape == (2, 24, t, 9, 13) and c.shape == (2, 16, 2, 9, 13)
    peak = np.abs(y_want).max()
    np.testing.assert_allclose(_jax(y), y_want, atol=2 ** -7 * peak, rtol=0)
    # the cache: exact but for one-ulp activations
    diff = np.abs(_jax(c) - c_want)
    assert (diff <= 2 ** -7 * np.maximum(np.abs(c_want), 1.0)).all()
    assert (diff > 0).mean() < 1e-2
    if t == 1:   # frame 0 of the new cache is the old cache's frame 1
        np.testing.assert_array_equal(_jax(c)[:, 0], cache[:, 1])


def test_k4_plain_matches_pallas_interpret():
    rng = np.random.default_rng(3)
    B, T, h, w, Ci, Co = 1, 2, 10, 14, 32, 16
    x = _bf16(rng.normal(size=(B, T, h, w, Ci)))
    wt = _bf16(rng.normal(size=(3, 3, Ci, Co)) * 0.1)
    b = (rng.normal(size=(Co,)) * 0.1).astype(np.float32)
    want = np.asarray(jax.jit(lambda x, wt, b: vae_pallas.fused_upsample_conv2d(
        x.astype(jnp.bfloat16),
        vae_pallas.pack_upsample_weights(wt.astype(jnp.bfloat16)), b,
        interpret=True))(x, wt, b), np.float32)
    got = vk.fused_upsample_conv2d(
        _port(x).to(torch.bfloat16),
        vk.pack_upsample_weights(torch.from_numpy(wt).to(torch.bfloat16)),
        torch.from_numpy(b))
    assert got.shape == (B, Co, T, 2 * h, 2 * w)
    np.testing.assert_allclose(_jax(got), want,
                               atol=2 ** -7 * np.abs(want).max(), rtol=0)


# ---------------------------------------------------------------------------
# the VAE's fused path


@pytest.fixture(scope="module")
def tiny_vae():
    """bf16 TINY weights with a non-zero attention projection, in both
    packages."""
    params = jax.tree.map(np.asarray,
                          init_vae(jax.random.key(0), JAX_TINY.vae))
    rng = np.random.default_rng(5)
    for layer in params["decoder"] + params["encoder"]:
        if "proj" in layer:
            layer["proj"]["w"] = (rng.normal(size=layer["proj"]["w"].shape)
                                  * 0.2).astype(np.float32)
    params = jax.tree.map(_bf16, params)
    vae = vae_mod.build_vae(TINY_TEST.vae, "cpu", torch.bfloat16, seed=None)
    vae.load_state_dict(vae_state_dict_from_jax(params, TINY_TEST.vae))
    jparams = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), params)
    return jparams, vae


def _record_layouts(monkeypatch):
    """Wrap the plain K3 / K4 so the test sees what the VAE hands them."""
    seen = []

    def wrap(fn):
        def inner(x, *args, **kw):
            seen.append(x.is_contiguous(memory_format=CL3D))
            return fn(x, *args, **kw)
        return inner

    for name in ("fused_act_causal_conv3d_plain",
                 "fused_upsample_conv2d_plain"):
        monkeypatch.setattr(vk, name, wrap(getattr(vk, name)))
    return seen


def _close(got, want):
    a, b = got.float().numpy(), np.asarray(want, np.float32)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, atol=1.5e-1, rtol=1.5e-1)
    assert float(np.sqrt(((a - b) ** 2).mean())) < 2e-2


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


def test_conv_impl_rules(tiny_vae):
    _, vae = tiny_vae
    z = torch.zeros((1, 16, 1, 2, 2), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        vae_mod.vae_decode(vae, z, conv_impl="cuda")
    with pytest.raises(ValueError, match="unknown conv_impl"):
        vae_mod.vae_decode(vae, z, conv_impl="pallas")
    # streaming=False ignores conv_impl, as in JAX
    a = vae_mod.vae_decode(vae, z, streaming=False, conv_impl="cuda")
    b = vae_mod.vae_decode(vae, z, streaming=False, conv_impl="torch")
    assert torch.equal(a, b)


@pytest.mark.parametrize("which", ["decoder", "encoder"])
def test_auto_conv_impl_takes_kernels_only_where_they_fit(which):
    """conv_impl="auto" picks K3 / K4 ("cuda") only for CUDA tensors, bf16
    weights and channels every fused conv of the pass meets; else "torch".
    The VAEs live on the meta device: only their shapes are read."""
    from omnihuman_tpu_torch.configs.wan import VAEConfig

    def layers(cfg, dtype):
        with torch.device("meta"):
            return getattr(vae_mod.WanVAE(cfg).to(dtype), which).layers()

    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    bf16, fp32 = torch.bfloat16, torch.float32
    wan = layers(VAEConfig(), bf16)          # Wan 2.1 widths 96-384
    assert vae_mod.auto_conv_impl(wan, bf16, cuda) == "cuda"
    assert vae_mod.auto_conv_impl(wan, bf16, cpu) == "torch"
    assert vae_mod.auto_conv_impl(layers(VAEConfig(), fp32), fp32,
                                  cuda) == "torch"
    tiny = layers(TINY_TEST.vae, bf16)       # 8 channels: Cin % 16 != 0
    assert vae_mod.auto_conv_impl(tiny, bf16, cuda) == "torch"
    assert vae_mod.auto_conv_impl(tiny, bf16, cpu) == "torch"
    # one conv outside the rule sends the whole pass to torch
    odd = layers(VAEConfig(base_dim=24), bf16)   # 24 -> 24: Cin % 16 != 0
    assert vae_mod.auto_conv_impl(odd, bf16, cuda) == "torch"


def test_cuda_launchers_refuse_cpu_tensors():
    x = torch.zeros((1, 16, 1, 4, 4), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="needs"):
        vk.fused_act_causal_conv3d_cuda(
            x, x.repeat(1, 1, 2, 1, 1), torch.ones(16),
            torch.zeros((27 * 16, 16), dtype=torch.bfloat16), torch.zeros(16))
    with pytest.raises(ValueError, match="needs"):
        vk.fused_upsample_conv2d_cuda(
            x, torch.zeros((2, 2, 64, 16), dtype=torch.bfloat16),
            torch.zeros(16))
