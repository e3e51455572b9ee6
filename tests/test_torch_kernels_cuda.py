"""The hand-written CUDA kernels (flash forward with and without the LSE,
flash backward dkdv and dq, the VAE's fused resblock conv K3 and fused
upsample conv K4) against their plain PyTorch versions, on the card. A CUDA kernel has no CPU mode, so every test here is marked `cuda`
and skips without a GPU. This file imports no JAX, so it runs on a GPU
machine without it:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda -q --noconftest

Tolerance: 2^-6 x max|plain| in bf16, two ulps at the output's own peak
(the two versions round the bf16 output up to one ulp apart), for the
output and for each gradient; the fp32 LSE within 1e-3 (the kernel sums
exp2 in its own order, the plain version exp). K3 / K4: 2^-6 x the
output's peak; K3's new cache equal to the plain one but on under 1% of
the activations, where the pre-SiLU bf16 rounding falls one step apart
(the fp32 norm sums in another order): at most two ulps of the
activation. A small bf16 VAE decode / encode with the kernels against the
plain fused path: 2^-5 relative L2."""

import pytest
import torch

from omnihuman_tpu_torch.ops.attention import flash_attention
from omnihuman_tpu_torch.configs.wan import VAEConfig
from omnihuman_tpu_torch.models import vae as vae_mod
from omnihuman_tpu_torch.ops import vae_kernels as vk
from omnihuman_tpu_torch.ops.flash_attention import (
    KERNELS, NEG_INF, flash_attention_cuda, flash_attention_plain,
    flash_bwd_cuda, flash_bwd_plain)

CASES = {
    "short_k": dict(lq=300, lk=24, k_lens=None, d=128),
    "long_k_lens": dict(lq=1100, lk=1500, k_lens=(1500, 611), d=128),
    "ragged": dict(lq=1000, lk=777, k_lens=None, d=128),
    "k_len_zero": dict(lq=256, lk=512, k_lens=(512, 0), d=128),
    "lk257": dict(lq=513, lk=257, k_lens=None, d=64),
    "causal_offsets": dict(lq=200, lk=333, k_lens=(333, 300), d=128,
                           causal=True, offsets=(5, 3)),
    "window_offsets": dict(lq=300, lk=300, k_lens=None, d=64,
                           window=(100, 7), offsets=(64, 0)),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_kernel_matches_plain(cuda_device, case):
    c = CASES[case]
    g = torch.Generator(device=cuda_device).manual_seed(0)

    def rnd(length):
        return torch.randn(2, length, 3, c["d"], generator=g,
                           device=cuda_device).to(torch.bfloat16)

    q, k, v = rnd(c["lq"]), rnd(c["lk"]), rnd(c["lk"])
    kl = (None if c["k_lens"] is None
          else torch.tensor(c["k_lens"], dtype=torch.int32,
                            device=cuda_device))
    kw = dict(k_lens=kl, causal=c.get("causal", False),
              window_size=c.get("window", (-1, -1)),
              offsets=c.get("offsets"))
    got = flash_attention_cuda(q, k, v, **kw)
    torch.cuda.synchronize()
    want = flash_attention_plain(q, k, v, **kw)
    tol = 2 ** -6 * want.float().abs().max().item()
    assert (got.float() - want.float()).abs().max().item() <= tol
    if c["k_lens"] is not None and 0 in c["k_lens"]:
        assert got[list(c["k_lens"]).index(0)].abs().max().item() == 0.0


@pytest.mark.cuda
def test_front_end_counts_launches_by_key_length(cuda_device):
    q = torch.randn(2, 64, 2, 128, device=cuda_device)
    short = torch.randn(2, 100, 2, 128, device=cuda_device)
    long = torch.randn(2, 1025, 2, 128, device=cuda_device)
    before = [kn.launches for kn in KERNELS]
    out = flash_attention(q, long, long)           # fp32 in, bf16 kernel
    flash_attention(q, short, short, k_lens=torch.tensor([100, 9]))
    torch.cuda.synchronize()
    assert out.dtype == torch.float32
    assert [kn.launches - b for kn, b in zip(KERNELS, before)] == [1, 1, 0, 0]


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda_device):
    x = torch.zeros(1, 8, 1, 128, device=cuda_device)
    with pytest.raises(TypeError):
        flash_attention_cuda(x, x, x)                # fp32
    y = torch.zeros(1, 8, 1, 32, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        flash_attention_cuda(y, y, y)                # head_dim 32


def _random_case(seed):
    import random
    r = random.Random(seed)
    b, n = r.randint(1, 3), r.randint(1, 4)
    lq, lk = r.randint(1, 700), r.randint(1, 1500)
    k_lens = (None if r.random() < 0.3 else
              tuple(r.choice([0, r.randint(1, lk), lk + 5]) for _ in range(b)))
    causal = r.random() < 0.3
    window = ((r.randint(0, 300), r.choice([-1, r.randint(0, 50)]))
              if r.random() < 0.3 else (-1, -1))
    offsets = ((r.randint(0, 200), r.randint(0, 200))
               if causal or window != (-1, -1) else None)
    return dict(b=b, n=n, lq=lq, lk=lk, d=r.choice([64, 128]),
                k_lens=k_lens, causal=causal, window=window,
                offsets=offsets)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(24))
def test_flash_kernel_matches_plain_on_random_shapes(cuda_device, seed):
    c = _random_case(seed)
    g = torch.Generator(device=cuda_device).manual_seed(seed)

    def rnd(length):
        return torch.randn(c["b"], length, c["n"], c["d"], generator=g,
                           device=cuda_device).to(torch.bfloat16)

    q, k, v = rnd(c["lq"]), rnd(c["lk"]), rnd(c["lk"])
    kl = (None if c["k_lens"] is None
          else torch.tensor(c["k_lens"], dtype=torch.int32,
                            device=cuda_device))
    kw = dict(k_lens=kl, causal=c["causal"], window_size=c["window"],
              offsets=c["offsets"])
    got = flash_attention_cuda(q, k, v, **kw)
    torch.cuda.synchronize()
    want = flash_attention_plain(q, k, v, **kw)
    assert torch.isfinite(got.float()).all(), c
    tol = 2 ** -6 * want.float().abs().max().item()
    assert (got.float() - want.float()).abs().max().item() <= tol, c


def _check_backward(c, g, dev):
    """Forward with the LSE, then the backward kernels, against the plain
    forward and backward on the same bf16 inputs."""
    def rnd(length):
        return torch.randn(c["b"], length, c["n"], c["d"], generator=g,
                           device=dev).to(torch.bfloat16)

    q, k, v, dout = rnd(c["lq"]), rnd(c["lk"]), rnd(c["lk"]), rnd(c["lq"])
    kl = (None if c["k_lens"] is None
          else torch.tensor(c["k_lens"], dtype=torch.int32, device=dev))
    kw = dict(k_lens=kl, causal=c.get("causal", False),
              window_size=c.get("window", (-1, -1)),
              offsets=c.get("offsets"))
    out, lse = flash_attention_cuda(q, k, v, return_lse=True, **kw)
    torch.cuda.synchronize()
    want_out, want_lse = flash_attention_plain(q, k, v, return_lse=True, **kw)
    assert torch.equal(out, flash_attention_cuda(q, k, v, **kw))
    assert (lse - want_lse).abs().max().item() <= 1e-3, c
    got = flash_bwd_cuda(q, k, v, out, lse, dout, **kw)
    torch.cuda.synchronize()
    want = flash_bwd_plain(q, k, v, out, lse, dout, **kw)
    for name, a, b in zip("qkv", got, want):
        assert a.dtype == torch.bfloat16 and a.shape == b.shape
        assert torch.isfinite(a.float()).all(), (name, c)
        tol = 2 ** -6 * b.float().abs().max().item()
        err = (a.float() - b.float()).abs().max().item()
        assert err <= tol, (f"d{name}", err, tol, c)
    if c["k_lens"] is not None:
        for i, n_valid in enumerate(c["k_lens"]):
            if n_valid == 0:
                assert (lse[i] == NEG_INF).all()
                for x in got:
                    assert x[i].abs().max().item() == 0.0
            if n_valid < c["lk"]:     # keys past k_len: dk = dv = 0 exactly
                assert got[1][i, max(n_valid, 0):].abs().max().item() == 0.0
                assert got[2][i, max(n_valid, 0):].abs().max().item() == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_backward_kernels_match_plain(cuda_device, case):
    g = torch.Generator(device=cuda_device).manual_seed(1)
    _check_backward(dict(CASES[case], b=2, n=3), g, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(12))
def test_flash_backward_kernels_match_plain_on_random_shapes(cuda_device,
                                                             seed):
    c = _random_case(100 + seed)
    g = torch.Generator(device=cuda_device).manual_seed(seed)
    _check_backward(c, g, cuda_device)


@pytest.mark.cuda
def test_autograd_function_gradients_match_plain(cuda_device):
    """The front end with requires_grad on the card: forward with the LSE
    and both backward kernels, one launch each, gradients within the
    kernel tolerance of the plain backward."""
    g = torch.Generator(device=cuda_device).manual_seed(2)
    q, k, v = (torch.randn(2, 300, 2, 128, generator=g, device=cuda_device)
               .to(torch.bfloat16).requires_grad_(True) for _ in range(3))
    dout = torch.randn(2, 300, 2, 128, generator=g, device=cuda_device
                       ).to(torch.bfloat16)
    kl = torch.tensor([300, 41], dtype=torch.int32, device=cuda_device)
    before = [kn.launches for kn in KERNELS]
    out = flash_attention(q, k, v, k_lens=kl)
    out.backward(dout)
    torch.cuda.synchronize()
    assert [kn.launches - b for kn, b in zip(KERNELS, before)] == [0, 1, 1, 1]
    with torch.no_grad():
        want_out, lse = flash_attention_plain(q, k, v, k_lens=kl,
                                              return_lse=True)
        want = flash_bwd_plain(q, k, v, want_out, lse, dout, k_lens=kl)
    for a, b in zip((q.grad, k.grad, v.grad), want):
        tol = 2 ** -6 * b.float().abs().max().item()
        assert (a.float() - b.float()).abs().max().item() <= tol


@pytest.mark.cuda
def test_backward_kernel_refuses_what_it_does_not_take(cuda_device):
    x = torch.zeros(1, 8, 1, 128, device=cuda_device, dtype=torch.bfloat16)
    lse = torch.zeros(1, 1, 8, device=cuda_device)
    with pytest.raises(TypeError):
        flash_bwd_cuda(x, x, x, x, lse, x.float())   # fp32 dout
    with pytest.raises(ValueError):
        flash_bwd_cuda(x, x, x, x, lse[..., :4], x)  # lse shape


# ---------------------------------------------------------------------------
# K3 / K4


def _vae_case(seed):
    import random
    r = random.Random(1000 + seed)
    return dict(b=r.randint(1, 2), t=r.choice([1, 2, 4]),
                h=r.randint(1, 40), w=r.randint(1, 70),
                cin=16 * r.randint(1, 8), cout=8 * r.randint(1, 30),
                residual=r.random() < 0.5)


VAE_CASES = {
    "decode_t1_384": dict(b=1, t=1, h=12, w=20, cin=384, cout=384,
                          residual=True),
    "shortcut_192_384": dict(b=1, t=2, h=17, w=33, cin=192, cout=384,
                             residual=False),
    "encoder_96_96": dict(b=1, t=4, h=24, w=40, cin=96, cout=96,
                          residual=True),
    **{f"random_{i}": _vae_case(i) for i in range(12)},
}


def _cl(t):
    return t.contiguous(memory_format=torch.channels_last_3d)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(VAE_CASES))
def test_vae_conv_kernel_matches_plain(cuda_device, case):
    c = VAE_CASES[case]
    g = torch.Generator(device=cuda_device).manual_seed(7)
    b, t, h, w, cin, cout = (c[k] for k in ("b", "t", "h", "w", "cin",
                                            "cout"))

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=cuda_device) * scale

    x = _cl(rnd(b, cin, t, h, w).to(torch.bfloat16))
    cache = _cl(rnd(b, cin, 2, h, w).to(torch.bfloat16))
    gamma = rnd(cin, scale=0.5) + 1.0
    w2 = vk.pack_conv_weights(rnd(3, 3, 3, cin, cout, scale=cin ** -0.5))
    bias = rnd(cout, scale=0.1)
    res = (_cl(rnd(b, cout, t, h, w).to(torch.bfloat16)) if c["residual"]
           else None)
    before = vk.VAE_CONV.launches
    y, cnew = vk.fused_act_causal_conv3d_cuda(x, cache, gamma, w2, bias, res)
    torch.cuda.synchronize()
    assert vk.VAE_CONV.launches == before + 1
    y_want, c_want = vk.fused_act_causal_conv3d_plain(x, cache, gamma, w2,
                                                      bias, res)
    assert y.is_contiguous(memory_format=torch.channels_last_3d)
    assert torch.isfinite(y.float()).all(), c
    tol = 2 ** -6 * y_want.float().abs().max().item()
    assert (y.float() - y_want.float()).abs().max().item() <= tol, c
    diff = (cnew.float() - c_want.float()).abs()
    two_ulps = 2 ** -6 * c_want.float().abs().clamp_min(2 ** -6)
    assert (diff <= two_ulps).all(), c
    assert (diff > 0).float().mean().item() < 1e-2, c


@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(8))
def test_vae_upsample_kernel_matches_plain(cuda_device, seed):
    import random
    r = random.Random(2000 + seed)
    b, t, h, w = r.randint(1, 2), r.choice([1, 2, 4]), r.randint(1, 30), \
        r.randint(1, 60)
    cin, cout = 16 * r.randint(1, 24), 8 * r.randint(1, 24)
    g = torch.Generator(device=cuda_device).manual_seed(seed)
    x = _cl(torch.randn((b, cin, t, h, w), generator=g, device=cuda_device)
            .to(torch.bfloat16))
    w4 = vk.pack_upsample_weights(
        torch.randn((3, 3, cin, cout), generator=g, device=cuda_device)
        * cin ** -0.5)
    bias = torch.randn(cout, generator=g, device=cuda_device) * 0.1
    y = vk.fused_upsample_conv2d_cuda(x, w4, bias)
    torch.cuda.synchronize()
    want = vk.fused_upsample_conv2d_plain(x, w4, bias)
    assert y.shape == (b, cout, t, 2 * h, 2 * w)
    tol = 2 ** -6 * want.float().abs().max().item()
    assert (y.float() - want.float()).abs().max().item() <= tol


@pytest.mark.cuda
def test_vae_kernels_refuse_what_they_do_not_take(cuda_device):
    x = _cl(torch.zeros((1, 16, 1, 4, 4), device=cuda_device,
                        dtype=torch.bfloat16))
    cache = _cl(torch.zeros((1, 16, 2, 4, 4), device=cuda_device,
                            dtype=torch.bfloat16))
    gamma = torch.ones(16, device=cuda_device)
    w2 = torch.zeros((27 * 16, 16), device=cuda_device, dtype=torch.bfloat16)
    bias = torch.zeros(16, device=cuda_device)
    with pytest.raises(TypeError):                   # fp32 x is refused
        vk.fused_act_causal_conv3d_cuda(x.float(), cache, gamma, w2, bias)
    with pytest.raises(ValueError, match="channels_last_3d"):
        vk.fused_act_causal_conv3d_cuda(x.contiguous(), cache, gamma, w2,
                                        bias)
    with pytest.raises(ValueError, match="Cin % 16"):
        vk.fused_upsample_conv2d_cuda(
            _cl(torch.zeros((1, 8, 1, 4, 4), device=cuda_device,
                            dtype=torch.bfloat16)),
            torch.zeros((2, 2, 32, 16), device=cuda_device,
                        dtype=torch.bfloat16), bias)


@pytest.mark.cuda
def test_vae_with_kernels_matches_plain_path(cuda_device):
    """A small bf16 VAE (channels 16-64), batch 2: decode and encode
    through K3 / K4 against the same fused structure through the plain
    versions; every resblock conv and upsample launches its kernel once a
    step."""
    cfg = VAEConfig(base_dim=16, dim_mult=(1, 2, 4, 4), num_res_blocks=1)
    vae = vae_mod.build_vae(cfg, cuda_device, torch.bfloat16, seed=3)
    g = torch.Generator(device=cuda_device).manual_seed(3)
    z = torch.randn((2, 16, 3, 6, 10), generator=g, device=cuda_device)
    video = torch.randn((2, 3, 9, 48, 80), generator=g, device=cuda_device)
    dspec = [it[0] for it in vae_mod.decoder_spec(cfg)]
    espec = [it[0] for it in vae_mod.encoder_spec(cfg)]
    for fn, inp, steps, spec in ((vae_mod.vae_decode, z, 3, dspec),
                                 (vae_mod.vae_encode, video, 3, espec)):
        before = [kn.launches for kn in vk.KERNELS]
        got = fn(vae, inp.to(torch.bfloat16), conv_impl="cuda")
        torch.cuda.synchronize()
        launches = [kn.launches - n for kn, n in zip(vk.KERNELS, before)]
        ups = spec.count("resample") if fn is vae_mod.vae_decode else 0
        assert launches == [steps * 2 * spec.count("res"), steps * ups]
        want = fn(vae, inp.to(torch.bfloat16), conv_impl="plain")
        rel = ((got.float() - want.float()).norm()
               / want.float().norm()).item()
        assert rel <= 2 ** -5, (fn.__name__, rel)
