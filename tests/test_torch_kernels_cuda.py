"""The hand-written CUDA kernels (flash forward with and without the LSE,
the fused flash backward K2, the VAE's fused resblock conv K3 and fused
upsample conv K4) against their plain PyTorch versions, on the card. A
CUDA kernel has no CPU mode, so every test here is marked `cuda`
and skips without a GPU. This file imports no JAX, so it runs on a GPU
machine without it:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda -q --noconftest

Tolerance: 2^-6 x max|plain| in bf16, two ulps at the output's own peak
(the two versions round the bf16 output up to one ulp apart), for the
output and for each gradient; the fp32 LSE within 1e-3 (the kernel sums
exp2 in its own order, the plain version exp). K2 adds each key tile's
dQ into an fp32 accumulator in an order that varies from run to run: two
runs give bit-equal dK and dV and a dQ within one bf16 ulp of each
element (or 2^-16 of dQ's peak, far below any bf16 step there, where
the sum cancels to near 0). K3 / K4: 2^-6 x the
output's peak; K3's new cache equal to the plain one but on under 1% of
the activations, where the pre-SiLU bf16 rounding falls one step apart
(the fp32 norm sums in another order): at most two ulps of the
activation. K3's pre-pass (the activated input and the new cache) is held
to the same two-ulp bound on its own, and two K3 runs give bit-equal
outputs and caches (no atomics, fixed sum orders); two K4 runs give
bit-equal outputs too. A small bf16 VAE decode / encode with the kernels
against the plain fused path: 2^-5 relative L2."""

import pytest
import torch

from omnihuman_tpu_torch.ops.attention import flash_attention
from omnihuman_tpu_torch.configs.wan import TINY_TEST, VAEConfig
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
    assert [kn.launches - b for kn, b in zip(KERNELS, before)] == [1, 1, 0]


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


# shapes at the edges of the forward kernel's tiles (128 query rows a work
# item, 64 a warpgroup, 128 keys a K/V tile), each with and without the
# LSE, at D = 64 and 128
FWD_TILE_CASES = {
    "lq_not_multiple_of_64": dict(b=2, n=2, lq=200, lk=384, k_lens=None),
    "lq_below_64": dict(b=1, n=3, lq=37, lk=256, k_lens=None),
    "lk_not_multiple_of_128": dict(b=1, n=2, lq=256, lk=300, k_lens=None),
    "lk_below_128": dict(b=2, n=2, lq=130, lk=50, k_lens=(50, 37)),
    "k_len_on_tile_boundary": dict(b=2, n=2, lq=192, lk=512,
                                   k_lens=(256, 257)),
    "k_lens_zero_and_full": dict(b=2, n=2, lq=333, lk=260, k_lens=(0, 260)),
    # the first query tiles see one key tile, the last ones all of them
    "causal_empties_tiles": dict(b=1, n=2, lq=700, lk=700, k_lens=None,
                                 causal=True),
    # a band of 164 keys: every work item skips tiles on both sides
    "window_empties_tiles": dict(b=1, n=2, lq=1000, lk=1000, k_lens=None,
                                 window=(100, 63)),
    "causal_offsets": dict(b=2, n=2, lq=300, lk=530, k_lens=(530, 400),
                           causal=True, offsets=(130, 260)),
    # keys 0..299 are seen by no query: rows of empty work items are 0
    "offsets_empty_rows": dict(b=1, n=2, lq=400, lk=400, k_lens=None,
                               causal=True, offsets=(0, 300)),
    "lk257": dict(b=2, n=2, lq=513, lk=257, k_lens=None),
}


def _check_forward(c, g, dev, with_lse):
    """The forward kernel against the plain version: O within 2^-6 of its
    peak, rows with no valid key exactly 0, and with `with_lse` the LSE
    within 1e-3 (NEG_INF on those rows) and O bit-equal to the kernel's
    O without it."""
    def rnd(length):
        return torch.randn(c["b"], length, c["n"], c["d"], generator=g,
                           device=dev).to(torch.bfloat16)

    q, k, v = rnd(c["lq"]), rnd(c["lk"]), rnd(c["lk"])
    kl = (None if c["k_lens"] is None
          else torch.tensor(c["k_lens"], dtype=torch.int32, device=dev))
    kw = dict(k_lens=kl, causal=c.get("causal", False),
              window_size=c.get("window", (-1, -1)),
              offsets=c.get("offsets"))
    got = flash_attention_cuda(q, k, v, return_lse=with_lse, **kw)
    torch.cuda.synchronize()
    want = flash_attention_plain(q, k, v, return_lse=True, **kw)
    out, want_out = (got[0] if with_lse else got), want[0]
    assert torch.isfinite(out.float()).all(), c
    tol = 2 ** -6 * want_out.float().abs().max().item()
    assert (out.float() - want_out.float()).abs().max().item() <= tol, c
    empty = want[1] == NEG_INF                       # [B, N, Lq]
    assert (out.float().abs().amax(-1)[empty.transpose(1, 2)] == 0).all()
    if with_lse:
        lse = got[1]
        assert (lse[empty] == NEG_INF).all()
        assert (lse - want[1]).abs().max().item() <= 1e-3, c
        assert torch.equal(out, flash_attention_cuda(q, k, v, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("with_lse", [False, True])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("case", sorted(FWD_TILE_CASES))
def test_flash_kernel_at_tile_edges(cuda_device, case, d, with_lse):
    g = torch.Generator(device=cuda_device).manual_seed(5)
    _check_forward(dict(FWD_TILE_CASES[case], d=d), g, cuda_device, with_lse)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
def test_flash_forward_run_to_run(cuda_device, d):
    """No atomics: two forwards give bit-equal O and LSE (several work
    items a block, ragged tails, one batch cut by k_lens)."""
    g = torch.Generator(device=cuda_device).manual_seed(6)
    q, k, v = (torch.randn(2, 1500, 3, d, generator=g, device=cuda_device)
               .to(torch.bfloat16) for _ in range(3))
    kl = torch.tensor([1500, 701], dtype=torch.int32, device=cuda_device)
    o1, l1 = flash_attention_cuda(q, k, v, k_lens=kl, return_lse=True)
    o2, l2 = flash_attention_cuda(q, k, v, k_lens=kl, return_lse=True)
    torch.cuda.synchronize()
    assert torch.equal(o1, o2) and torch.equal(l1, l2)


def _check_backward(c, g, dev):
    """Forward with the LSE, then the backward kernel, against the plain
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
    return got, want


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


# shapes at the edges of the backward kernel's tiles (128 keys a block,
# 64 queries a step)
BWD_TILE_CASES = {
    "lq_not_multiple_of_64": dict(b=1, n=2, lq=100, lk=256, k_lens=None,
                                  d=128),
    "lk_not_multiple_of_128": dict(b=1, n=2, lq=192, lk=300, k_lens=None,
                                   d=128),
    "lk_below_128": dict(b=2, n=2, lq=130, lk=77, k_lens=(77, 50), d=128),
    # keys 300.. are seen by no query: whole key tiles write zeros
    "causal_skips_key_tiles": dict(b=1, n=2, lq=600, lk=600, k_lens=None,
                                   d=128, causal=True, offsets=(0, 300)),
    "window_cuts_tiles": dict(b=1, n=2, lq=500, lk=520, k_lens=None, d=128,
                              window=(70, 45), offsets=(0, 0)),
    "k_lens_zero_and_full": dict(b=2, n=2, lq=333, lk=260, k_lens=(0, 260),
                                 d=128),
    "d64_causal_window": dict(b=2, n=3, lq=190, lk=390, k_lens=(390, 131),
                              d=64, causal=True, window=(120, -1),
                              offsets=(150, 0)),
    "d64_long": dict(b=1, n=2, lq=1100, lk=1300, k_lens=None, d=64),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(BWD_TILE_CASES))
def test_flash_backward_kernel_at_tile_edges(cuda_device, case):
    g = torch.Generator(device=cuda_device).manual_seed(3)
    got, want = _check_backward(BWD_TILE_CASES[case], g, cuda_device)
    for a, b in zip(got[1:], want[1:]):    # keys no query sees: exact zeros
        unseen = b.float().abs().amax(-1) == 0
        assert (a.float().abs().amax(-1)[unseen] == 0).all()


@pytest.mark.cuda
def test_flash_backward_run_to_run(cuda_device):
    """dK and dV bit-equal over two runs; dQ, whose fp32 partial sums
    arrive in a varying order, within one bf16 ulp of each element."""
    g = torch.Generator(device=cuda_device).manual_seed(4)
    q, k, v, dout = (torch.randn(1, 2048, 4, 128, generator=g,
                                 device=cuda_device).to(torch.bfloat16)
                     for _ in range(4))
    out, lse = flash_attention_cuda(q, k, v, return_lse=True)
    dq1, dk1, dv1 = flash_bwd_cuda(q, k, v, out, lse, dout)
    dq2, dk2, dv2 = flash_bwd_cuda(q, k, v, out, lse, dout)
    torch.cuda.synchronize()
    assert torch.equal(dk1, dk2) and torch.equal(dv1, dv2)
    a, b = dq1.float(), dq2.float()
    mag = torch.maximum(a.abs(), b.abs())
    ulp = torch.exp2(torch.floor(torch.log2(mag.clamp_min(1e-30))) - 7)
    floor = 2 ** -16 * mag.max()
    assert ((a - b).abs() <= torch.maximum(ulp, floor)).all()


@pytest.mark.cuda
def test_autograd_function_gradients_match_plain(cuda_device):
    """The front end with requires_grad on the card: forward with the LSE
    and the backward kernel, one launch each, gradients within the kernel
    tolerance of the plain backward."""
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
    assert [kn.launches - b for kn, b in zip(KERNELS, before)] == [0, 1, 1]
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


# K3 at its tile edges: H and W off the tile (16 rows at Cout = 96, 8 at
# multiples of 192; 16 columns), W < 16, H = 1, every N path (Cout 96, 192,
# 384), the ragged Cin chunk of 96 channels, B = 2, T in {1, 2, 4}
VAE_TILE_CASES = {
    "h1_w5_96": dict(b=2, t=1, h=1, w=5, cin=96, cout=96, residual=True),
    "h17_w15_96_192": dict(b=1, t=2, h=17, w=15, cin=96, cout=192,
                           residual=False),
    "h9_w33_384": dict(b=2, t=4, h=9, w=33, cin=384, cout=384,
                       residual=True),
    "h16_w16_96": dict(b=1, t=4, h=16, w=16, cin=96, cout=96,
                       residual=False),
    "h8_w17_192": dict(b=2, t=1, h=8, w=17, cin=192, cout=192,
                       residual=True),
    "h23_w47_96_384": dict(b=1, t=2, h=23, w=47, cin=96, cout=384,
                           residual=False),
    "h31_w50_96_b2": dict(b=2, t=4, h=31, w=50, cin=96, cout=96,
                          residual=True),
    "h1_w40_192": dict(b=1, t=4, h=1, w=40, cin=192, cout=192,
                       residual=False),
}


def _vae_conv_inputs(c, dev, seed=7):
    g = torch.Generator(device=dev).manual_seed(seed)
    b, t, h, w, cin, cout = (c[k] for k in ("b", "t", "h", "w", "cin",
                                            "cout"))

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    x = _cl(rnd(b, cin, t, h, w).to(torch.bfloat16))
    cache = _cl(rnd(b, cin, 2, h, w).to(torch.bfloat16))
    gamma = rnd(cin, scale=0.5) + 1.0
    w2 = vk.pack_conv_weights(rnd(3, 3, 3, cin, cout, scale=cin ** -0.5))
    bias = rnd(cout, scale=0.1)
    res = (_cl(rnd(b, cout, t, h, w).to(torch.bfloat16)) if c["residual"]
           else None)
    return x, cache, gamma, w2, bias, res


def _check_vae_conv(c, dev):
    x, cache, gamma, w2, bias, res = _vae_conv_inputs(c, dev)
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
@pytest.mark.parametrize("case", sorted(VAE_CASES))
def test_vae_conv_kernel_matches_plain(cuda_device, case):
    _check_vae_conv(VAE_CASES[case], cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(VAE_TILE_CASES))
def test_vae_conv_kernel_at_tile_edges(cuda_device, case):
    _check_vae_conv(VAE_TILE_CASES[case], cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("cout", [96, 192, 384])
def test_vae_conv_run_to_run(cuda_device, cout):
    """K3 is bitwise deterministic: no atomics, fixed sum orders."""
    c = dict(b=2, t=4, h=20, w=37, cin=96, cout=cout, residual=True)
    args = _vae_conv_inputs(c, cuda_device)
    y1, c1 = vk.fused_act_causal_conv3d_cuda(*args)
    y2, c2 = vk.fused_act_causal_conv3d_cuda(*args)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2) and torch.equal(c1, c2)


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 2, 4])
def test_vae_conv_pre_pass_matches_plain(cuda_device, t):
    """K3's pre-pass: the activated frames a and the new cache (the last
    two frames of [cache, a]) against act_cache_plain, within two bf16
    ulps of each activation and equal on all but under 1% of them (the
    fp32 norm sums in another order); cache frames are copied exactly."""
    c = dict(b=2, t=t, h=13, w=29, cin=96, cout=96, residual=False)
    x, cache, gamma = _vae_conv_inputs(c, cuda_device)[:3]
    a, cnew = vk.act_cache_cuda(x, cache, gamma)
    torch.cuda.synchronize()
    want, c_want = vk.act_cache_plain(x, cache, gamma)
    assert a.is_contiguous(memory_format=torch.channels_last_3d)
    assert cnew.is_contiguous(memory_format=torch.channels_last_3d)
    for got, ref in ((a, want), (cnew, c_want)):
        diff = (got.float() - ref.float()).abs()
        assert (diff <= 2 ** -6 * ref.float().abs().clamp_min(2 ** -6)).all()
        assert (diff > 0).float().mean().item() < 1e-2
    if t == 1:
        assert torch.equal(cnew[:, :, :1], cache[:, :, 1:])
    assert torch.equal(cnew[:, :, -1:], a[:, :, -1:])


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


# K4 at its tile edges: items of 12 low-res rows x 16 columns, so h off
# 12, h = 1, w off 16, w < 16 and the decode's half tile (w = 104); Cout
# 96, 192 and the masked N-blocks of 8, 40, 200; Cin 16 and 96 (32-channel
# K steps), 192 and 384 (64); B = 2; T in {1, 2, 4}
K4_TILE_CASES = {
    "h1_w5_16_8_b2": dict(b=2, t=1, h=1, w=5, cin=16, cout=8),
    "h13_w17_96_96": dict(b=1, t=2, h=13, w=17, cin=96, cout=96),
    "h12_w16_192_192_b2": dict(b=2, t=4, h=12, w=16, cin=192, cout=192),
    "h25_w104_384_192": dict(b=1, t=1, h=25, w=104, cin=384, cout=192),
    "h7_w33_192_40_b2": dict(b=2, t=2, h=7, w=33, cin=192, cout=40),
    "h30_w9_96_200": dict(b=1, t=4, h=30, w=9, cin=96, cout=200),
    "h5_w104_384_96_b2": dict(b=2, t=1, h=5, w=104, cin=384, cout=96),
    "h24_w40_16_192": dict(b=1, t=2, h=24, w=40, cin=16, cout=192),
    "h1_w104_192_96": dict(b=1, t=4, h=1, w=104, cin=192, cout=96),
    "h14_w15_384_8": dict(b=1, t=1, h=14, w=15, cin=384, cout=8),
}


def _vae_upsample_inputs(c, dev, seed=11):
    g = torch.Generator(device=dev).manual_seed(seed)
    b, t, h, w, cin, cout = (c[k] for k in ("b", "t", "h", "w", "cin",
                                            "cout"))
    x = _cl(torch.randn((b, cin, t, h, w), generator=g, device=dev)
            .to(torch.bfloat16))
    w4 = vk.pack_upsample_weights(
        torch.randn((3, 3, cin, cout), generator=g, device=dev) * cin ** -0.5)
    bias = torch.randn(cout, generator=g, device=dev) * 0.1
    return x, w4, bias


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(K4_TILE_CASES))
def test_vae_upsample_kernel_at_tile_edges(cuda_device, case):
    c = K4_TILE_CASES[case]
    x, w4, bias = _vae_upsample_inputs(c, cuda_device)
    before = vk.VAE_UPSAMPLE.launches
    y = vk.fused_upsample_conv2d_cuda(x, w4, bias)
    torch.cuda.synchronize()
    assert vk.VAE_UPSAMPLE.launches == before + 1
    want = vk.fused_upsample_conv2d_plain(x, w4, bias)
    assert y.shape == (c["b"], c["cout"], c["t"], 2 * c["h"], 2 * c["w"])
    assert y.is_contiguous(memory_format=torch.channels_last_3d)
    assert torch.isfinite(y.float()).all(), c
    tol = 2 ** -6 * want.float().abs().max().item()
    assert (y.float() - want.float()).abs().max().item() <= tol, c


@pytest.mark.cuda
@pytest.mark.parametrize("cout", [96, 200])
def test_vae_upsample_run_to_run(cuda_device, cout):
    """K4 is bitwise deterministic: no atomics, fixed sum orders."""
    c = dict(b=2, t=2, h=20, w=37, cin=192, cout=cout)
    x, w4, bias = _vae_upsample_inputs(c, cuda_device)
    y1 = vk.fused_upsample_conv2d_cuda(x, w4, bias)
    y2 = vk.fused_upsample_conv2d_cuda(x, w4, bias)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2)


@pytest.mark.cuda
def test_vae_upsample_takes_kmajor_weights_made_ahead(cuda_device):
    """`wk` made once by upsample_weights_kmajor (as a VAE pass makes it)
    gives the same bits as the call that makes it itself."""
    c = dict(b=1, t=4, h=9, w=21, cin=96, cout=192)
    x, w4, bias = _vae_upsample_inputs(c, cuda_device)
    wk = vk.upsample_weights_kmajor(w4)
    assert wk.shape == (2, 2, 4, 192, 96)
    got = vk.fused_upsample_conv2d_cuda(x, w4, bias, wk)
    want = vk.fused_upsample_conv2d_cuda(x, w4, bias)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="upsample_weights_kmajor"):
        vk.fused_upsample_conv2d_cuda(x, w4, bias, w4)


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
    with pytest.raises(ValueError, match="conv_weights_kmajor"):
        vk.fused_act_causal_conv3d_cuda(x, cache, gamma, w2, bias, wk=w2)
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


@pytest.mark.cuda
def test_vae_auto_conv_impl_takes_torch_where_kernels_refuse(cuda_device):
    """conv_impl="auto" on the card: an fp32 VAE and an 8-channel bf16 VAE
    (TINY_TEST's widths) decode and encode through torch convs, equal to
    conv_impl="torch" and launching no K3 / K4; "cuda" still raises on
    both."""
    tiny = TINY_TEST.vae
    g = torch.Generator(device=cuda_device).manual_seed(8)
    z = torch.randn((1, tiny.z_dim, 2, 4, 6), generator=g, device=cuda_device)
    video = torch.randn((1, 3, 5, 32, 48), generator=g, device=cuda_device)
    for dtype in (torch.float32, torch.bfloat16):
        vae = vae_mod.build_vae(tiny, cuda_device, dtype, seed=4)
        for fn, inp in ((vae_mod.vae_decode, z), (vae_mod.vae_encode, video)):
            inp = inp.to(dtype)
            before = [kn.launches for kn in vk.KERNELS]
            got = fn(vae, inp)
            torch.cuda.synchronize()
            assert [kn.launches for kn in vk.KERNELS] == before
            assert torch.equal(got, fn(vae, inp, conv_impl="torch"))
            with pytest.raises((TypeError, ValueError)):
                fn(vae, inp, conv_impl="cuda")
    fp32 = vae_mod.build_vae(VAEConfig(base_dim=16, dim_mult=(1, 2, 4, 4),
                                       num_res_blocks=1), cuda_device,
                             torch.float32, seed=3)
    zf = torch.randn((1, 16, 2, 4, 6), generator=g, device=cuda_device)
    assert torch.equal(vae_mod.vae_decode(fp32, zf),
                       vae_mod.vae_decode(fp32, zf, conv_impl="torch"))


# ---------------------------------------------------------------------------
# OmniHuman serving: the audio cross-attention's short keys, the omni
# forward on the card, the int8 GEMM

@pytest.mark.cuda
@pytest.mark.parametrize("lq", [700, 25600])
@pytest.mark.parametrize("lk", [13, 21])
def test_flash_kernel_audio_cross_attention(cuda_device, lk, lq):
    """The omni audio cross-attention: B=1, 12 heads, D=128, Lk = the
    window's latent frames (below one 16-key MMA step and odd) with no
    lengths, Lq up to window 2's packed 25,600 tokens: keys lk..127 of the
    one K/V tile are the TMA box's zero fill and must weigh nothing."""
    g = torch.Generator(device=cuda_device).manual_seed(lk * 1000 + lq)

    def rnd(length):
        return torch.randn(1, length, 12, 128, generator=g,
                           device=cuda_device).to(torch.bfloat16)

    q, k, v = rnd(lq), rnd(lk), rnd(lk)
    got = flash_attention_cuda(q, k, v)
    torch.cuda.synchronize()
    want = flash_attention_plain(q, k, v)
    assert torch.isfinite(got.float()).all()
    tol = 2 ** -6 * want.float().abs().max().item()
    assert (got.float() - want.float()).abs().max().item() <= tol


def _omni_card_cfg():
    from omnihuman_tpu_torch.configs.wan import WanModelConfig
    from omnihuman_tpu_torch.omni.model import OmniModelConfig
    base = WanModelConfig(dim=128, ffn_dim=256, num_heads=2, num_layers=2,
                          freq_dim=16, text_dim=24, text_len=8)
    return OmniModelConfig(base=base, audio_dim=20, num_keypoints=8,
                           num_frames=8)


@pytest.mark.cuda
def test_omni_forward_on_card_matches_cpu(cuda_device):
    """The small omni config at head_dim 64 (the kernel's), bf16 weights
    with a random head, adapter `o` and `pose_proj`, every condition and
    motion tokens: the card (K1, cuBLAS, cuDNN's TF32 pose convs) against
    the CPU (the plain attention the CPU tests hold against JAX), within
    5e-2 of max(1, the velocities' peak), the tolerance of the smoke's
    DiT check."""
    from omnihuman_tpu_torch.configs.wan import DTypePolicy
    from omnihuman_tpu_torch.omni.model import (
        build_omni_model, omni_model_forward)
    cfg = _omni_card_cfg()
    model = build_omni_model(cfg, "cpu", torch.bfloat16, seed=3)
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for p in (model.base.head.head.weight, model.cond.pose_proj.weight,
                  *(b.audio_attn.o.weight for b in model.base.blocks)):
            p.normal_(0.0, 0.05, generator=gen)
    gen.manual_seed(6)
    inputs = dict(
        x=torch.randn((1, 16, 3, 8, 8), generator=gen),
        t=torch.tensor([700.0]),
        context=torch.randn((1, 8, 24), generator=gen),
        audio=torch.randn((1, 3, 20), generator=gen),
        pose=torch.rand((1, 8, 3, 16, 16), generator=gen),
        ref_latent=torch.randn((1, 16, 1, 8, 8), generator=gen),
        motion_latent=torch.randn((1, 16, 2, 8, 8), generator=gen),
        context_lens=torch.tensor([5]))
    pol = DTypePolicy(residual=torch.bfloat16)
    outs = {}
    for dev in ("cpu", cuda_device):
        m = model.to(dev)
        with torch.inference_mode():
            outs[str(dev)] = omni_model_forward(
                m, **{k: v.to(dev) for k, v in inputs.items()},
                policy=pol).float().cpu()
    got, want = outs[str(cuda_device)], outs["cpu"]
    assert torch.isfinite(got).all()
    scale = max(1.0, want.abs().max().item())
    assert (got - want).abs().max().item() <= 5e-2 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 16, 17, 4096])
def test_int8_gemm_on_card_bit_equal_to_cpu(cuda_device, rows):
    """torch._int_mm on the card (M <= 16 padded with zero rows) gives the
    CPU path's int32 products bit for bit, and int8_linear the CPU's
    output to fp32 rounding."""
    from omnihuman_tpu_torch.ops import quant
    g = torch.Generator().manual_seed(rows)
    x_q = torch.randint(-127, 128, (rows, 1536), generator=g,
                        dtype=torch.int8)
    w_q = torch.randint(-127, 128, (8960, 1536), generator=g,
                        dtype=torch.int8)
    got = quant._int_mm(x_q.to(cuda_device), w_q.to(cuda_device))
    assert got.dtype == torch.int32
    assert torch.equal(got.cpu(), quant._int_mm(x_q, w_q))
    lin = torch.nn.Linear(1536, 8960)
    x = torch.randn((rows, 1536), generator=g)
    q = quant.Int8Linear.from_linear(lin)
    want = quant.int8_linear(q, x)
    out = quant.int8_linear(q.to(cuda_device), x.to(cuda_device)).cpu()
    assert (out - want).abs().max().item() <= 1e-5 * want.abs().max().item()


@pytest.mark.cuda
def test_quantize_keeps_audio_adapters_on_card(cuda_device):
    from omnihuman_tpu_torch.omni.model import build_omni_model
    from omnihuman_tpu_torch.ops import quant
    model = build_omni_model(_omni_card_cfg(), cuda_device, torch.bfloat16,
                             seed=0)
    quant.quantize_wan_model(model)
    for blk in model.base.blocks:
        assert isinstance(blk.self_attn.q, quant.Int8Linear)
        assert isinstance(blk.ffn[0], quant.Int8Linear)
        assert blk.self_attn.q.w_q.is_cuda
        for name in ("q", "k", "v", "o"):
            assert type(getattr(blk.audio_attn, name)) is torch.nn.Linear
