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
against the plain fused path: 2^-5 relative L2. block_norm (the DiT
block's residual sites): x' bit-equal to the eager chain on the card, h
within one bf16 step of it (see `_bn_h_within_one_ulp`), run to run
bit-equal, its gradient the eager chain's. qk_norm_rope (the attention's
q / k RMSNorm and RoPE): the norm within one step of the eager `rms_norm`,
its rotation bit-equal to `apply_rope` of it, the whole within two bf16
steps of each pair's magnitude of the eager chain, run to run bit-equal,
its gradient the eager chain's."""

import pytest
import torch

from omnihuman_tpu_torch.ops.attention import flash_attention
from omnihuman_tpu_torch.configs.wan import TINY_TEST, VAEConfig
from omnihuman_tpu_torch.models import vae as vae_mod
from omnihuman_tpu_torch.ops import vae_kernels as vk
from omnihuman_tpu_torch.ops.flash_attention import (
    KERNELS, NEG_INF, flash_attention_cuda, flash_attention_plain,
    flash_bwd_cuda, flash_bwd_plain, flash_fwd_op)

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
@pytest.mark.parametrize("lk", [300, 1500])
def test_custom_op_is_the_kernel(cuda_device, lk):
    """torch.ops.omnihuman_tpu_torch.flash_fwd on CUDA tensors launches K1:
    bit-equal to flash_attention_cuda, with and without the LSE; opcheck
    (schema, fake, dispatch) passes; each call moves K1's count by one."""
    g = torch.Generator(device=cuda_device).manual_seed(3)
    q = torch.randn(2, 200, 2, 128, generator=g,
                    device=cuda_device).to(torch.bfloat16)
    k, v = (torch.randn(2, lk, 2, 128, generator=g,
                        device=cuda_device).to(torch.bfloat16)
            for _ in range(2))
    kl = torch.tensor([lk, lk // 3], dtype=torch.int32, device=cuda_device)
    kernel = KERNELS[0] if lk > 1024 else KERNELS[1]
    op = torch.ops.omnihuman_tpu_torch.flash_fwd
    for with_lse in (False, True):
        before = kernel.launches
        out, lse = op(q, k, v, kl, None, False, -1, -1, 0, 0, with_lse)
        torch.cuda.synchronize()
        assert kernel.launches == before + 1
        want = flash_attention_cuda(q, k, v, kl, return_lse=with_lse)
        if with_lse:
            assert torch.equal(out, want[0]) and torch.equal(lse, want[1])
        else:
            assert torch.equal(out, want) and lse.numel() == 0
    torch.library.opcheck(flash_fwd_op,
                          (q, k, v, kl, 0.1, True, -1, -1, 4, 0, True))


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


@pytest.mark.cuda
@pytest.mark.parametrize("lq", [3584, 22528])
@pytest.mark.parametrize("lk", [13, 49])
def test_flash_backward_audio_cross_attention(cuda_device, lk, lq):
    """K2 at the omni audio cross-attention: B=1, 12 heads, D=128, Lk the
    audio frames (49 pixel frames in training, 13 latent frames at
    inference), one key block of 128 with the rest zero fill, every
    64-query tile streamed through it up to the 22,528-token step."""
    g = torch.Generator(device=cuda_device).manual_seed(lk * 7 + lq)
    _check_backward(dict(b=1, n=12, d=128, lq=lq, lk=lk, k_lens=None), g,
                    cuda_device)


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
def test_omni_train_step_on_card_matches_cpu(cuda_device):
    """One omni training step at the small config (head_dim 64), fp32
    parameters with a random head, adapter `o` and `pose_proj`, every
    condition, the same draws: on the card (K1 forward and remat
    recompute, K2 backward) against the CPU (plain attention), the loss,
    the grad norm and every gradient within 5e-2 of max(1, its peak); the
    card step launches K1 twice and K2 once per attention."""
    from omnihuman_tpu_torch.configs.wan import DTypePolicy
    from omnihuman_tpu_torch.omni.model import build_omni_model
    from omnihuman_tpu_torch.omni.trainer import (
        init_omni_train_state, make_lr_schedule, make_omni_optimizer,
        omni_flow_matching_loss, omni_train_step)
    cfg = _omni_card_cfg()
    model = build_omni_model(cfg, "cpu", torch.float32, seed=3,
                             trainable=True)
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for p in (model.base.head.head.weight, model.cond.pose_proj.weight,
                  *(b.audio_attn.o.weight for b in model.base.blocks)):
            p.normal_(0.0, 0.05, generator=gen)
    gen.manual_seed(6)
    batch = dict(frames=torch.randn((1, 16, 3, 8, 8), generator=gen),
                 context=torch.randn((1, 8, 24), generator=gen),
                 audio=torch.randn((1, 9, 20), generator=gen),
                 pose=torch.rand((1, 8, 3, 16, 16), generator=gen),
                 reference=torch.randn((1, 16, 1, 8, 8), generator=gen))
    masks = {k: torch.ones(1) for k in ("audio", "pose", "reference")}
    t, noise = torch.tensor([0.3]), torch.randn((1, 16, 3, 8, 8),
                                                generator=gen)
    pol = DTypePolicy()
    res = {}
    for dev in ("cpu", cuda_device):
        m = model.to(dev)
        b = {k: v.to(dev) for k, v in batch.items()}
        mk = {k: v.to(dev) for k, v in masks.items()}
        params = dict(m.named_parameters())
        loss = omni_flow_matching_loss(m, b, mk, t.to(dev), noise.to(dev),
                                       policy=pol)
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True,
                                    materialize_grads=True)
        res[str(dev)] = (loss.item(), [x.float().cpu() for x in grads])
    for kn in KERNELS:
        kn.launches = 0
    opt = make_omni_optimizer(make_lr_schedule("constant", 1e-4, 1))
    state = init_omni_train_state(model, opt)
    state, metrics = omni_train_step(
        state, {k: v.to(cuda_device) for k, v in batch.items()},
        {k: v.to(cuda_device) for k, v in masks.items()}, t.to(cuda_device),
        noise.to(cuda_device), optimizer=opt, policy=pol)
    torch.cuda.synchronize()
    layers = cfg.base.num_layers
    assert [kn.launches for kn in KERNELS] == [0, 6 * layers, 3 * layers]
    (l_cpu, g_cpu), (l_gpu, g_gpu) = res["cpu"], res[str(cuda_device)]
    assert abs(l_gpu - l_cpu) <= 5e-2 * max(1.0, abs(l_cpu))
    assert abs(float(metrics["loss"]) - l_cpu) <= 5e-2 * max(1.0, abs(l_cpu))
    norm_cpu = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(x) for x in g_cpu])).item()
    assert (abs(float(metrics["grad_norm"]) - norm_cpu)
            <= 5e-2 * max(1.0, norm_cpu))
    for a, b in zip(g_gpu, g_cpu):
        assert torch.isfinite(a).all()
        assert (a - b).abs().max().item() <= 5e-2 * max(
            1.0, b.abs().max().item())
    assert state.step == 1 and all(
        torch.isfinite(p).all() for p in state.params().values())


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


@pytest.mark.cuda
def test_ring_forward_hop_over_4_virtual_ranks(cuda_device):
    """The ring's per-rank program (ops/ring_attention.py), replayed for 4
    virtual ranks on one card: each rank's query quarter through
    `ring_forward_hop` over every K / V quarter in ring order, K1 with the
    LSE on each hop and the fp32 merge from the second hop on, equals one
    K1 call over the whole;
    the last quarter holds only masked keys for one sample (its hop LSE is
    the kernel's -1e30 on every row)."""
    from omnihuman_tpu_torch.ops.ring_attention import ring_forward_hop
    g = torch.Generator(device=cuda_device).manual_seed(4)
    sp, lq = 4, 320

    def rnd():
        return torch.randn(2, sp * lq, 3, 128, generator=g,
                           device=cuda_device).to(torch.bfloat16)

    q, k, v = rnd(), rnd(), rnd()
    kl = torch.tensor([sp * lq - 5, 2 * lq + 17], dtype=torch.int32,
                      device=cuda_device)
    want = flash_attention_cuda(q, k, v, k_lens=kl)
    outs = []
    for r in range(sp):
        qs = q[:, r * lq:(r + 1) * lq].contiguous()
        o = lse = None
        for i in range(sp):
            src = (r + i) % sp
            chunk = slice(src * lq, (src + 1) * lq)
            o, lse = ring_forward_hop(
                qs, k[:, chunk].contiguous(), v[:, chunk].contiguous(),
                (kl - src * lq).clamp(0, lq), o, lse, (r * lq, src * lq),
                scale=128 ** -0.5)
        outs.append(o.to(torch.bfloat16))
    got = torch.cat(outs, dim=1)
    assert torch.isfinite(got.float()).all()
    tol = 2 ** -6 * want.float().abs().max().item()
    assert (got.float() - want.float()).abs().max().item() <= tol


# -- block_norm: the DiT block's residual sites in one pass ------------------

BN_SITES = ("A", "B", "C", "C_audio_norm", "C_audio_gate", "D")


def _bn_inputs(b, l, d, rd, dev, seed, shard=False):
    """x (rd) and y (bf16) [b, l, d], the six AdaLN slices of e [b, 6, d]
    (1% of the channels at std 64, as a trained DiT's), a norm's bf16
    weight and bias, the audio adapter's scalar gate. With `shard`, x and y
    are the second quarter of a 4 x l sequence (an sp-4 rank's rows: packed
    in each batch, batches apart)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    lf = 4 * l if shard else l

    def rows():
        return torch.randn(b, lf, d, generator=g, device=dev)

    x, y = (rows() * 2 + 0.3).to(rd), rows().to(torch.bfloat16)
    if shard:
        x, y = x.narrow(1, l, l), y.narrow(1, l, l)
    e = torch.randn(b, 6, d, generator=g, device=dev) * 0.5
    e[..., : max(1, d // 100)] *= 128.0
    w = (1 + 0.1 * torch.randn(d, generator=g, device=dev)).to(torch.bfloat16)
    bias = (0.02 * torch.randn(d, generator=g, device=dev)).to(torch.bfloat16)
    gate = torch.tensor(0.7, device=dev)
    return x, y, [e[:, i:i + 1] for i in range(6)], w, bias, gate


def _bn_site(site, x, y, e, w, bias, gate, h_dtype=torch.bfloat16):
    """`add_norm`'s arguments at a site of `_block_forward`."""
    sa_shift, sa_scale, sa_gate, ff_shift, ff_scale, ff_gate = e
    kw = {"A": dict(shift=sa_shift, scale=sa_scale),
          "B": dict(y=y, gate=sa_gate, weight=w, bias=bias),
          "C": dict(y=y, shift=ff_shift, scale=ff_scale),
          "C_audio_norm": dict(y=y, weight=w, bias=bias),
          "C_audio_gate": dict(y=y, gate=gate, round_inner=False,
                               shift=ff_shift, scale=ff_scale),
          "D": dict(y=y, gate=ff_gate, norm=False)}[site]
    full = dict(y=None, gate=None, round_inner=True, norm=True, weight=None,
                bias=None, shift=None, scale=None)
    full.update(kw)
    return (x, full["y"], full["gate"], full["round_inner"], full["norm"],
            full["weight"], full["bias"], full["shift"], full["scale"], 1e-6,
            h_dtype)


def _bn_h_within_one_ulp(got, want):
    """bf16 h against the eager h: one bf16 step of each element, its
    magnitude floored at 2^-8 of its row's peak. The two differ only by
    the order of the row's two sums, which moves an element by a few fp32
    ulps of the row's mean and scale: a step of bf16 anywhere but at the
    few elements within 2^-8 of the row's peak of 0, where it is held to a
    step at that floor (2^-16 of the peak)."""
    gf, wf = got.float(), want.float()
    peak = wf.abs().amax(-1, keepdim=True)
    mag = torch.maximum(wf.abs(), peak * 2.0 ** -8).clamp_min(2.0 ** -126)
    step = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return bool(((gf - wf).abs() <= step).all())


@pytest.mark.cuda
@pytest.mark.parametrize("rd", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("rows", ["65536", "8192_sp4_shard", "4097"])
@pytest.mark.parametrize("d", [1536, 5120])
def test_block_norm_kernel_matches_eager(cuda_device, d, rows, rd):
    """Every site form at the published widths: x' bit-equal to the eager
    chain on the card, h within one bf16 step (`_bn_h_within_one_ulp`);
    the launch count moves by one a site."""
    from omnihuman_tpu_torch.ops.block_norm import (
        BLOCK_NORM, add_norm_cuda, add_norm_eager)
    b, l, shard = {"65536": (2, 32768, False), "8192_sp4_shard": (2, 4096, True),
                   "4097": (1, 4097, False)}[rows]
    inputs = _bn_inputs(b, l, d, rd, cuda_device, seed=d + l, shard=shard)
    for site in BN_SITES:
        args = _bn_site(site, *inputs)
        before = BLOCK_NORM.launches
        xo, h = add_norm_cuda(*args)
        torch.cuda.synchronize()
        assert BLOCK_NORM.launches == before + 1
        want_x, want_h = add_norm_eager(*args)
        if args[1] is None:
            assert xo.numel() == 0
        else:
            assert xo.dtype == rd and torch.equal(xo, want_x), site
        if want_h is None:
            assert h.numel() == 0
        else:
            assert h.dtype == torch.bfloat16, site
            assert _bn_h_within_one_ulp(h, want_h), site


@pytest.mark.cuda
def test_block_norm_fp32_h_and_fp32_y(cuda_device):
    """h in fp32 (the fp32-compute policy) and y in fp32 (fp32 weights):
    x' bit-equal, h within 2^-16 of its row's peak (a few fp32 ulps of
    the row's mean and scale, times the modulation's 1 + scale)."""
    from omnihuman_tpu_torch.ops.block_norm import (
        add_norm_cuda, add_norm_eager)
    x, y, e, w, bias, gate = _bn_inputs(2, 300, 256, torch.bfloat16,
                                        cuda_device, seed=7)
    for site in BN_SITES:
        args = list(_bn_site(site, x, y.float(), e, w.float(), bias.float(),
                             gate, h_dtype=torch.float32))
        xo, h = add_norm_cuda(*args)
        want_x, want_h = add_norm_eager(*args)
        if args[1] is not None:
            assert torch.equal(xo, want_x), site
        if want_h is not None:
            peak = want_h.abs().amax(-1, keepdim=True)
            assert h.dtype == torch.float32
            assert ((h - want_h).abs() <= 2.0 ** -16 * peak).all(), site


@pytest.mark.cuda
def test_block_norm_run_to_run(cuda_device):
    from omnihuman_tpu_torch.ops.block_norm import add_norm_cuda
    for d in (1536, 5120):
        inputs = _bn_inputs(2, 8192, d, torch.bfloat16, cuda_device, seed=d)
        for site in BN_SITES:
            args = _bn_site(site, *inputs)
            a, b = add_norm_cuda(*args), add_norm_cuda(*args)
            assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]), site


@pytest.mark.cuda
@pytest.mark.parametrize("rd", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_block_norm_gradient_is_the_eager_chains(cuda_device, rd):
    """The op's backward on the card (the eager chain on the saved inputs,
    differentiated) against the eager chain's own, every site form at dim
    1536: the same but for the order in which x's gradient sums its
    paths."""
    from omnihuman_tpu_torch.ops.block_norm import add_norm_eager, add_norm_op
    inputs = _bn_inputs(2, 1024, 1536, rd, cuda_device, seed=11)
    for site in BN_SITES:
        args = _bn_site(site, *inputs)
        grads = []
        for fn in (add_norm_op, add_norm_eager):
            a = [t.detach().clone().requires_grad_()
                 if isinstance(t, torch.Tensor) else t for t in args]
            xo, h = fn(*a)
            xo = a[0] if a[1] is None else xo
            g = torch.Generator(device=cuda_device).manual_seed(5)
            loss = (xo.float() * torch.randn(xo.shape, generator=g,
                                             device=cuda_device)).sum()
            if h is not None and h.numel():
                loss = loss + (h.float() * torch.randn(
                    h.shape, generator=g, device=cuda_device)).sum()
            loss.backward()
            grads.append([t.grad for t in a if isinstance(t, torch.Tensor)])
        for got, want in zip(*grads):
            assert (got is None) == (want is None), site
            if got is not None:
                # one step of the element's dtype at the tensor's peak
                ulp = 2.0 ** -7 if got.dtype == torch.bfloat16 else 2.0 ** -20
                tol = ulp * want.float().abs().max().item()
                assert (got.float() - want.float()).abs().max() <= tol, site


@pytest.mark.cuda
def test_block_norm_refuses_what_it_does_not_take(cuda_device):
    from omnihuman_tpu_torch.ops.block_norm import add_norm_cuda
    x, y, e, w, bias, gate = _bn_inputs(2, 64, 256, torch.bfloat16,
                                        cuda_device, seed=1)
    site = _bn_site("B", x, y, e, w, bias, gate)

    def call(**change):
        names = ("x", "y", "gate", "round_inner", "norm", "weight", "bias",
                 "shift", "scale", "eps", "h_dtype")
        args = dict(zip(names, site))
        args.update(change)
        return add_norm_cuda(*args.values())

    with pytest.raises(TypeError):
        call(x=x.half())                              # a dtype it lacks
    with pytest.raises(TypeError):
        call(y=y.half())
    with pytest.raises(TypeError):
        call(h_dtype=torch.float16)
    with pytest.raises(TypeError):
        call(gate=e[2].to(torch.bfloat16))            # vectors are fp32
    for d in (12, 6152):                              # dim % 8, dim > 6144
        xd, yd, ed, wd, bd, _ = _bn_inputs(1, 4, d, torch.bfloat16,
                                           cuda_device, seed=2)
        with pytest.raises(ValueError):
            add_norm_cuda(*_bn_site("B", xd, yd, ed, wd, bd, gate))
    with pytest.raises(ValueError):                   # rows not contiguous
        call(x=x.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError):
        call(y=torch.empty(2, 64, 512, device=cuda_device,
                           dtype=torch.bfloat16)[..., ::2])
    with pytest.raises(ValueError):
        call(x=x.cpu())


@pytest.mark.cuda
def test_block_norm_launches_per_dit_forward(cuda_device):
    """A DiT forward launches the kernel 4 times a block (5 with the audio
    adapters), with the gradient recorded too; per-block remat's
    recompute launches it again, the op's backward (the eager chain) not."""
    from omnihuman_tpu_torch.configs.wan import (
        TINY_TEST_HD128, DTypePolicy)
    from omnihuman_tpu_torch.models.wan_dit import build_wan_model
    from omnihuman_tpu_torch.ops.block_norm import BLOCK_NORM
    from omnihuman_tpu_torch.ops.rope import rope_angles_3d
    cfg = TINY_TEST_HD128.model
    pol = DTypePolicy(residual=torch.bfloat16)
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn((1, cfg.in_dim, 2, 4, 6), generator=g, device=cuda_device)
    ctx = torch.randn((1, cfg.text_len, cfg.text_dim), generator=g,
                      device=cuda_device)
    sin, cos = rope_angles_3d((2, 2, 3), cfg.head_dim, seq_len=16,
                              device=cuda_device)
    kw = dict(seq_len=16, rope_sin=sin, rope_cos=cos, policy=pol)
    t = torch.tensor([500.0], device=cuda_device)
    n = cfg.num_layers
    for trainable, remat, want in ((False, False, (4 * n, 4 * n)),
                                   (True, False, (4 * n, 4 * n)),
                                   (True, True, (4 * n, 8 * n))):
        model = build_wan_model(cfg, cuda_device, torch.bfloat16, seed=0,
                                trainable=trainable)
        before = BLOCK_NORM.launches
        with torch.set_grad_enabled(trainable):
            v = model(x, t, ctx, remat=remat, **kw)
        torch.cuda.synchronize()
        forward = BLOCK_NORM.launches - before
        if trainable:
            v.float().square().mean().backward()
            grads = [p.grad for p in model.parameters() if p.requires_grad]
            assert all(g is not None and torch.isfinite(g).all()
                       for g in grads)
        torch.cuda.synchronize()
        assert torch.isfinite(v).all()
        assert (forward, BLOCK_NORM.launches - before) == want, (
            trainable, remat)
    from omnihuman_tpu_torch.omni.model import (
        build_omni_model, omni_model_forward)
    ocfg = _omni_card_cfg()
    omni = build_omni_model(ocfg, cuda_device, torch.bfloat16, seed=3)
    before = BLOCK_NORM.launches
    with torch.inference_mode():
        omni_model_forward(
            omni, x=torch.randn((1, 16, 3, 8, 8), device=cuda_device),
            t=torch.tensor([700.0], device=cuda_device),
            context=torch.randn((1, 8, 24), device=cuda_device),
            audio=torch.randn((1, 3, 20), device=cuda_device),
            context_lens=torch.tensor([5], device=cuda_device), policy=pol)
    torch.cuda.synchronize()
    assert BLOCK_NORM.launches - before == 5 * ocfg.base.num_layers


# -- qk_norm_rope: the attention's q / k RMSNorm and 3D RoPE in one pass -----

QK_FORMS = ("self", "cross", "q_alone", "q_alone_rotated")


def _qk_inputs(b, l, d, rd, dev, seed, shard=False):
    """q and k [b, l, d] in rd, a 512-row text k, bf16 norm weights, and
    the fp32 tables of the flagship grid (21, 30, 52) cut or padded to l
    rows (rows past 32,760: the identity rotation). With `shard`, q, k and
    the tables are the second quarter of a 4 x l sequence (an sp-4 rank's
    rows: packed in each batch, batches apart)."""
    from omnihuman_tpu_torch.ops.rope import rope_angles_3d
    g = torch.Generator(device=dev).manual_seed(seed)
    lf = 4 * l if shard else l

    def rows(n, scale):
        return (torch.randn(b, n, d, generator=g, device=dev) * scale
                + 0.1).to(rd)

    q, k, kc = rows(lf, 3.0), rows(lf, 0.5), rows(512, 1.0)
    wq = (1 + 0.1 * torch.randn(d, generator=g, device=dev)).to(torch.bfloat16)
    wk = (1 + 0.1 * torch.randn(d, generator=g, device=dev)).to(torch.bfloat16)
    sin, cos = rope_angles_3d((21, 30, 52), 128, seq_len=max(lf, 32760),
                              device=dev)
    sin, cos = sin[:lf], cos[:lf]
    if shard:
        q, k, sin, cos = (t.narrow(t.dim() - 2, l, l)
                          for t in (q, k, sin, cos))
    return q, k, kc, wq, wk, sin, cos


def _qk_form(form, q, k, kc, wq, wk, sin, cos):
    return {"self": (q, k, wq, wk, sin, cos),
            "cross": (q, kc, wq, wk, None, None),
            "q_alone": (q, None, wq, None, None, None),
            "q_alone_rotated": (q, None, wq, None, sin, cos)}[form]


def _qk_norm_within_one_step(got, want):
    """The norm alone: one step of each element's own dtype at its own
    magnitude (bf16 2^-8, fp32 2^-20 relative: a few fp32 ulps of the row's
    scale, where the sum of squares takes another order). RMSNorm has no
    mean to cancel, so no floor."""
    gf, wf = got.float(), want.float()
    bits = 7 if want.dtype == torch.bfloat16 else 19
    mag = wf.abs().clamp_min(2.0 ** -126)
    step = torch.exp2(torch.floor(torch.log2(mag)) - bits)
    return bool(((gf - wf).abs() <= step).all())


def _qk_rotated_within_two_steps(got, want):
    """Normed and rotated, against the eager chain: where the norm's result
    lies one step apart, the rotation carries that step into both elements
    of the pair, so each is held to 2^-6 of its pair's magnitude (two bf16
    steps of it; fp32: 2^-18)."""
    gf, wf = got.float(), want.float()
    pair = wf.unflatten(-1, (-1, 2)).square().sum(-1).sqrt()
    r = pair.repeat_interleave(2, dim=-1)
    rel = 2.0 ** -6 if want.dtype == torch.bfloat16 else 2.0 ** -18
    return bool(((gf - wf).abs() <= rel * r).all())


@pytest.mark.cuda
@pytest.mark.parametrize("rd", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("rows", ["65536", "8192_sp4_shard", "4097"])
@pytest.mark.parametrize("d", [1536, 5120])
def test_qk_norm_rope_kernel_matches_eager(cuda_device, d, rows, rd):
    """Every form the DiT calls at the published widths: the norm within
    one step of the eager `rms_norm`; the rotation of the kernel's own norm
    bit-equal to `apply_rope` of it; the whole against the eager chain
    within two steps of each pair's magnitude; padded rows (past 32,760,
    sin 0 / cos 1) the norm alone; one launch a call."""
    from omnihuman_tpu_torch.ops.qk_norm_rope import (
        QK_NORM_ROPE, qk_norm_rope_cuda, qk_norm_rope_eager)
    from omnihuman_tpu_torch.ops.rope import apply_rope
    b, l, shard = {"65536": (2, 32768, False), "8192_sp4_shard": (2, 4096, True),
                   "4097": (1, 4097, False)}[rows]
    inputs = _qk_inputs(b, l, d, rd, cuda_device, seed=d + l, shard=shard)
    for form in QK_FORMS:
        q, k, wq, wk, sin, cos = _qk_form(form, *inputs)
        before = QK_NORM_ROPE.launches
        qo, ko = qk_norm_rope_cuda(q, k, wq, wk, sin, cos, 1e-6)
        torch.cuda.synchronize()
        assert QK_NORM_ROPE.launches == before + 1
        want_q, want_k = qk_norm_rope_eager(q, k, wq, wk, sin, cos, 1e-6)
        assert qo.dtype == rd and qo.is_contiguous(), form
        if k is None:
            assert ko.numel() == 0
        outs = [(qo, want_q, q, wq)] + ([] if k is None else
                                        [(ko, want_k, k, wk)])
        if sin is None:
            for got, want, _, _ in outs:
                assert _qk_norm_within_one_step(got, want), form
            continue
        normed = qk_norm_rope_cuda(q, k, wq, wk, None, None, 1e-6)
        for (got, want, x, w), n in zip(outs, normed):
            bb, ll, dd = n.shape
            again = apply_rope(n.reshape(bb, ll, dd // 128, 128), sin,
                               cos).reshape(bb, ll, dd)
            assert torch.equal(got, again), form
            assert _qk_rotated_within_two_steps(got, want), form
            if ll > 32760:                     # the identity rotation
                assert torch.equal(got[:, 32760:], n[:, 32760:]), form


@pytest.mark.cuda
def test_qk_norm_rope_fp32_weights_and_small_heads(cuda_device):
    """fp32 norm weights (a trainer's fp32 parameters) and head_dim 16 (the
    tiny test model), q and k against the eager chain."""
    from omnihuman_tpu_torch.ops.qk_norm_rope import (
        qk_norm_rope_cuda, qk_norm_rope_eager)
    from omnihuman_tpu_torch.ops.rope import rope_angles_3d
    g = torch.Generator(device=cuda_device).manual_seed(3)
    q, k = (torch.randn(2, 24, 64, generator=g, device=cuda_device)
            .to(torch.bfloat16) for _ in range(2))
    wq, wk = (1 + 0.1 * torch.randn(64, generator=g, device=cuda_device)
              for _ in range(2))
    sin, cos = rope_angles_3d((3, 2, 3), 16, seq_len=24, device=cuda_device)
    for tables in ((None, None), (sin, cos)):
        got = qk_norm_rope_cuda(q, k, wq, wk, *tables, 1e-6)
        want = qk_norm_rope_eager(q, k, wq, wk, *tables, 1e-6)
        for a, b in zip(got, want):
            if tables[0] is None:
                assert _qk_norm_within_one_step(a, b)
            else:
                assert _qk_rotated_within_two_steps(a, b)


@pytest.mark.cuda
def test_qk_norm_rope_run_to_run(cuda_device):
    from omnihuman_tpu_torch.ops.qk_norm_rope import qk_norm_rope_cuda
    for d in (1536, 5120):
        inputs = _qk_inputs(2, 8192, d, torch.bfloat16, cuda_device, seed=d)
        for form in QK_FORMS:
            args = _qk_form(form, *inputs)
            a = qk_norm_rope_cuda(*args, 1e-6)
            b = qk_norm_rope_cuda(*args, 1e-6)
            assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]), form


@pytest.mark.cuda
@pytest.mark.parametrize("rd", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_qk_norm_rope_gradient_is_the_eager_chains(cuda_device, rd):
    """The op's backward on the card (the eager chain on the saved inputs,
    differentiated) against the eager chain's own, every form at dim
    1536."""
    from omnihuman_tpu_torch.ops.qk_norm_rope import (
        qk_norm_rope_eager, qk_norm_rope_op)
    inputs = _qk_inputs(2, 1024, 1536, rd, cuda_device, seed=11)
    for form in QK_FORMS:
        args = _qk_form(form, *inputs)
        grads = []
        for fn in (qk_norm_rope_op, qk_norm_rope_eager):
            a = [None if t is None else t.detach().clone().requires_grad_()
                 for t in args[:4]] + list(args[4:])
            qo, ko = fn(*a, 1e-6)
            g = torch.Generator(device=cuda_device).manual_seed(5)
            loss = (qo.float() * torch.randn(qo.shape, generator=g,
                                             device=cuda_device)).sum()
            if ko is not None and ko.numel():
                loss = loss + (ko.float() * torch.randn(
                    ko.shape, generator=g, device=cuda_device)).sum()
            loss.backward()
            grads.append([None if t is None else t.grad for t in a[:4]])
        for got, want in zip(*grads):
            assert (got is None) == (want is None), form
            if got is not None:
                ulp = 2.0 ** -7 if got.dtype == torch.bfloat16 else 2.0 ** -20
                tol = ulp * want.float().abs().max().item()
                assert (got.float() - want.float()).abs().max() <= tol, form


@pytest.mark.cuda
def test_qk_norm_rope_refuses_what_it_does_not_take(cuda_device):
    from omnihuman_tpu_torch.ops.qk_norm_rope import qk_norm_rope_cuda
    q, k, kc, wq, wk, sin, cos = _qk_inputs(2, 64, 256, torch.bfloat16,
                                            cuda_device, seed=1)

    def call(**change):
        args = dict(q=q, k=k, wq=wq, wk=wk, sin=sin, cos=cos)
        args.update(change)
        return qk_norm_rope_cuda(*args.values(), 1e-6)

    with pytest.raises(TypeError):
        call(q=q.half(), k=k.half())                  # a dtype it lacks
    with pytest.raises(TypeError):
        call(k=k.float())                             # q and k differ
    with pytest.raises(TypeError):
        call(wq=wq.half())
    with pytest.raises(TypeError):
        call(sin=sin.double(), cos=cos.double())      # tables are fp32
    for d in (12, 6152):                              # dim % 8, dim > 6144
        qd, kd, _, wqd, wkd, _, _ = _qk_inputs(1, 4, d, torch.bfloat16,
                                               cuda_device, seed=2)
        with pytest.raises(ValueError):
            qk_norm_rope_cuda(qd, kd, wqd, wkd, None, None, 1e-6)
    with pytest.raises(ValueError):                   # head_dim 12
        call(sin=sin[:, :6].contiguous(), cos=cos[:, :6].contiguous())
    with pytest.raises(ValueError):                   # tables' rows != L
        call(sin=sin[:32], cos=cos[:32])
    with pytest.raises(ValueError):                   # a short k, rotated
        call(k=kc)
    with pytest.raises(ValueError):                   # rows not contiguous
        call(q=q.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError):
        call(k=torch.empty(2, 64, 512, device=cuda_device,
                           dtype=torch.bfloat16)[..., ::2])
    with pytest.raises(ValueError):                   # not 16-byte aligned
        flat = torch.empty(2 * 64 * 256 + 1, device=cuda_device,
                           dtype=torch.bfloat16)
        call(q=flat[1:].view(2, 64, 256))
    with pytest.raises(ValueError):                   # tables' rows apart
        call(sin=torch.zeros(64, 128, device=cuda_device)[:, ::2],
             cos=torch.ones(64, 128, device=cuda_device)[:, ::2])
    with pytest.raises(ValueError):
        call(q=q.cpu())
    with pytest.raises(ValueError):
        call(sin=sin.cpu(), cos=cos.cpu())


@pytest.mark.cuda
def test_qk_norm_rope_launches_per_dit_forward(cuda_device):
    """A DiT forward launches the kernel twice a block (the self-attention's
    q and k; the cross-attention's q and text k), three times with i2v's
    image keys or the audio adapters; with the gradient as often;
    per-block remat's recompute launches it again, the op's backward (the
    eager chain) not."""
    import dataclasses
    from omnihuman_tpu_torch.configs.wan import (
        TINY_TEST_HD128, DTypePolicy)
    from omnihuman_tpu_torch.models.wan_dit import build_wan_model
    from omnihuman_tpu_torch.ops.qk_norm_rope import QK_NORM_ROPE
    from omnihuman_tpu_torch.ops.rope import rope_angles_3d
    pol = DTypePolicy(residual=torch.bfloat16)
    g = torch.Generator(device=cuda_device).manual_seed(0)
    sin, cos = rope_angles_3d((2, 2, 3), 128, seq_len=16, device=cuda_device)
    t = torch.tensor([500.0], device=cuda_device)
    t2v = TINY_TEST_HD128.model
    i2v = dataclasses.replace(t2v, model_type="i2v", in_dim=36,
                              clip_tokens=5, clip_embed_dim=40)
    n = t2v.num_layers
    for cfg, trainable, remat, want in (
            (t2v, False, False, (2 * n, 2 * n)),
            (t2v, True, False, (2 * n, 2 * n)),
            (t2v, True, True, (2 * n, 4 * n)),
            (i2v, False, False, (3 * n, 3 * n))):
        x = torch.randn((1, cfg.out_dim, 2, 4, 6), generator=g,
                        device=cuda_device)
        ctx = torch.randn((1, cfg.text_len, cfg.text_dim), generator=g,
                          device=cuda_device)
        kw = dict(seq_len=16, rope_sin=sin, rope_cos=cos, policy=pol)
        if cfg.model_type == "i2v":
            kw["clip_fea"] = torch.randn((1, 5, 40), generator=g,
                                         device=cuda_device)
            kw["y"] = torch.randn((1, 20, 2, 4, 6), generator=g,
                                  device=cuda_device)
        model = build_wan_model(cfg, cuda_device, torch.bfloat16, seed=0,
                                trainable=trainable)
        before = QK_NORM_ROPE.launches
        with torch.set_grad_enabled(trainable):
            v = model(x, t, ctx, remat=remat, **kw)
        torch.cuda.synchronize()
        forward = QK_NORM_ROPE.launches - before
        if trainable:
            v.float().square().mean().backward()
            grads = [p.grad for p in model.parameters() if p.requires_grad]
            assert all(g is not None and torch.isfinite(g).all()
                       for g in grads)
        torch.cuda.synchronize()
        assert torch.isfinite(v).all()
        assert (forward, QK_NORM_ROPE.launches - before) == want, (
            cfg.model_type, trainable, remat)
    from omnihuman_tpu_torch.omni.model import (
        build_omni_model, omni_model_forward)
    ocfg = _omni_card_cfg()
    omni = build_omni_model(ocfg, cuda_device, torch.bfloat16, seed=3)
    before = QK_NORM_ROPE.launches
    with torch.inference_mode():
        omni_model_forward(
            omni, x=torch.randn((1, 16, 3, 8, 8), device=cuda_device),
            t=torch.tensor([700.0], device=cuda_device),
            context=torch.randn((1, 8, 24), device=cuda_device),
            audio=torch.randn((1, 3, 20), device=cuda_device),
            context_lens=torch.tensor([5], device=cuda_device), policy=pol)
    torch.cuda.synchronize()
    assert QK_NORM_ROPE.launches - before == 3 * ocfg.base.num_layers
