"""The hand-written CUDA kernels (flash forward with and without the LSE,
flash backward dkdv and dq) against their plain PyTorch versions, on the
card. A CUDA kernel has no CPU mode, so every test here is marked `cuda`
and skips without a GPU. This file imports no JAX, so it runs on a GPU
machine without it:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda -q --noconftest

Tolerance: 2^-6 x max|plain| in bf16, two ulps at the output's own peak
(the two versions round the bf16 output up to one ulp apart), for the
output and for each gradient; the fp32 LSE within 1e-3 (the kernel sums
exp2 in its own order, the plain version exp)."""

import pytest
import torch

from omnihuman_tpu_torch.ops.attention import flash_attention
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
