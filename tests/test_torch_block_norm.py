"""The DiT block's residual-site op (ops/block_norm.py) on the CPU: the op's
CPU kernel against the eager formulas `_block_forward` ran before it, bit
for bit, at every site form and both residual dtypes; `opcheck` (schema,
fake, dispatch, the autograd formula); the op's gradient against the eager
chain's. The kernel itself runs only on the card
(tests/test_torch_kernels_cuda.py)."""

import pytest
import torch

from omnihuman_tpu_torch.ops import block_norm as bn
from omnihuman_tpu_torch.ops.norms import layer_norm

torch.set_num_threads(1)

B, L, D, EPS = 2, 5, 24, 1e-6
F32, BF16 = torch.float32, torch.bfloat16
SITES = ("A", "B", "C", "C_audio_norm", "C_audio_gate", "D")


def _inputs(rd, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(B, L, D, generator=g) * 3 + 0.5).to(rd)
    y = torch.randn(B, L, D, generator=g).to(BF16)
    e = torch.randn(B, 6, D, generator=g)
    w = (1 + 0.1 * torch.randn(D, generator=g)).to(BF16)
    b = (0.02 * torch.randn(D, generator=g)).to(BF16)
    gate = torch.tensor(0.7).to(BF16)
    return x, y, [e[:, i:i + 1] for i in range(6)], w, b, gate


def _old_site(site, x, y, e, w, b, gate):
    """The site as the eager code wrote it: (x', h in fp32 or None)."""
    rd, f32 = x.dtype, F32
    sa_shift, sa_scale, sa_gate, ff_shift, ff_scale, ff_gate = e
    if site == "A":
        h = layer_norm(x, eps=EPS, out_dtype=f32)
        return x, h * (1.0 + sa_scale) + sa_shift
    if site == "B":
        x = (x + (y.to(f32) * sa_gate).to(rd)).to(rd)
        return x, layer_norm(x, w, b, eps=EPS, out_dtype=f32)
    if site == "C":
        x = x + y.to(rd)
        h = layer_norm(x, eps=EPS, out_dtype=f32)
        return x, h * (1.0 + ff_scale) + ff_shift
    if site == "C_audio_norm":
        x = x + y.to(rd)
        return x, layer_norm(x, w, b, eps=EPS, out_dtype=f32)
    if site == "C_audio_gate":
        x = (x.to(f32) + y.to(f32) * gate.to(f32)).to(rd)
        h = layer_norm(x, eps=EPS, out_dtype=f32)
        return x, h * (1.0 + ff_scale) + ff_shift
    return x + (y.to(f32) * ff_gate).to(rd), None


def _op_args(site, x, y, e, w, b, gate, h_dtype=BF16):
    """The op's arguments of a site, as `_block_forward` passes them."""
    sa_shift, sa_scale, sa_gate, ff_shift, ff_scale, ff_gate = e
    none = dict(y=None, gate=None, round_inner=True, norm=True, weight=None,
                bias=None, shift=None, scale=None)
    kw = {"A": dict(shift=sa_shift, scale=sa_scale),
          "B": dict(y=y, gate=sa_gate, weight=w, bias=b),
          "C": dict(y=y, shift=ff_shift, scale=ff_scale),
          "C_audio_norm": dict(y=y, weight=w, bias=b),
          "C_audio_gate": dict(y=y, gate=gate.to(F32), round_inner=False,
                               shift=ff_shift, scale=ff_scale),
          "D": dict(y=y, gate=ff_gate, norm=False)}[site]
    a = {**none, **kw}
    return (x, a["y"], a["gate"], a["round_inner"], a["norm"], a["weight"],
            a["bias"], a["shift"], a["scale"], EPS, h_dtype)


@pytest.mark.parametrize("rd", [F32, BF16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("site", SITES)
def test_op_cpu_kernel_is_the_old_eager_site_bit_for_bit(site, rd):
    inputs = _inputs(rd)
    want_x, want_h = _old_site(site, *inputs)
    args = _op_args(site, *inputs)
    xo, h = torch.ops.omnihuman_tpu_torch.add_norm(*args)
    if args[1] is None:
        assert xo.numel() == 0
    else:
        assert xo.dtype == rd and torch.equal(xo, want_x)
    if want_h is None:
        assert h.numel() == 0
    else:
        assert h.dtype == BF16 and torch.equal(h, want_h.to(BF16))
    # the public function: x itself without y, None without the norm
    gx, gh = bn.add_norm(args[0], args[1], args[2], round_inner=args[3],
                         norm=args[4], weight=args[5], bias=args[6],
                         shift=args[7], scale=args[8], eps=EPS,
                         h_dtype=BF16)
    assert torch.equal(gx, want_x)
    assert (gh is None) == (want_h is None)


def _with_grad(args):
    return [a.detach().clone().requires_grad_() if isinstance(
        a, torch.Tensor) else a for a in args]


@pytest.mark.parametrize("site", ["A", "C_audio_gate", "D"])
def test_add_norm_op_opcheck(site):
    args = _op_args(site, *_inputs(F32, 1), h_dtype=F32)
    torch.library.opcheck(bn.add_norm_op, _with_grad(args))


@pytest.mark.parametrize("rd", [F32, BF16], ids=["fp32", "bf16"])
def test_dispatch_keeps_the_gradient_where_autograd_records(rd):
    """The op's backward (the eager chain again, differentiated) gives the
    eager chain's gradients at every site form: bit for bit but for the
    order in which x's gradient sums its paths (a few fp32 ulps)."""
    inputs = _inputs(rd, 2)
    for site in SITES:
        args = _op_args(site, *inputs)
        grads = []
        for fn in (bn.add_norm_op, bn.add_norm_eager):
            a = _with_grad(args)
            xo, h = fn(*a)
            xo = a[0] if a[1] is None else xo        # add_norm's x'
            g = torch.Generator().manual_seed(3)
            loss = (xo.float() * torch.randn(xo.shape, generator=g)).sum()
            if h is not None and h.numel():
                loss = loss + (h.float() * torch.randn(h.shape,
                                                        generator=g)).sum()
            loss.backward()
            grads.append([t.grad for t in a if isinstance(t, torch.Tensor)])
        for got, want in zip(*grads):
            assert (got is None) == (want is None), site
            if got is not None:
                tol = 2.0 ** -20 * want.float().abs().max().item()
                assert (got.float() - want.float()).abs().max() <= tol, site


def test_op_refuses_what_no_site_asks():
    x, y, e, w, b, _ = _inputs(BF16, 3)
    op = torch.ops.omnihuman_tpu_torch.add_norm
    with pytest.raises(ValueError, match="neither y nor"):
        op(x, None, None, True, False, None, None, None, None, EPS, BF16)
    with pytest.raises(ValueError, match="shift and scale"):
        op(x, None, None, True, True, None, None, e[0], None, EPS, BF16)
    with pytest.raises(ValueError, match="give a gate"):
        op(x, y, None, False, True, None, None, None, None, EPS, BF16)
    with pytest.raises(ValueError, match="needs CUDA"):
        bn.add_norm_cuda(x, y, None, True, True, w, b, None, None, EPS, BF16)
