"""The attention's q / k norm-and-rotation op (ops/qk_norm_rope.py) on the
CPU: the op's CPU kernel against `rms_norm` followed by `apply_rope`, bit for
bit, in both row dtypes and every form the DiT calls (self-attention q and k
with the tables, a cross-attention's q with a shorter k, q alone);
`opcheck` (schema, fake, dispatch, the autograd formula); the fake
kernel's shapes and dtypes; the op's gradient against the eager chain's;
and tiny DiT forwards (t2v, i2v, OmniHuman with its audio adapters) and a
training step bit-equal to the same model run with the eager chain the DiT
called before the op. The kernel itself runs only on the card
(tests/test_torch_kernels_cuda.py)."""

import dataclasses

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from omnihuman_tpu_torch.configs.wan import (
    TINY_TEST, TINY_TEST_HD128, DTypePolicy)
from omnihuman_tpu_torch.models import wan_dit
from omnihuman_tpu_torch.ops import qk_norm_rope as qn
from omnihuman_tpu_torch.ops.attention import flash_attention
from omnihuman_tpu_torch.ops.norms import rms_norm
from omnihuman_tpu_torch.ops.rope import apply_rope, rope_angles_3d

torch.set_num_threads(1)

B, L, LC, HD, N, EPS = 2, 10, 3, 16, 3, 1e-6
D = N * HD
F32, BF16 = torch.float32, torch.bfloat16
FORMS = ("self", "cross", "q_alone", "q_alone_rotated")


def _inputs(rd, wd, seed=0):
    """q [B, L, D] and k [B, L, D] in rd, a short k [B, LC, D], norm
    weights in wd, tables of a (1, 2, 4) grid padded to L rows (the
    identity rotation on the last two)."""
    g = torch.Generator().manual_seed(seed)
    q = (torch.randn(B, L, D, generator=g) * 3 + 0.2).to(rd)
    k = (torch.randn(B, L, D, generator=g) * 0.5).to(rd)
    kc = torch.randn(B, LC, D, generator=g).to(rd)
    wq = (1 + 0.1 * torch.randn(D, generator=g)).to(wd)
    wk = (1 + 0.1 * torch.randn(D, generator=g)).to(wd)
    sin, cos = rope_angles_3d((1, 2, 4), HD, seq_len=L)
    return q, k, kc, wq, wk, sin, cos


def _form_args(form, q, k, kc, wq, wk, sin, cos):
    return {"self": (q, k, wq, wk, sin, cos),
            "cross": (q, kc, wq, wk, None, None),
            "q_alone": (q, None, wq, None, None, None),
            "q_alone_rotated": (q, None, wq, None, sin, cos)}[form]


def _dit_chain(x, w, sin, cos):
    """What `_self_attention` / `_cross_attention` ran before the op."""
    y = rms_norm(x, w, eps=EPS)
    if sin is None:
        return y
    b, l, d = y.shape
    return apply_rope(y.reshape(b, l, d // HD, HD), sin, cos).reshape(b, l, d)


@pytest.mark.parametrize("wd", [F32, BF16], ids=["w_fp32", "w_bf16"])
@pytest.mark.parametrize("rd", [F32, BF16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("form", FORMS)
def test_op_cpu_kernel_is_the_eager_chain_bit_for_bit(form, rd, wd):
    q, k, wq, wk, sin, cos = _form_args(form, *_inputs(rd, wd))
    qo, ko = torch.ops.omnihuman_tpu_torch.qk_norm_rope(
        q, k, wq, wk, sin, cos, EPS)
    assert qo.dtype == rd and qo.is_contiguous()
    assert torch.equal(qo, _dit_chain(q, wq, sin, cos))
    if k is None:
        assert ko.numel() == 0
    else:
        assert ko.dtype == rd and torch.equal(ko, _dit_chain(k, wk, sin, cos))
    # the public function: k' None without k
    pq, pk = qn.qk_norm_rope(q, k, wq, wk, sin, cos, eps=EPS)
    assert torch.equal(pq, qo) and (pk is None) == (k is None)


def test_padded_rows_pass_the_identity_rotation_unchanged():
    """Rows past the grid carry sin 0 / cos 1 (`WanModel.body` pads the
    tables so): they come out as the norm alone."""
    q, k, _, wq, wk, sin, cos = _inputs(BF16, BF16, seed=4)
    assert (sin[8:] == 0).all() and (cos[8:] == 1).all()
    qo, ko = qn.qk_norm_rope(q, k, wq, wk, sin, cos, eps=EPS)
    assert torch.equal(qo[:, 8:], rms_norm(q, wq, eps=EPS)[:, 8:])
    assert torch.equal(ko[:, 8:], rms_norm(k, wk, eps=EPS)[:, 8:])
    assert not torch.equal(qo[:, :8], rms_norm(q, wq, eps=EPS)[:, :8])


@pytest.mark.parametrize("form", FORMS)
def test_fake_kernel_gives_the_shapes_and_dtypes(form):
    real = _form_args(form, *_inputs(BF16, F32, seed=1))
    with FakeTensorMode() as mode:
        fake = [None if t is None else mode.from_tensor(t) for t in real]
        qo, ko = qn.qk_norm_rope_op(*fake, EPS)
    q, k = real[0], real[1]
    assert qo.shape == q.shape and qo.dtype == q.dtype
    assert qo.is_contiguous()
    if k is None:
        assert ko.shape == (0,)
    else:
        assert ko.shape == k.shape and ko.dtype == k.dtype


def _with_grad(args):
    return [a.detach().clone().requires_grad_() if isinstance(
        a, torch.Tensor) and a.is_floating_point() else a for a in args]


@pytest.mark.parametrize("form", ["self", "cross", "q_alone"])
def test_qk_norm_rope_op_opcheck(form):
    args = list(_form_args(form, *_inputs(F32, F32, seed=2))) + [EPS]
    a = _with_grad(args)
    if a[4] is not None:                  # tables are constants
        a[4], a[5] = a[4].detach(), a[5].detach()
    torch.library.opcheck(qn.qk_norm_rope_op, a)


@pytest.mark.parametrize("rd", [F32, BF16], ids=["fp32", "bf16"])
def test_op_gradient_is_the_eager_chains(rd):
    """The op's backward (the eager chain again, differentiated) gives the
    eager chain's gradients for q, k and both weights, in every form."""
    inputs = _inputs(rd, F32, seed=3)
    for form in FORMS:
        args = _form_args(form, *inputs)
        grads = []
        for fn in (qn.qk_norm_rope_op, qn.qk_norm_rope_eager):
            a = _with_grad(args[:4]) + list(args[4:])
            qo, ko = fn(*a, EPS)
            g = torch.Generator().manual_seed(5)
            loss = (qo.float() * torch.randn(qo.shape, generator=g)).sum()
            if ko is not None and ko.numel():
                loss = loss + (ko.float() * torch.randn(
                    ko.shape, generator=g)).sum()
            loss.backward()
            grads.append([None if t is None else t.grad for t in a[:4]])
        for got, want in zip(*grads):
            assert (got is None) == (want is None), form
            if got is not None:
                assert torch.equal(got, want), form


def test_op_refuses_what_no_call_site_asks():
    q, k, kc, wq, wk, sin, cos = _inputs(BF16, BF16, seed=6)
    op = torch.ops.omnihuman_tpu_torch.qk_norm_rope
    with pytest.raises(ValueError, match="come together"):
        op(q, k, wq, None, None, None, EPS)
    with pytest.raises(ValueError, match="both sin and cos"):
        op(q, k, wq, wk, sin, None, EPS)
    with pytest.raises(ValueError, match="rotated k"):
        op(q, kc, wq, wk, sin, cos, EPS)          # tables and a short k
    with pytest.raises(ValueError, match="head_dim / 2"):
        op(q, k, wq, wk, sin[:4], cos[:4], EPS)    # rows != L
    with pytest.raises(ValueError, match="is not"):
        op(q, k, wq[:8], wk, None, None, EPS)
    with pytest.raises(TypeError, match="q torch.bfloat16"):
        op(q, k.float(), wq, wk, None, None, EPS)
    with pytest.raises(ValueError, match="needs CUDA"):
        qn.qk_norm_rope_cuda(q, k, wq, wk, sin, cos, EPS)


# -- the DiT on the CPU, against the eager chain it called before the op ----

def _old_self_attention(p, x, rope_sin, rope_cos, seq_lens, cfg, policy):
    b, s, _ = x.shape
    n, d = cfg.num_heads, cfg.head_dim
    cd = policy.compute
    xc = x.to(cd)
    lin = wan_dit._linear
    q = rms_norm(lin(p.q, xc), p.norm_q.weight, eps=cfg.eps)
    k = rms_norm(lin(p.k, xc), p.norm_k.weight, eps=cfg.eps)
    v = lin(p.v, xc)
    q = apply_rope(q.reshape(b, s, n, d), rope_sin, rope_cos)
    k = apply_rope(k.reshape(b, s, n, d), rope_sin, rope_cos)
    y = flash_attention(q, k, v.reshape(b, s, n, d), k_lens=seq_lens,
                        window_size=cfg.window_size, dtype=cd)
    return lin(p.o, y.reshape(b, s, n * d).to(cd))


def _old_cross_attention(p, x, context, context_lens, cfg, policy):
    b, s, _ = x.shape
    n, d = cfg.num_heads, cfg.head_dim
    cd = policy.compute
    lin = wan_dit._linear
    xc = x.to(cd)
    ctx = context.to(cd)
    q = rms_norm(lin(p.q, xc), p.norm_q.weight, eps=cfg.eps)
    q = q.reshape(b, s, n, d)
    y_img = None
    if cfg.model_type == "i2v":
        ti = cfg.clip_tokens
        ctx_img, ctx = ctx[:, :ti], ctx[:, ti:]
        k_img = rms_norm(lin(p.k_img, ctx_img), p.norm_k_img.weight,
                         eps=cfg.eps)
        v_img = lin(p.v_img, ctx_img)
        y_img = flash_attention(q, k_img.reshape(b, ti, n, d),
                                v_img.reshape(b, ti, n, d), dtype=cd)
    lc = ctx.shape[1]
    k = rms_norm(lin(p.k, ctx), p.norm_k.weight, eps=cfg.eps)
    v = lin(p.v, ctx)
    y = flash_attention(q, k.reshape(b, lc, n, d), v.reshape(b, lc, n, d),
                        k_lens=context_lens, dtype=cd)
    if y_img is not None:
        y = y + y_img
    return lin(p.o, y.reshape(b, s, n * d).to(cd))


def _eager_chain(monkeypatch):
    monkeypatch.setattr(wan_dit, "_self_attention", _old_self_attention)
    monkeypatch.setattr(wan_dit, "_cross_attention", _old_cross_attention)


def _dit_inputs(cfg, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(2, cfg.out_dim, 3, 4, 6, generator=g)
    ctx = torch.randn(2, cfg.text_len, cfg.text_dim, generator=g)
    sin, cos = rope_angles_3d((3, 2, 3), cfg.head_dim, seq_len=24)
    kw = dict(seq_len=24, rope_sin=sin, rope_cos=cos,
              context_lens=torch.tensor([8, 5]))
    if cfg.model_type == "i2v":
        kw["clip_fea"] = torch.randn(2, cfg.clip_tokens, cfg.clip_embed_dim,
                                     generator=g)
        kw["y"] = torch.randn(2, cfg.in_dim - cfg.out_dim, 3, 4, 6,
                              generator=g)
    return x, torch.tensor([999.0, 431.5]), ctx, kw


def _i2v_cfg():
    return dataclasses.replace(TINY_TEST.model, model_type="i2v", in_dim=36,
                               clip_tokens=5, clip_embed_dim=40)


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("model", ["t2v", "t2v_hd128", "i2v"])
def test_dit_forward_is_the_eager_chains_bit_for_bit(model, dtype,
                                                     monkeypatch):
    cfg = {"t2v": TINY_TEST.model, "t2v_hd128": TINY_TEST_HD128.model,
           "i2v": _i2v_cfg()}[model]
    pol = DTypePolicy(residual=dtype)
    m = wan_dit.build_wan_model(cfg, "cpu", dtype, seed=0)
    with torch.no_grad():
        m.head.head.weight.normal_(0, 0.1,
                                   generator=torch.Generator().manual_seed(1))
    x, t, ctx, kw = _dit_inputs(cfg, 2)
    with torch.inference_mode():
        got = m(x, t, ctx, policy=pol, **kw)
        _eager_chain(monkeypatch)
        want = m(x, t, ctx, policy=pol, **kw)
    assert got.abs().max() > 0
    assert torch.equal(got, want)


def test_omni_forward_is_the_eager_chains_bit_for_bit(monkeypatch):
    """The OmniHuman DiT with its audio adapters (the third call a
    block)."""
    from omnihuman_tpu_torch.configs.wan import WanModelConfig
    from omnihuman_tpu_torch.omni.model import (
        OmniModelConfig, build_omni_model, omni_model_forward)
    base = WanModelConfig(dim=64, ffn_dim=128, num_heads=4, num_layers=2,
                          freq_dim=16, text_dim=24, text_len=8)
    cfg = OmniModelConfig(base=base, audio_dim=20, num_keypoints=8,
                          num_frames=8)
    m = build_omni_model(cfg, "cpu", BF16, seed=3)
    g = torch.Generator().manual_seed(4)
    with torch.no_grad():          # o and the head start at zero
        for blk in m.base.blocks:
            blk.audio_attn.o.weight.normal_(0, 0.1, generator=g)
        m.base.head.head.weight.normal_(0, 0.1, generator=g)
    args = dict(x=torch.randn((1, 16, 3, 8, 8), generator=g),
                t=torch.tensor([700.0]),
                context=torch.randn((1, 8, 24), generator=g),
                audio=torch.randn((1, 3, 20), generator=g),
                context_lens=torch.tensor([5]),
                policy=DTypePolicy(residual=BF16))
    with torch.inference_mode():
        got = omni_model_forward(m, **args)
        _eager_chain(monkeypatch)
        want = omni_model_forward(m, **args)
    assert torch.equal(got, want)


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_dit_training_step_is_the_eager_chains(remat, monkeypatch):
    """Loss bit-equal; every parameter's gradient the eager chain's but for
    the order in which autograd sums a tensor's paths (a few fp32 ulps)."""
    cfg = TINY_TEST.model
    pol = DTypePolicy(residual=F32)
    x, t, ctx, kw = _dit_inputs(cfg, 5)
    runs = []
    for eager in (False, True):
        if eager:
            _eager_chain(monkeypatch)
        m = wan_dit.build_wan_model(cfg, "cpu", F32, seed=0, trainable=True)
        with torch.no_grad():
            m.head.head.weight.normal_(
                0, 0.1, generator=torch.Generator().manual_seed(1))
        loss = m(x, t, ctx, policy=pol, remat=remat, **kw).square().mean()
        loss.backward()
        runs.append((loss.detach(), {n: p.grad for n, p in
                                     m.named_parameters()}))
    (loss, got), (want_loss, want) = runs
    assert torch.equal(loss, want_loss)
    for name, g in got.items():
        w = want[name]
        assert (g is None) == (w is None), name
        if g is not None:
            tol = 2.0 ** -20 * max(w.abs().max().item(), 1e-30)
            assert (g - w).abs().max().item() <= tol, name


def test_op_gradient_where_only_q_needs_one():
    """A cross-attention under a frozen backbone (the APT discriminator's
    input gradient): q needs a gradient, the context's k and both weights
    none; the op's backward leaves k' (a gradient arrives for it all the
    same) out and gives q the eager chain's."""
    q, _, kc, wq, wk, _, _ = _inputs(F32, F32, seed=7)
    grads = []
    for fn in (qn.qk_norm_rope_op, qn.qk_norm_rope_eager):
        x = q.detach().clone().requires_grad_()
        qo, ko = fn(x, kc, wq, wk, None, None, EPS)
        loss = qo.square().sum()
        if ko.requires_grad:          # the op's k' carries its grad_fn
            loss = loss + ko.sum()
        loss.backward()
        grads.append(x.grad)
    assert torch.equal(*grads)
