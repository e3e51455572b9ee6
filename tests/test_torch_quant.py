"""The port's int8 serving precision (ops/quant.py) and the `fast` / `int8`
pipelines against the JAX package, on the CPU.

Tolerances: `quantize_weight` bit-equal (the same fp32 scale, rounding
half to even and clip); `int8_linear` 1e-5 of the output's peak (int32
products are exact, the fp32 dequantisation runs in the same order); an
int8 DiT forward at TINY_TEST and an int8 omni forward 1e-3 in fp32 (an
activation within an ulp of an int8 rounding boundary may quantize one
level apart); one fast CFG step of WanT2V 1e-3 with fp32 compute, and
relative L2 2e-2 with bf16 compute (see that test). JAX references are
compiled with `xla_allow_excess_precision` off, so that they round to
bf16 wherever the JAX code casts (see tests/test_torch_omni.py)."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from omnihuman_tpu.configs.wan import DTypePolicy as JaxPolicy
from omnihuman_tpu.configs.wan import TINY_TEST as JAX_TINY
from omnihuman_tpu.configs.wan import WanModelConfig as JaxWanCfg
from omnihuman_tpu.models.wan_dit import init_wan_model, wan_model_forward
from omnihuman_tpu.omni.model import OmniModelConfig as JaxOmniCfg
from omnihuman_tpu.omni.model import init_omni_model
from omnihuman_tpu.omni.model import omni_model_forward as jax_omni_forward
from omnihuman_tpu.ops import quant as jq
from omnihuman_tpu.ops.rope import rope_angles_3d as jax_rope_angles
from omnihuman_tpu.pipelines.text2video import WanT2V as JaxWanT2V
from omnihuman_tpu.pipelines.text2video import _cfg_model_step
from omnihuman_tpu_torch.configs.wan import (
    TINY_TEST, DTypePolicy, WanModelConfig)
from omnihuman_tpu_torch.models.wan_dit import build_wan_model
from omnihuman_tpu_torch.omni.model import (
    OmniModelConfig, build_omni_model, omni_model_forward)
from omnihuman_tpu_torch.ops import quant
from omnihuman_tpu_torch.ops.rope import rope_angles_3d
from omnihuman_tpu_torch.pipelines.text2video import WanT2V, cfg_model_step
from omnihuman_tpu_torch.utils.convert import (
    omni_state_dict_from_jax, wan_dit_state_dict_from_jax)

torch.set_num_threads(1)

GRID, SEQ = (3, 2, 3), 24         # latents [B, 16, 3, 4, 6], padded to 24
CTX_LENS = (8, 5)


def _run_exact(fn, *args):
    return jax.jit(fn).lower(*args).compile(
        {"xla_allow_excess_precision": False})(*args)


def _t(a):
    return torch.from_numpy(np.array(a))


def _wan_params(seed=0):
    params = jax.tree.map(np.asarray, init_wan_model(jax.random.key(seed),
                                                     JAX_TINY.model))
    rng = np.random.default_rng(seed + 7)
    params["head"]["w"] = (rng.normal(size=params["head"]["w"].shape)
                           * 0.1).astype(np.float32)
    return params


def test_quantize_weight_bit_equal_to_jax():
    rng = np.random.default_rng(0)
    w = (rng.normal(size=(96, 64)) * 0.05).astype(np.float32)   # [in, out]
    w[:, 3] = 0.0                                    # the 1e-8 floor
    want_q, want_s = jax.jit(jq.quantize_weight)(jnp.asarray(w))
    got_q, got_s = quant.quantize_weight(torch.from_numpy(w.T.copy()))
    assert got_q.dtype == torch.int8 and got_s.shape == (64,)
    np.testing.assert_array_equal(got_q.numpy().T, np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


@pytest.mark.parametrize("rows", [1, 16, 17, 50])
def test_int8_linear_matches_jax(rows):
    """Rows <= 16 take the zero-row padding that torch._int_mm needs on
    CUDA; the CPU path runs it too."""
    rng = np.random.default_rng(rows)
    w = (rng.normal(size=(64, 40)) * 0.05).astype(np.float32)
    b = (rng.normal(size=(40,)) * 0.1).astype(np.float32)
    x = rng.normal(size=(rows, 64)).astype(np.float32)
    w_q, w_s = jq.quantize_weight(jnp.asarray(w))
    want = np.asarray(jax.jit(jq.int8_linear)(
        {"w_q": w_q, "w_s": w_s, "b": jnp.asarray(b)}, jnp.asarray(x)))
    lin = nn.Linear(64, 40)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(w.T.copy()))
        lin.bias.copy_(torch.from_numpy(b))
    got = quant.int8_linear(quant.Int8Linear.from_linear(lin),
                            torch.from_numpy(x))
    assert got.shape == (rows, 40) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want,
                               atol=1e-5 * np.abs(want).max())


def test_int8_gemm_pads_rows_exactly_on_cpu():
    """Three rows padded to 17 and cut back give the exact int32 product;
    K = 12 (not a multiple of 8) is refused on CUDA only."""
    x = torch.randint(-127, 128, (3, 12), dtype=torch.int8)
    w = torch.randint(-127, 128, (8, 12), dtype=torch.int8)
    np.testing.assert_array_equal(quant._int_mm(x, w).numpy(),
                                  x.int().numpy() @ w.int().numpy().T)


def test_int8_dit_forward_matches_jax():
    params = _wan_params()
    x = np.random.default_rng(1).normal(size=(2, 16, 3, 4, 6)).astype(
        np.float32)
    t = np.array([999.0, 431.5], np.float32)
    ctx = np.random.default_rng(2).normal(size=(2, 16, 32)).astype(
        np.float32)
    lens = np.array(CTX_LENS, np.int32)
    sin, cos = jax_rope_angles(GRID, JAX_TINY.model.head_dim, seq_len=SEQ)

    def ref(p, x, t, ctx, lens):
        return wan_model_forward(
            jq.quantize_wan_params(p), x, t, ctx, cfg=JAX_TINY.model,
            seq_len=SEQ, rope_sin=sin, rope_cos=cos, context_lens=lens,
            policy=JaxPolicy(compute=jnp.float32), remat=False)

    want = _run_exact(ref, jax.tree.map(jnp.asarray, params), x, t, ctx,
                      lens)
    model = build_wan_model(TINY_TEST.model, "cpu", torch.float32, seed=None)
    model.load_state_dict(wan_dit_state_dict_from_jax(params,
                                                      TINY_TEST.model))
    quant.quantize_wan_model(model)
    assert isinstance(model.blocks[1].ffn[2], quant.Int8Linear)
    assert isinstance(model.blocks[0].cross_attn.k, quant.Int8Linear)
    assert isinstance(model.text_embedding[0], nn.Linear)
    psin, pcos = rope_angles_3d(GRID, TINY_TEST.model.head_dim, seq_len=SEQ)
    got = model(_t(x), _t(t), _t(ctx), seq_len=SEQ, rope_sin=psin,
                rope_cos=pcos, context_lens=_t(lens),
                policy=DTypePolicy(compute=torch.float32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3)


def test_int8_omni_forward_keeps_adapters_and_matches_jax():
    base = dict(dim=32, ffn_dim=64, num_heads=4, num_layers=2, freq_dim=16,
                text_dim=24, text_len=8)
    jcfg = JaxOmniCfg(base=JaxWanCfg(**base), audio_dim=20, num_keypoints=8,
                      num_frames=8)
    pcfg = OmniModelConfig(base=WanModelConfig(**base), audio_dim=20,
                           num_keypoints=8, num_frames=8)
    params = jax.tree.map(np.asarray, init_omni_model(jax.random.key(3),
                                                      jcfg))
    rng = np.random.default_rng(3)
    params["base"]["head"]["w"] = (rng.normal(
        size=params["base"]["head"]["w"].shape) * 0.1).astype(np.float32)
    ad = params["base"]["blocks"]["audio_attn"]
    ad["o"]["w"] = (rng.normal(size=ad["o"]["w"].shape) * 0.2).astype(
        np.float32)
    x = rng.normal(size=(2, 16, 2, 8, 8)).astype(np.float32)
    t = np.array([700.0, 50.0], np.float32)
    ctx = rng.normal(size=(2, 8, 24)).astype(np.float32)
    audio = rng.normal(size=(2, 2, 20)).astype(np.float32)
    ref_lat = rng.normal(size=(2, 16, 1, 8, 8)).astype(np.float32)
    pol = JaxPolicy(compute=jnp.float32, residual=jnp.bfloat16)

    def ref(p, x, t, ctx, audio, ref_lat):
        q = jq.quantize_wan_params(p)
        assert "w" in q["base"]["blocks"]["audio_attn"]["q"]
        return jax_omni_forward(q, x, t, ctx, cfg=jcfg, audio=audio,
                                ref_latent=ref_lat, policy=pol, remat=False)

    want = _run_exact(ref, jax.tree.map(jnp.asarray, params), x, t, ctx,
                      audio, ref_lat)
    model = build_omni_model(pcfg, "cpu", torch.float32, seed=None)
    model.load_state_dict(omni_state_dict_from_jax(params, pcfg))
    quant.quantize_wan_model(model)
    for blk in model.base.blocks:
        assert isinstance(blk.self_attn.q, quant.Int8Linear)
        for name in ("q", "k", "v", "o"):
            assert type(getattr(blk.audio_attn, name)) is nn.Linear
    got = omni_model_forward(
        model, _t(x), _t(t), _t(ctx), audio=_t(audio), ref_latent=_t(ref_lat),
        policy=DTypePolicy(compute=torch.float32, residual=torch.bfloat16))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3)


@pytest.mark.parametrize("compute", ["fp32", "bf16"])
def test_fast_pipeline_cfg_step_matches_jax(compute):
    """One fused CFG model step of WanT2V(precision="fast") against the JAX
    WanT2V(precision="fast") on the same config, weights (bf16) and
    inputs, each package taking its pipeline's own policy.

    fp32 compute isolates what "fast" changes, the bf16 residual stream:
    1e-3. With the config's bf16 compute the two differ by design at the
    bf16 level (relative L2 8.7e-3 here, held to 2e-2): JAX's CPU
    attention fallback rounds the normalised probabilities to bf16 where
    the TPU kernel and the port round the unnormalised ones, and a JAX
    program without excess precision rounds every step of the tanh GELU to
    bf16 where the port rounds its fp32 result once; with both aligned the
    port is within 5.5e-6 of JAX."""
    cfg = TINY_TEST
    jcfg = JAX_TINY
    if compute == "fp32":
        cfg = dataclasses.replace(cfg, policy=DTypePolicy(
            compute=torch.float32))
        jcfg = dataclasses.replace(jcfg, policy=JaxPolicy(
            compute=jnp.float32))
    params = jax.tree.map(
        lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)), _wan_params(4))
    pipe = WanT2V(cfg, device="cpu", precision="fast")
    jpol = JaxWanT2V(jcfg, precision="fast").policy
    assert pipe.policy.residual == torch.bfloat16
    assert jpol.residual == jnp.bfloat16
    pipe.model.load_state_dict(wan_dit_state_dict_from_jax(
        jax.tree.map(lambda a: np.asarray(a, np.float32), params),
        TINY_TEST.model))
    rng = np.random.default_rng(5)
    x = rng.normal(size=(1, 16, 3, 4, 6)).astype(np.float32)
    ctx2 = (rng.normal(size=(2, 16, 32)) * 0.5).astype(np.float32)
    lens = np.array(CTX_LENS, np.int32)
    sin, cos = jax_rope_angles(GRID, JAX_TINY.model.head_dim, seq_len=SEQ)

    def ref(p, x, ctx2, lens):
        return _cfg_model_step(p, x, jnp.float32(900.0), ctx2, sin, cos,
                               lens, model_cfg=JAX_TINY.model, policy=jpol,
                               seq_len=SEQ, guide_scale=5.0)

    want = np.asarray(_run_exact(ref, jax.tree.map(jnp.asarray, params), x,
                                 ctx2, lens))
    psin, pcos = rope_angles_3d(GRID, TINY_TEST.model.head_dim, seq_len=SEQ)
    with torch.inference_mode():
        got = cfg_model_step(pipe.model, _t(x), 900.0, _t(ctx2), psin, pcos,
                             _t(lens), policy=pipe.policy, seq_len=SEQ,
                             guide_scale=5.0).float().numpy()
    if compute == "fp32":
        np.testing.assert_allclose(got, want, atol=1e-3)
    else:
        assert np.linalg.norm(got - want) / np.linalg.norm(want) < 2e-2


def test_int8_pipeline_quantizes_like_jax():
    """WanT2V(precision="int8"): the fast policy and the block GEMMs as
    int8, the same set the JAX pipeline quantizes."""
    pipe = WanT2V(TINY_TEST, device="cpu", precision="int8")
    jpipe = JaxWanT2V(JAX_TINY, precision="int8")
    assert pipe.policy.residual == torch.bfloat16
    jblocks = jpipe.params["blocks"]
    for attn in ("self_attn", "cross_attn"):
        for name in ("q", "k", "v", "o"):
            assert "w_q" in jblocks[attn][name]
            assert isinstance(getattr(getattr(pipe.model.blocks[0], attn),
                                      name), quant.Int8Linear)
    assert isinstance(pipe.model.blocks[1].ffn[0], quant.Int8Linear)
    assert pipe.model.blocks[0].ffn[0].w_q.dtype == torch.int8


def test_generate_cli_runs_int8_on_cpu(tmp_path):
    from omnihuman_tpu_torch.cli.generate import main
    out = main(["--task", "tiny-test", "--size", "64*64", "--frame_num", "5",
                "--sample_steps", "2", "--base_seed", "0", "--precision",
                "int8", "--device", "cpu",
                "--save_file", str(tmp_path / "clip.mp4")])
    assert os.path.exists(out) and os.path.getsize(out) > 0
