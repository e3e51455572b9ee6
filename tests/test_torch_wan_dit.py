"""The port's DiT against JAX `wan_model_forward`, with the same weights
carried across by the port's converter and the same numpy inputs.

Tolerance: fp32 compute 1e-4 on velocities of order 1 (same math, other
summation order in the matmuls and the attention)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnihuman_tpu.configs.wan import DTypePolicy as JaxPolicy
from omnihuman_tpu.configs.wan import TINY_TEST as JAX_TINY
from omnihuman_tpu.models.wan_dit import init_wan_model, wan_model_forward
from omnihuman_tpu.ops.rope import rope_angles_3d as jax_rope_angles
from omnihuman_tpu.utils.convert import convert_wan_dit
from omnihuman_tpu_torch.configs.wan import (
    TINY_TEST, TINY_TEST_HD128, DTypePolicy)
from omnihuman_tpu_torch.models.wan_dit import build_wan_model
from omnihuman_tpu_torch.ops.rope import rope_angles_3d
from omnihuman_tpu_torch.utils.convert import wan_dit_state_dict_from_jax

torch.set_num_threads(1)

B, F, H, W = 2, 3, 4, 6          # patch (1, 2, 2) -> grid (3, 2, 3): 18 tokens
GRID = (3, 2, 3)
SEQ = 24                          # > n_tokens: the padding path
CTX_LENS = (8, 5)


def _jax_cfg(port_cfg):
    """The JAX twin of a port model config (same field values)."""
    from omnihuman_tpu.configs.wan import WanModelConfig
    return WanModelConfig(**dataclasses.asdict(port_cfg))


def _params(cfg, seed=0):
    """JAX init with a random head (the reference head is zero-initialised,
    which would make every velocity 0)."""
    params = jax.tree.map(np.asarray, init_wan_model(jax.random.key(seed),
                                                     cfg))
    rng = np.random.default_rng(seed + 7)
    params["head"]["w"] = (rng.normal(size=params["head"]["w"].shape)
                           * 0.1).astype(np.float32)
    params["head"]["b"] = (rng.normal(size=params["head"]["b"].shape)
                           * 0.1).astype(np.float32)
    return params


def _inputs(cfg, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, cfg.in_dim, F, H, W)).astype(np.float32)
    t = np.array([999.0, 431.5], np.float32)
    ctx = rng.normal(size=(B, cfg.text_len, cfg.text_dim)).astype(np.float32)
    return x, t, ctx


@pytest.mark.parametrize("port_cfg", [TINY_TEST.model, TINY_TEST_HD128.model],
                         ids=["tiny", "head_dim128"])
@pytest.mark.parametrize("param_dtype", ["fp32", "bf16"])
def test_forward_matches_jax_fp32_compute(port_cfg, param_dtype):
    """fp32 compute; bf16 params exercise the JAX promotion points
    (bf16 weights @ fp32 activations -> fp32)."""
    jcfg = _jax_cfg(port_cfg)
    params = _params(jcfg)
    if param_dtype == "bf16":
        params = jax.tree.map(
            lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)), params)
    x, t, ctx = _inputs(jcfg)
    sin, cos = jax_rope_angles(GRID, jcfg.head_dim, seq_len=SEQ)
    want = wan_model_forward(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x), jnp.asarray(t),
        jnp.asarray(ctx), cfg=jcfg, seq_len=SEQ, rope_sin=sin, rope_cos=cos,
        context_lens=jnp.asarray(np.array(CTX_LENS, np.int32)),
        policy=JaxPolicy(compute=jnp.float32), remat=False)

    tdt = torch.float32 if param_dtype == "fp32" else torch.bfloat16
    sd = wan_dit_state_dict_from_jax(
        jax.tree.map(lambda a: np.asarray(a, np.float32), params), port_cfg)
    model = build_wan_model(port_cfg, "cpu", tdt, seed=None)
    model.load_state_dict(sd, strict=True)
    psin, pcos = rope_angles_3d(GRID, port_cfg.head_dim, seq_len=SEQ)
    got = model(torch.from_numpy(x), torch.from_numpy(t),
                torch.from_numpy(ctx), seq_len=SEQ, rope_sin=psin,
                rope_cos=pcos, context_lens=torch.tensor(CTX_LENS),
                policy=DTypePolicy(compute=torch.float32))
    assert got.shape == (B, port_cfg.out_dim, F, H, W)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_state_dict_round_trips_through_jax_converter():
    params = _params(JAX_TINY.model)
    sd = wan_dit_state_dict_from_jax(params, TINY_TEST.model)
    back = convert_wan_dit({k: v.numpy() for k, v in sd.items()},
                           JAX_TINY.model)
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), leaf)


def test_port_model_has_reference_parameter_names():
    model = build_wan_model(TINY_TEST.model, "cpu", torch.float32, seed=0)
    names = set(model.state_dict())
    for n in ("patch_embedding.weight", "text_embedding.0.weight",
              "text_embedding.2.bias", "time_embedding.0.weight",
              "time_projection.1.weight", "head.head.weight",
              "head.modulation", "blocks.1.self_attn.norm_q.weight",
              "blocks.1.cross_attn.o.bias", "blocks.1.norm3.weight",
              "blocks.1.ffn.2.weight", "blocks.1.modulation"):
        assert n in names, n
    assert model.state_dict()["blocks.0.modulation"].shape == (1, 6, 64)
    assert model.state_dict()["patch_embedding.weight"].shape == (
        64, 16, 1, 2, 2)
