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

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from omnihuman_tpu.configs.wan import TINY_TEST as JAX_TINY
from omnihuman_tpu.models.wan_dit import init_wan_model
from omnihuman_tpu.ops import quant as jq
from omnihuman_tpu_torch.ops import quant

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


def test_generate_cli_runs_int8_on_cpu(tmp_path):
    from omnihuman_tpu_torch.cli.generate import main
    out = main(["--task", "tiny-test", "--size", "64*64", "--frame_num", "5",
                "--sample_steps", "2", "--base_seed", "0", "--precision",
                "int8", "--device", "cpu",
                "--save_file", str(tmp_path / "clip.mp4")])
    assert os.path.exists(out) and os.path.getsize(out) > 0
