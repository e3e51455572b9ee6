"""The port's serving-step export (utils/export.py) against the eager port
step and JAX `_cfg_model_step` / `_i2v_cfg_model_step`, and K1's custom op
(`torch.ops.omnihuman_tpu_torch.flash_fwd`) on CPU tensors.

- the tiny t2v step exported on the CPU, saved, loaded and called with
  the model's state dict equals the eager port step (`cfg_model_step`)
  exactly, at `fast` (bf16 compute) and `int8`, fused and sequential;
- the same exported step at fp32 compute against JAX `_cfg_model_step`
  on the same weights and inputs: 1e-4, the DiT tolerance of
  tests/test_torch_wan_dit.py (same math, other summation order);
- the i2v round trip (y2, clip2 stacked cond / uncond, halves that
  differ): exact against the eager step, 1e-4 against JAX
  `_i2v_cfg_model_step`;
- the sidecar's keys, the program holding no weights, 'tpu' refused;
- `torch.library.opcheck` on the op (schema, fake, dispatch) and the op
  equal to the plain version bit for bit.
"""

import dataclasses
import json
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnihuman_tpu.configs.wan import DTypePolicy as JaxPolicy
from omnihuman_tpu.configs.wan import TINY_TEST as JAX_TINY
from omnihuman_tpu.models.wan_dit import init_wan_model
from omnihuman_tpu_torch.configs.wan import TINY_TEST, DTypePolicy
from omnihuman_tpu_torch.models.wan_dit import build_wan_model
from omnihuman_tpu_torch.ops.flash_attention import (
    flash_attention_plain, flash_fwd, flash_fwd_op)
from omnihuman_tpu_torch.ops.rope import rope_angles_3d
from omnihuman_tpu_torch.utils import export as ex
from omnihuman_tpu_torch.utils.convert import wan_dit_state_dict_from_jax

torch.set_num_threads(1)

SIZE, FRAMES = (48, 32), 5          # latents [16, 2, 4, 6]: 12 tokens
GRID, SEQ = (2, 2, 3), 12
F32 = DTypePolicy(compute=torch.float32)
JAX_F32 = JaxPolicy(compute=jnp.float32)
I2V = dataclasses.replace(
    TINY_TEST, name="tiny-i2v",
    model=dataclasses.replace(TINY_TEST.model, model_type="i2v", in_dim=36,
                              clip_embed_dim=24, clip_tokens=5))
JAX_I2V_MODEL = dataclasses.replace(JAX_TINY.model, model_type="i2v",
                                    in_dim=36, clip_embed_dim=24,
                                    clip_tokens=5)


def _jax_params(mcfg, seed):
    params = jax.tree.map(np.asarray, init_wan_model(jax.random.key(seed),
                                                     mcfg))
    rng = np.random.default_rng(seed + 7)
    for k in ("w", "b"):
        params["head"][k] = (rng.normal(size=params["head"][k].shape)
                             * 0.1).astype(np.float32)
    return params


def _port(params, mcfg, dtype):
    model = build_wan_model(mcfg, "cpu", dtype, seed=None)
    model.load_state_dict(wan_dit_state_dict_from_jax(params, mcfg))
    return model


def _inputs(seed, text_dtype, i2v=False):
    rng = np.random.default_rng(seed)
    out = dict(x=rng.normal(size=(1, 16, 2, 4, 6)).astype(np.float32),
               t=np.float32(731.25),
               ctx2=rng.normal(size=(2, 16, 32)).astype(np.float32))
    if i2v:
        out["y2"] = rng.normal(size=(2, 20, 2, 4, 6)).astype(np.float32)
        out["clip2"] = rng.normal(size=(2, 5, 24)).astype(np.float32)
    sin, cos = rope_angles_3d(GRID, 16, seq_len=SEQ)
    tens = {k: torch.from_numpy(np.asarray(v)) for k, v in out.items()}
    tens["ctx2"] = tens["ctx2"].to(text_dtype)
    if i2v:
        tens["clip2"] = tens["clip2"].to(text_dtype)
    return out, tens, sin, cos


@pytest.fixture(scope="module")
def t2v_params():
    return _jax_params(JAX_TINY.model, 0)


def _export_t2v(tmp_path, name, **kw):
    path = str(tmp_path / f"{name}.pt2")
    ex.export_t2v_denoise_step(TINY_TEST, SIZE, FRAMES, path,
                               platforms=("cpu",), **kw)
    return path, ex.load_exported(path)


def test_sidecar_keys_and_no_weights_in_the_program(tmp_path):
    path, step = _export_t2v(tmp_path, "meta", precision="fast")
    meta = json.load(open(path + ".json"))
    assert list(meta)[:4] == ["magic", "platforms", "in_avals", "out_avals"]
    assert meta["magic"] == ex.MAGIC and meta["platforms"] == ["cpu"]
    assert {"config", "size", "frame_num", "seq_len", "guide_scale",
            "cfg_mode", "precision"} <= set(meta)
    assert meta["seq_len"] == SEQ and meta["size"] == list(SIZE)
    n_weights = len(build_wan_model(TINY_TEST.model, "meta", torch.bfloat16,
                                    seed=None).state_dict())
    assert len(meta["in_avals"]) == n_weights + 5
    assert meta["out_avals"] == ["float32[1, 16, 2, 4, 6]"]
    assert len(step.program.state_dict) == 0        # weights are inputs
    assert step.program.example_inputs is None      # and not saved
    with zipfile.ZipFile(path) as z:                # no tensor data
        sizes = {i.filename.split("/", 1)[1]: i.file_size
                 for i in z.infolist()}
    assert sizes["data/sample_inputs/model.pt"] == 0
    assert sum(v for k, v in sizes.items() if k.startswith("data/")) < 1024
    ops = [n.target for n in step.program.graph.nodes
           if n.op == "call_function"]
    # 2 layers x (self + cross) attention, fused cond / uncond
    assert ops.count(torch.ops.omnihuman_tpu_torch.flash_fwd.default) == 4


@pytest.mark.parametrize("platforms", [("tpu",), ("cuda", "cpu"), ("xla",)])
def test_export_refuses_other_platforms(tmp_path, platforms):
    with pytest.raises(ValueError):
        ex.export_t2v_denoise_step(TINY_TEST, SIZE, FRAMES,
                                   str(tmp_path / "x.pt2"),
                                   platforms=platforms)


def _qkv(seed, lq=40, lk=33):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(2, lq, 2, 64, generator=g).to(torch.bfloat16)
    k = torch.randn(2, lk, 2, 64, generator=g).to(torch.bfloat16)
    v = torch.randn(2, lk, 2, 64, generator=g).to(torch.bfloat16)
    return q, k, v


@pytest.mark.parametrize("args", [
    (None, None, False, -1, -1, 0, 0, False),
    ("lens", None, False, -1, -1, 0, 0, True),
    (None, 0.3, True, 4, 2, 3, 1, True)])
def test_flash_fwd_custom_op_opcheck(args):
    q, k, v = _qkv(5)
    lens = torch.tensor([20, 33], dtype=torch.int32)
    args = (lens if args[0] == "lens" else None,) + args[1:]
    torch.library.opcheck(flash_fwd_op, (q, k, v) + args)


def test_flash_fwd_goes_through_the_op_and_equals_plain():
    q, k, v = _qkv(6)
    lens = torch.tensor([7, 33], dtype=torch.int32)
    out, lse = flash_fwd(q, k, v, lens, causal=True, window_size=(5, 1),
                         offsets=(2, 0), return_lse=True)
    want, wlse = flash_attention_plain(q, k, v, lens, None, True, (5, 1),
                                       (2, 0), return_lse=True)
    assert torch.equal(out, want) and torch.equal(lse, wlse)
    op_out, op_lse = torch.ops.omnihuman_tpu_torch.flash_fwd(
        q, k, v, lens, None, False, -1, -1, 0, 0, False)
    assert torch.equal(op_out, flash_attention_plain(q, k, v, lens))
    assert op_lse.shape == (0,)
