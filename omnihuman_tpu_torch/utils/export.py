"""Serving-step export: the t2v / i2v CFG denoise step as a `torch.export`
program (port of omnihuman_tpu/utils/export.py).

The JAX package serialises a jitted step with `jax.export`; the port
traces the same step with `torch.export.export` and writes it with
`torch.export.save` (`.pt2`) beside a `.json` sidecar with the JAX keys
(`magic`, `platforms`, `in_avals`, `out_avals`, then the step's metadata).
The weights are the program's first INPUT, a dict in the model's
`state_dict()` names, swapped into the module by
`torch.func.functional_call`: the artifact holds no weights, and serving
passes the checkpoint's tensors at each call, as in JAX. Signatures:

    t2v: (params, x [1, 16, F, H, W] fp32, t [] fp32, ctx2 [2, text_len,
          text_dim], rope_sin, rope_cos [seq_len, head_dim // 2] fp32)
    i2v: (params, x, t, ctx2, y2 [2, in_dim - 16, F, H, W] fp32,
          clip2 [2, 257, clip_embed_dim], rope_sin, rope_cos)

Every attention of the step is the custom op
`torch.ops.omnihuman_tpu_torch.flash_fwd` (ops/flash_attention.py), so the
loaded program launches K1 on CUDA tensors and runs the plain version on
CPU tensors. The program is traced at fixed shapes on the device of its
example inputs (`platforms`: "cuda" or "cpu"; one artifact per size
bucket, as in JAX). Like JAX's, the step takes no context lengths: the
text keys are all `text_len` of them, and the pipeline's 128-bucket trim
stays outside the program.
"""

from __future__ import annotations

import json
import math
import os
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from omnihuman_tpu_torch.models.wan_dit import WanModel, padded_seq_len
from omnihuman_tpu_torch.ops import flash_attention  # noqa: F401 (the op)
from omnihuman_tpu_torch.ops.quant import quantize_wan_model
from omnihuman_tpu_torch.pipelines.text2video import (
    cfg_model_step, resolve_device, serving_policy)

MAGIC = "omnihuman_tpu_torch.export.v1"


def _resolve_platform(platforms: Sequence[str]) -> torch.device:
    """The device the program is traced for: one of 'cuda' and 'cpu'."""
    platforms = tuple(platforms)
    if len(platforms) != 1:
        raise ValueError(f"platforms {platforms}: the port traces for one "
                         "device, 'cuda' or 'cpu'")
    if platforms[0] == "tpu":
        raise ValueError("a 'tpu' artifact is the JAX package's "
                         "(omnihuman_tpu.utils.export); the port exports "
                         "for 'cuda' or 'cpu'")
    if platforms[0] not in ("cuda", "cpu"):
        raise ValueError(f"unknown platform {platforms[0]!r}; expected "
                         "'cuda' or 'cpu'")
    return resolve_device(None if platforms[0] == "cuda" else "cpu")


def signature_model(mcfg, param_dtype: torch.dtype,
                    precision: str) -> WanModel:
    """A weightless (meta) DiT whose `state_dict()` is the params
    signature: every tensor in `param_dtype`, and with 'int8' the block
    GEMMs in the quantised (w_q int8, w_s fp32, bias) layout of
    ops/quant.py, so the artifact expects pre-quantised weights."""
    with torch.device("meta"):
        model = WanModel(mcfg)
    model = model.to(param_dtype).eval().requires_grad_(False)
    if precision == "int8":
        quantize_wan_model(model)
    return model


def example_params(model: nn.Module, device) -> Dict[str, torch.Tensor]:
    """Uninitialised tensors of the model's state dict on `device`: the
    shapes the trace needs (their values are never read)."""
    return {k: torch.empty(v.shape, dtype=v.dtype, device=device)
            for k, v in model.state_dict().items()}


class _Step(nn.Module):
    """`fn(model, *inputs, **statics)` as a module: the target of
    `functional_call`, whose parameters come from the params input."""

    def __init__(self, model: nn.Module, fn: Callable, statics: Dict):
        super().__init__()
        self.model = model
        self.fn = fn
        self.statics = statics

    def forward(self, *inputs):
        return self.fn(self.model, *inputs, **self.statics)


class _Program(nn.Module):
    """forward(params, *inputs): the step with `params` swapped in. The
    step is held outside the module's state, so the traced program owns
    no tensor of the model."""

    def __init__(self, step: _Step):
        super().__init__()
        self.__dict__["_step"] = step

    def forward(self, params: Dict[str, torch.Tensor], *inputs):
        named = {f"model.{k}": v for k, v in params.items()}
        return torch.func.functional_call(self._step, named, inputs,
                                          strict=True)


def _aval(t: torch.Tensor) -> str:
    return f"{str(t.dtype).removeprefix('torch.')}{list(t.shape)}"


def export_program(fn: Callable, model: nn.Module, args: Sequence[Any],
                   path: str, statics: Optional[Dict] = None,
                   metadata: Optional[Dict[str, Any]] = None) -> str:
    """Trace `fn(model, *args[1:], **statics)` with `args[0]` (a dict of
    the model's state) as its weights (JAX `export_jitted`), save it to
    `path` with `torch.export.save` and write the `.json` sidecar. The
    example tensors fix the shapes, dtypes and device of the program.
    Returns the path written."""
    program = _Program(_Step(model, fn, dict(statics or {})))
    ep = torch.export.export(program, tuple(args), strict=False)
    out_node = next(n for n in ep.graph.nodes if n.op == "output")
    outs = [a.meta["val"] for a in torch.utils._pytree.tree_leaves(
        out_node.args[0]) if isinstance(a, torch.fx.Node)]
    leaves = torch.utils._pytree.tree_leaves(tuple(args))
    devices = sorted({t.device.type for t in leaves})
    meta = {"magic": MAGIC, "platforms": devices,
            "in_avals": [_aval(t) for t in leaves],
            "out_avals": [_aval(t) for t in outs]}
    meta.update(metadata or {})
    # the program keeps its example inputs, which `save` would write: the
    # (uninitialised) weights among them. Drop them: the artifact holds
    # the graph and its signature only.
    ep.example_inputs = None
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.export.save(ep, path)
    with open(path + ".json", "w") as f:
        json.dump(meta, f, indent=1)
    return path


class LoadedStep:
    """A loaded artifact: `call(params, *inputs)` runs it (JAX
    `Exported.call`; `params` a mapping such as `model.state_dict()`),
    `program` is the `torch.export.ExportedProgram`, `metadata` the
    sidecar (None without one)."""

    def __init__(self, program, metadata: Optional[Dict[str, Any]]):
        self.program = program
        self.metadata = metadata
        self._module = program.module()

    def call(self, params, *inputs):
        return self._module(dict(params), *inputs)


def load_exported(path: str) -> LoadedStep:
    """Read an artifact written by `export_program`. The custom op it
    calls is registered by this module's import of ops/flash_attention."""
    meta = None
    if os.path.exists(path + ".json"):
        with open(path + ".json") as f:
            meta = json.load(f)
        if meta.get("magic") != MAGIC:
            raise ValueError(f"{path}.json: magic {meta.get('magic')!r} is "
                             f"not {MAGIC!r}")
    return LoadedStep(torch.export.load(path), meta)


def _geometry(config, size: Tuple[int, int], frame_num: int):
    """(lat_f, lat_h, lat_w) and the padded seq_len of a (W, H) size."""
    w, h = size
    lat = ((frame_num - 1) // config.vae_stride[0] + 1,
           h // config.vae_stride[1], w // config.vae_stride[2])
    grid = tuple(s // p for s, p in zip(lat, config.model.patch_size))
    return lat, padded_seq_len(math.prod(grid))


def _t2v_step(model, x, t, ctx2, rope_sin, rope_cos, **statics):
    return cfg_model_step(model, x, t, ctx2, rope_sin, rope_cos, **statics)


def _i2v_step(model, x, t, ctx2, y2, clip2, rope_sin, rope_cos, **statics):
    return cfg_model_step(model, x, t, ctx2, rope_sin, rope_cos, y=y2,
                          clip_fea=clip2, **statics)


def export_t2v_denoise_step(
        config, size: Tuple[int, int], frame_num: int, path: str,
        guide_scale: float = 5.0, platforms: Tuple[str, ...] = ("cuda",),
        cfg_mode: str = "fused", precision: str = "reference",
        param_dtype: Optional[torch.dtype] = None) -> str:
    """Export the t2v CFG denoise step of a registry config at a fixed
    (W, H) size and frame_num. Signature (params, x, t, ctx2, rope_sin,
    rope_cos): pass the checkpoint's state dict at serve time."""
    dev = _resolve_platform(platforms)
    mcfg = config.model
    pd = param_dtype or torch.bfloat16
    lat, seq_len = _geometry(config, size, frame_num)
    model = signature_model(mcfg, pd, precision)
    half = mcfg.head_dim // 2
    args = (example_params(model, dev),
            torch.empty((1, mcfg.in_dim, *lat), device=dev),
            torch.empty((), device=dev),
            torch.empty((2, mcfg.text_len, mcfg.text_dim), dtype=pd,
                        device=dev),
            torch.empty((seq_len, half), device=dev),
            torch.empty((seq_len, half), device=dev))
    statics = dict(policy=serving_policy(config, precision),
                   seq_len=seq_len, guide_scale=float(guide_scale),
                   cfg_mode=cfg_mode)
    return export_program(
        _t2v_step, model, args, path, statics,
        metadata={"config": getattr(config, "name", "?"),
                  "size": list(size), "frame_num": frame_num,
                  "seq_len": seq_len, "guide_scale": guide_scale,
                  "cfg_mode": cfg_mode, "precision": precision})


def export_i2v_denoise_step(
        config, size: Tuple[int, int], frame_num: int, path: str,
        guide_scale: float = 5.0, platforms: Tuple[str, ...] = ("cuda",),
        cfg_mode: str = "fused", precision: str = "reference",
        param_dtype: Optional[torch.dtype] = None) -> str:
    """The i2v step: signature (params, x, t, ctx2, y2, clip2, rope_sin,
    rope_cos), y2 the [mask ++ reference-latent] channels and clip2 the
    CLIP image tokens, both stacked cond / uncond like ctx2."""
    dev = _resolve_platform(platforms)
    mcfg = config.model
    pd = param_dtype or torch.bfloat16
    lat, seq_len = _geometry(config, size, frame_num)
    model = signature_model(mcfg, pd, precision)
    half = mcfg.head_dim // 2
    args = (example_params(model, dev),
            torch.empty((1, 16, *lat), device=dev),
            torch.empty((), device=dev),
            torch.empty((2, mcfg.text_len, mcfg.text_dim), dtype=pd,
                        device=dev),
            torch.empty((2, mcfg.in_dim - 16, *lat), device=dev),
            torch.empty((2, mcfg.clip_tokens, mcfg.clip_embed_dim),
                        dtype=pd, device=dev),
            torch.empty((seq_len, half), device=dev),
            torch.empty((seq_len, half), device=dev))
    statics = dict(policy=serving_policy(config, precision),
                   seq_len=seq_len, guide_scale=float(guide_scale),
                   cfg_mode=cfg_mode)
    return export_program(
        _i2v_step, model, args, path, statics,
        metadata={"config": getattr(config, "name", "?"), "task": "i2v",
                  "size": list(size), "frame_num": frame_num,
                  "seq_len": seq_len, "guide_scale": guide_scale,
                  "cfg_mode": cfg_mode, "precision": precision})
