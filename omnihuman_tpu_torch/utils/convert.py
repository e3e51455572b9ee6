"""JAX parameter PyTrees -> the port's state dicts (reference names).

Each `*_from_jax` function is the inverse of a converter of the JAX package
(omnihuman_tpu/utils/convert.py): `convert_wan_dit`, `convert_vae` (the
decoder and `conv2`) and `convert_t5`; the APT discriminator's probes and
head come from the JAX params of `apt/model.py:init_apt_discriminator`.
Input is the JAX package's params PyTree as nested dicts / lists of numpy
arrays; output is a {name: torch.Tensor} dict for `load_state_dict`.
`load_wan_dit_checkpoint` reads a reference checkpoint directory's DiT.

Layouts undone here:
  ours Linear [in, out]              -> torch [out, in]           (transpose)
  ours Conv3d [kt, kh, kw, I, O]     -> torch [O, I, kt, kh, kw]
  ours Conv2d [kh, kw, I, O]         -> torch [O, I, kh, kw]
  patch_embedding GEMM [I*kt*kh*kw, O] -> Conv3d [O, I, kt, kh, kw]
  stacked block leaves [num_layers, ...] -> blocks.{i}.*
  modulation tables [6, dim] / [2, dim] -> [1, 6, dim] / [1, 2, dim]
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from omnihuman_tpu_torch.configs.wan import T5Config, VAEConfig, WanModelConfig
from omnihuman_tpu_torch.models.vae import decoder_spec

StateDict = Dict[str, torch.Tensor]


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))    # a writable, contiguous copy


def _put_linear(sd: StateDict, name: str, p: Mapping[str, Any],
                i: int = None) -> None:
    w, b = np.asarray(p["w"]), np.asarray(p["b"])
    if i is not None:
        w, b = w[i], b[i]
    sd[f"{name}.weight"] = _t(w.T)
    sd[f"{name}.bias"] = _t(b)


def wan_dit_state_dict_from_jax(params: Mapping[str, Any],
                                cfg: WanModelConfig) -> StateDict:
    """JAX DiT params -> WanModel state dict (inverse of convert_wan_dit)."""
    if cfg.model_type != "t2v":
        raise NotImplementedError("i2v weights come with the i2v slice")
    sd: StateDict = {}
    pe_w = np.asarray(params["patch_embedding"]["w"])     # [I*kt*kh*kw, O]
    sd["patch_embedding.weight"] = _t(pe_w.T.reshape(
        cfg.dim, cfg.in_dim, *cfg.patch_size))
    sd["patch_embedding.bias"] = _t(params["patch_embedding"]["b"])
    _put_linear(sd, "text_embedding.0", params["text_fc1"])
    _put_linear(sd, "text_embedding.2", params["text_fc2"])
    _put_linear(sd, "time_embedding.0", params["time_fc1"])
    _put_linear(sd, "time_embedding.2", params["time_fc2"])
    _put_linear(sd, "time_projection.1", params["time_proj"])
    head = params["head"]
    _put_linear(sd, "head.head", head)
    sd["head.modulation"] = _t(np.asarray(head["modulation"])[None])

    blocks = params["blocks"]
    for i in range(cfg.num_layers):
        base = f"blocks.{i}"
        for which in ("self_attn", "cross_attn"):
            a = blocks[which]
            for proj in ("q", "k", "v", "o"):
                _put_linear(sd, f"{base}.{which}.{proj}", a[proj], i)
            sd[f"{base}.{which}.norm_q.weight"] = _t(
                np.asarray(a["norm_q"]["w"])[i])
            sd[f"{base}.{which}.norm_k.weight"] = _t(
                np.asarray(a["norm_k"]["w"])[i])
        _put_linear(sd, f"{base}.ffn.0", blocks["ffn_fc1"], i)
        _put_linear(sd, f"{base}.ffn.2", blocks["ffn_fc2"], i)
        sd[f"{base}.modulation"] = _t(
            np.asarray(blocks["modulation"])[i][None])
        if cfg.cross_attn_norm:
            sd[f"{base}.norm3.weight"] = _t(np.asarray(
                blocks["norm3"]["w"])[i])
            sd[f"{base}.norm3.bias"] = _t(np.asarray(
                blocks["norm3"]["b"])[i])
    return sd


def _put_conv3d(sd: StateDict, name: str, p) -> None:
    sd[f"{name}.weight"] = _t(np.asarray(p["w"]).transpose(4, 3, 0, 1, 2))
    sd[f"{name}.bias"] = _t(p["b"])


def _put_conv2d(sd: StateDict, name: str, p) -> None:
    sd[f"{name}.weight"] = _t(np.asarray(p["w"]).transpose(3, 2, 0, 1))
    sd[f"{name}.bias"] = _t(p["b"])


def _put_gamma(sd: StateDict, name: str, p, images: bool = False) -> None:
    g = np.asarray(p["gamma"]).reshape(-1)
    sd[f"{name}.gamma"] = _t(g.reshape((-1, 1, 1) if images
                                       else (-1, 1, 1, 1)))


def _put_vae_layer(sd: StateDict, base: str, item, p) -> None:
    kind = item[0]
    if kind == "res":
        _put_gamma(sd, f"{base}.residual.0", p["norm1"])
        _put_conv3d(sd, f"{base}.residual.2", p["conv1"])
        _put_gamma(sd, f"{base}.residual.3", p["norm2"])
        _put_conv3d(sd, f"{base}.residual.6", p["conv2"])
        if "shortcut" in p:
            _put_conv3d(sd, f"{base}.shortcut", p["shortcut"])
    elif kind == "attn":
        _put_gamma(sd, f"{base}.norm", p["norm"], images=True)
        _put_conv2d(sd, f"{base}.to_qkv", p["to_qkv"])
        _put_conv2d(sd, f"{base}.proj", p["proj"])
    elif kind == "resample":
        _put_conv2d(sd, f"{base}.resample.1", p["conv"])
        if "time_conv" in p:
            _put_conv3d(sd, f"{base}.time_conv", p["time_conv"])
    else:
        raise ValueError(kind)


def vae_state_dict_from_jax(params: Mapping[str, Any],
                            cfg: VAEConfig) -> StateDict:
    """JAX VAE params -> WanVAEDecoder state dict (`decoder.*`, `conv2`;
    inverse of the decoder half of convert_vae)."""
    sd: StateDict = {}
    spec = decoder_spec(cfg)
    for si, (item, p) in enumerate(zip(spec, params["decoder"])):
        kind = item[0]
        if kind == "conv_in":
            _put_conv3d(sd, "decoder.conv1", p["conv"])
        elif kind == "head":
            _put_gamma(sd, "decoder.head.0", p["norm"])
            _put_conv3d(sd, "decoder.head.2", p["conv"])
        elif si in (1, 2, 3):
            _put_vae_layer(sd, f"decoder.middle.{si - 1}", item, p)
        else:
            _put_vae_layer(sd, f"decoder.upsamples.{si - 4}", item, p)
    _put_conv3d(sd, "conv2", params["conv2"])
    return sd


def t5_state_dict_from_jax(params: Mapping[str, Any],
                           cfg: T5Config) -> StateDict:
    """JAX umT5 params -> T5Encoder state dict (inverse of convert_t5)."""
    sd: StateDict = {"token_embedding.weight": _t(params["token_embedding"]),
                     "norm.weight": _t(params["norm"]["w"])}
    bl = params["blocks"]
    for i in range(cfg.num_layers):
        b = f"blocks.{i}"
        sd[f"{b}.norm1.weight"] = _t(np.asarray(bl["norm1"]["w"])[i])
        for k in ("q", "k", "v", "o"):
            sd[f"{b}.attn.{k}.weight"] = _t(np.asarray(bl[k])[i].T)
        sd[f"{b}.pos_embedding.embedding.weight"] = _t(
            np.asarray(bl["pos_emb"])[i])
        sd[f"{b}.norm2.weight"] = _t(np.asarray(bl["norm2"]["w"])[i])
        sd[f"{b}.ffn.gate.0.weight"] = _t(np.asarray(bl["gate"])[i].T)
        sd[f"{b}.ffn.fc1.weight"] = _t(np.asarray(bl["fc1"])[i].T)
        sd[f"{b}.ffn.fc2.weight"] = _t(np.asarray(bl["fc2"])[i].T)
    return sd


def _put_norm(sd: StateDict, name: str, p: Mapping[str, Any]) -> None:
    sd[f"{name}.weight"] = _t(p["w"])
    sd[f"{name}.bias"] = _t(p["b"])


def apt_discriminator_state_dict_from_jax(params: Mapping[str, Any],
                                          cfg: WanModelConfig) -> StateDict:
    """JAX APT discriminator params (apt/model.py:init_apt_discriminator:
    backbone, probes, final_norm, final_proj) -> APTDiscriminator state
    dict. Probe linears [in, out] become torch [out, in]; the backbone goes
    through `wan_dit_state_dict_from_jax` under `backbone.`."""
    sd: StateDict = {}
    for tap, p in params["probes"].items():
        base = f"probes.{tap}"
        sd[f"{base}.query_token"] = _t(p["query_token"])
        for norm in ("norm", "q_norm", "k_norm"):
            _put_norm(sd, f"{base}.{norm}", p[norm])
        for proj in ("q", "k", "v", "o"):
            _put_linear(sd, f"{base}.{proj}", p[proj])
    _put_norm(sd, "final_norm", params["final_norm"])
    _put_linear(sd, "final_proj", params["final_proj"])
    for k, v in wan_dit_state_dict_from_jax(params["backbone"], cfg).items():
        sd[f"backbone.{k}"] = v
    return sd


def load_wan_dit_checkpoint(model, checkpoint_dir: str) -> None:
    """Load the DiT weights of a reference checkpoint directory (every
    `*.safetensors` file in it, reference parameter names, as the JAX
    WanT2V._load_checkpoint reads it) into `model`, cast to its dtype."""
    import os

    from safetensors.torch import load_file
    files = sorted(f for f in os.listdir(checkpoint_dir)
                   if f.endswith(".safetensors"))
    if not files:
        raise FileNotFoundError(f"no *.safetensors in {checkpoint_dir}")
    sd: StateDict = {}
    for f in files:
        sd.update(load_file(os.path.join(checkpoint_dir, f)))
    model.load_state_dict(sd, strict=True)
