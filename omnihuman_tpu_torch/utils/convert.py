"""JAX parameter PyTrees -> the port's state dicts (reference names).

Each `*_from_jax` function is the inverse of a converter of the JAX package
(omnihuman_tpu/utils/convert.py): `convert_wan_dit` (t2v and i2v),
`convert_vae`, `convert_t5` and the visual tower of `convert_clip`; the APT
discriminator's probes and head come from the JAX params of
`apt/model.py:init_apt_discriminator`, the OmniHuman model's from those of
`omni/model.py:init_omni_model`, the f-distill MLP discriminator's from
`apt/f_distill.py:init_mlp_discriminator`; the pose and evaluation
networks' invert `convert_sapiens`, `convert_inception_torch`,
`convert_i3d` and `convert_syncc` (released sapiens-pose, torchvision,
piergiaj and two-tower names).
Input is the JAX package's params PyTree as nested dicts / lists of numpy
arrays; output is a {name: torch.Tensor} dict for `load_state_dict`.
`load_wan_dit_checkpoint` reads a reference checkpoint directory's DiT;
`load_named` loads the entries of a released state dict a module holds.

Layouts undone here:
  ours Linear [in, out]              -> torch [out, in]           (transpose)
  ours Conv3d [kt, kh, kw, I, O]     -> torch [O, I, kt, kh, kw]
  ours Conv2d [kh, kw, I, O]         -> torch [O, I, kh, kw]
  patch_embedding GEMM [I*kt*kh*kw, O] -> Conv3d [O, I, kt, kh, kw]
  CLIP patch_embedding GEMM [3*p*p, O] -> Conv2d [O, 3, p, p]
  stacked block leaves [num_layers, ...] -> blocks.{i}.*
  modulation tables [6, dim] / [2, dim] -> [1, 6, dim] / [1, 2, dim]
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from omnihuman_tpu_torch.configs.wan import (
    CLIPConfig, T5Config, VAEConfig, WanModelConfig)
from omnihuman_tpu_torch.models.vae import decoder_spec, encoder_spec

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
    """JAX DiT params -> WanModel state dict (inverse of convert_wan_dit,
    the i2v keys included: `img_emb`, `k_img`, `v_img`, `norm_k_img`)."""
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
            if "k_img" in a:
                _put_linear(sd, f"{base}.{which}.k_img", a["k_img"], i)
                _put_linear(sd, f"{base}.{which}.v_img", a["v_img"], i)
                sd[f"{base}.{which}.norm_k_img.weight"] = _t(
                    np.asarray(a["norm_k_img"]["w"])[i])
        _put_linear(sd, f"{base}.ffn.0", blocks["ffn_fc1"], i)
        _put_linear(sd, f"{base}.ffn.2", blocks["ffn_fc2"], i)
        sd[f"{base}.modulation"] = _t(
            np.asarray(blocks["modulation"])[i][None])
        if cfg.cross_attn_norm:
            sd[f"{base}.norm3.weight"] = _t(np.asarray(
                blocks["norm3"]["w"])[i])
            sd[f"{base}.norm3.bias"] = _t(np.asarray(
                blocks["norm3"]["b"])[i])
    if "img_emb" in params:
        ie = params["img_emb"]
        _put_norm(sd, "img_emb.proj.0", ie["ln1"])
        _put_linear(sd, "img_emb.proj.1", ie["fc1"])
        _put_linear(sd, "img_emb.proj.3", ie["fc2"])
        _put_norm(sd, "img_emb.proj.4", ie["ln2"])
    return sd


def omni_state_dict_from_jax(params: Mapping[str, Any],
                             cfg) -> StateDict:
    """JAX omni params ({"base": DiT params with stacked
    `blocks.audio_attn`, "cond": the condition encoders}) -> OmniModel
    state dict (`base.*`, `base.blocks.{i}.audio_attn.*`, `cond.*`);
    `cfg` is the port's OmniModelConfig."""
    sd: StateDict = {f"base.{k}": v for k, v in
                     wan_dit_state_dict_from_jax(params["base"],
                                                 cfg.base).items()}
    ad = params["base"]["blocks"]["audio_attn"]
    for i in range(cfg.base.num_layers):
        base = f"base.blocks.{i}.audio_attn"
        for proj in ("q", "k", "v", "o"):
            _put_linear(sd, f"{base}.{proj}", ad[proj], i)
        sd[f"{base}.norm.weight"] = _t(np.asarray(ad["norm"]["w"])[i])
        sd[f"{base}.norm.bias"] = _t(np.asarray(ad["norm"]["b"])[i])
        sd[f"{base}.norm_q.weight"] = _t(np.asarray(ad["norm_q"]["w"])[i])
        sd[f"{base}.norm_k.weight"] = _t(np.asarray(ad["norm_k"]["w"])[i])
        sd[f"{base}.gate"] = _t(np.asarray(ad["gate"])[i])
    cond = params["cond"]
    for name in ("audio_fc1", "audio_fc2", "audio_merge", "pose_proj"):
        _put_linear(sd, f"cond.{name}", cond[name])
    for name in ("pose_conv1", "pose_conv2", "pose_conv3"):
        _put_conv3d(sd, f"cond.{name}", cond[name])
    sd["cond.temporal_embed"] = _t(cond["temporal_embed"])
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


def _put_vae_stack(sd: StateDict, prefix: str, spec, params,
                   middle: range) -> None:
    """One spec list onto the reference's conv1 / downsamples or upsamples /
    middle / head names (JAX _vae_stack)."""
    seq = "downsamples" if prefix == "encoder" else "upsamples"
    seq_idx = 0
    for si, (item, p) in enumerate(zip(spec, params)):
        kind = item[0]
        if kind == "conv_in":
            _put_conv3d(sd, f"{prefix}.conv1", p["conv"])
        elif kind == "head":
            _put_gamma(sd, f"{prefix}.head.0", p["norm"])
            _put_conv3d(sd, f"{prefix}.head.2", p["conv"])
        elif si in middle:
            _put_vae_layer(sd, f"{prefix}.middle.{si - middle.start}", item,
                           p)
        else:
            _put_vae_layer(sd, f"{prefix}.{seq}.{seq_idx}", item, p)
            seq_idx += 1


def vae_state_dict_from_jax(params: Mapping[str, Any],
                            cfg: VAEConfig) -> StateDict:
    """JAX VAE params -> WanVAE state dict (`encoder.*`, `conv1`,
    `decoder.*`, `conv2`; inverse of convert_vae)."""
    sd: StateDict = {}
    es, ds = encoder_spec(cfg), decoder_spec(cfg)
    _put_vae_stack(sd, "encoder", es, params["encoder"],
                   range(len(es) - 4, len(es) - 1))
    _put_vae_stack(sd, "decoder", ds, params["decoder"], range(1, 4))
    _put_conv3d(sd, "conv1", params["conv1"])
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


def clip_visual_state_dict_from_jax(params: Mapping[str, Any],
                                    cfg: CLIPConfig) -> StateDict:
    """JAX CLIP params (init_clip / convert_clip) -> the port's CLIP state
    dict, the visual tower (`visual.*`, inverse of convert_clip's visual
    half); the XLM-R text tower is not ported."""
    vp = params["visual"] if "visual" in params else params
    dim, p = cfg.vision_dim, cfg.patch_size
    pe = np.asarray(vp["patch_embedding"]["w"])          # [3*p*p, O]
    sd: StateDict = {
        "visual.patch_embedding.weight": _t(pe.T.reshape(dim, 3, p, p)),
        "visual.cls_embedding": _t(vp["cls_embedding"]),
        "visual.pos_embedding": _t(vp["pos_embedding"]),
        "visual.head": _t(vp["head"]),
    }
    _put_norm(sd, "visual.pre_norm", vp["pre_norm"])
    _put_norm(sd, "visual.post_norm", vp["post_norm"])
    bl = vp["blocks"]
    for i in range(cfg.vision_layers):
        base = f"visual.transformer.{i}"
        for norm in ("norm1", "norm2"):
            sd[f"{base}.{norm}.weight"] = _t(np.asarray(bl[norm]["w"])[i])
            sd[f"{base}.{norm}.bias"] = _t(np.asarray(bl[norm]["b"])[i])
        _put_linear(sd, f"{base}.attn.to_qkv", bl["qkv"], i)
        _put_linear(sd, f"{base}.attn.proj", bl["proj"], i)
        _put_linear(sd, f"{base}.mlp.0", bl["fc1"], i)
        _put_linear(sd, f"{base}.mlp.2", bl["fc2"], i)
    return sd


def load_wan_dit_checkpoint(model, checkpoint_dir: str) -> None:
    """Load the DiT weights of a reference checkpoint directory (every
    `*.safetensors` file in it, reference parameter names, as the JAX
    WanT2V._load_checkpoint reads it) into `model`, cast to its dtype."""
    sd, _ = load_wan_checkpoint_dir(checkpoint_dir, model.cfg)
    if sd is None:
        raise FileNotFoundError(f"no *.safetensors in {checkpoint_dir}")
    model.load_state_dict(sd, strict=True)


def omni_train_state_from_jax(state, cfg) -> Dict[str, Any]:
    """A JAX OmniTrainState (params, optax opt_state, step; numpy or jax
    arrays) -> the state dict `omni/trainer.py:OmniTrainState` loads:
    {"params", "opt_state": {"count", "mu", "nu"}, "step"}. AdamW's moments
    sit in optax's ScaleByAdamState (found by its fields inside the chain's
    nested state) and have the parameters' layout, so they go through the
    same carrier as the parameters."""
    adam = _find_adam_state(state.opt_state)
    if adam is None:
        raise ValueError("no optax ScaleByAdamState (mu, nu, count) in the "
                         "optimizer state")
    return {"params": omni_state_dict_from_jax(state.params, cfg),
            "opt_state": {"count": int(np.asarray(adam.count)),
                          "mu": omni_state_dict_from_jax(adam.mu, cfg),
                          "nu": omni_state_dict_from_jax(adam.nu, cfg)},
            "step": int(np.asarray(state.step))}


def mlp_discriminator_state_dict_from_jax(params: Mapping[str, Any]
                                          ) -> StateDict:
    """JAX f-distill MLP discriminator params (apt/f_distill.py:
    init_mlp_discriminator: fc1 / fc2 / fc3, w [in, out]) ->
    MLPDiscriminator state dict."""
    sd: StateDict = {}
    for name in ("fc1", "fc2", "fc3"):
        _put_linear(sd, name, params[name])
    return sd


def f_distill_state_from_jax(state, cfg: WanModelConfig) -> Dict[str, Any]:
    """A JAX FDistillState (student params and optax adamw state, MLP
    discriminator params and optax adam state, step) -> the state dict
    `apt/f_distill.py:FDistillState` loads: {"params", "opt_state":
    {"count", "mu", "nu"}, "d_params", "d_opt_state", "step"}. Each Adam
    state is found by its fields, as in `omni_train_state_from_jax`."""
    out: Dict[str, Any] = {"step": int(np.asarray(state.step))}
    for key, opt_key, params, opt, carry in (
            ("params", "opt_state", state.params, state.opt_state,
             lambda t: wan_dit_state_dict_from_jax(t, cfg)),
            ("d_params", "d_opt_state", state.d_params, state.d_opt_state,
             mlp_discriminator_state_dict_from_jax)):
        adam = _find_adam_state(opt)
        if adam is None:
            raise ValueError(f"no optax ScaleByAdamState in {opt_key}")
        out[key] = carry(params)
        out[opt_key] = {"count": int(np.asarray(adam.count)),
                        "mu": carry(adam.mu), "nu": carry(adam.nu)}
    return out


def _find_adam_state(node):
    if all(hasattr(node, f) for f in ("mu", "nu", "count")):
        return node
    if isinstance(node, (tuple, list)):
        for child in node:
            found = _find_adam_state(child)
            if found is not None:
                return found
    return None


def load_torch_state_dict(path: str) -> StateDict:
    """A `.safetensors` or `torch.save` file -> {name: tensor} on the host
    (a `{"state_dict": ...}` wrapper is unwrapped)."""
    if path.endswith(".safetensors"):
        from safetensors.torch import load_file
        return dict(load_file(path))
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return dict(sd)


def load_wan_checkpoint_dir(ckpt_dir: str, model_cfg: WanModelConfig,
                            vae_cfg: VAEConfig = None,
                            vae_seed: Optional[int] = 1, device="cpu",
                            dtype: torch.dtype = torch.float32):
    """A Wan checkpoint directory in the reference layout (JAX
    `utils/convert.py:load_wan_checkpoint_dir`):

      *.safetensors shards -> the DiT's state dict (None when there are
                              none), checked against `model_cfg`'s names
                              and shapes
      Wan2.1_VAE.pth       -> a WanVAE on `device` in `dtype` loaded
                              strictly; without the file, a random one
                              from `vae_seed`, or FileNotFoundError when
                              `vae_seed` is None (JAX `WanT2V`'s rule);
                              None when `vae_cfg` is None

    Returns (dit_state_dict | None, vae | None). The umT5 file is read by
    `models/t5.py:load_t5_encoder`."""
    import os

    from omnihuman_tpu_torch.models.vae import build_vae
    from omnihuman_tpu_torch.models.wan_dit import WanModel

    dit_sd: StateDict = {}
    for fn in sorted(os.listdir(ckpt_dir)):
        if fn.endswith(".safetensors"):
            dit_sd.update(load_torch_state_dict(os.path.join(ckpt_dir, fn)))
    if dit_sd:
        with torch.device("meta"):
            want = WanModel(model_cfg).state_dict()
        missing, extra = set(want) - set(dit_sd), set(dit_sd) - set(want)
        if missing or extra:
            raise ValueError(f"{ckpt_dir}: DiT keys missing "
                             f"{sorted(missing)[:5]}, unexpected "
                             f"{sorted(extra)[:5]}")
        for k, v in want.items():
            if dit_sd[k].shape != v.shape:
                raise ValueError(f"{ckpt_dir}: {k} {tuple(dit_sd[k].shape)} "
                                 f"!= {tuple(v.shape)}")
    vae = None
    if vae_cfg is not None:
        vae_path = os.path.join(ckpt_dir, "Wan2.1_VAE.pth")
        if os.path.exists(vae_path):
            vae = build_vae(vae_cfg, device, dtype, seed=None)
            vae.load_state_dict(load_torch_state_dict(vae_path), strict=True)
        elif vae_seed is None:
            raise FileNotFoundError(f"no Wan2.1_VAE.pth in {ckpt_dir}")
        else:
            vae = build_vae(vae_cfg, device, dtype, seed=vae_seed)
    return (dit_sd or None), vae


def load_named(model: torch.nn.Module, state_dict: Mapping[str, Any],
               what: str = "state dict") -> None:
    """Load, strictly, the entries of `state_dict` that `model` names (a
    released file's reference names): entries the model does not hold are
    ignored (the heads and towers of a bigger checkpoint); a missing one
    raises KeyError naming it; a BatchNorm's `num_batches_tracked`, unused
    at eval, may be absent."""
    want = model.state_dict()
    sd: StateDict = {}
    for k, v in want.items():
        if k in state_dict:
            x = state_dict[k]
            sd[k] = x if torch.is_tensor(x) else _t(x)
        elif k.endswith("num_batches_tracked"):
            sd[k] = v
        else:
            raise KeyError(f"{what}: missing '{k}' (have e.g. "
                           f"{sorted(state_dict)[:5]}...)")
    model.load_state_dict(sd, strict=True)


# ---------------------------------------------------------------------------
# the pose and evaluation models: inverses of the JAX converters
# (convert_sapiens, convert_inception_torch, convert_i3d, convert_syncc)


def _put_bn(sd: StateDict, name: str, p: Mapping[str, Any],
            keys=("w", "b", "mean", "var")) -> None:
    for k, field in zip(keys, ("weight", "bias", "running_mean",
                               "running_var")):
        sd[f"{name}.{field}"] = _t(p[k])


def sapiens_state_dict_from_jax(params: Mapping[str, Any], cfg) -> StateDict:
    """JAX Sapiens params (init_sapiens / convert_sapiens) -> the released
    sapiens-pose names (`omni/sapiens.py:SapiensModel`). The JAX deconv
    kernels are pre-flipped [4, 4, Cin, Cout]; torch's ConvTranspose2d
    holds [Cin, Cout, 4, 4] unflipped."""
    pe = params["patch_embed"]
    sd: StateDict = {
        "backbone.patch_embed.projection.weight":
            _t(np.asarray(pe["w"]).transpose(3, 2, 0, 1)),
        "backbone.patch_embed.projection.bias": _t(pe["b"]),
        "backbone.pos_embed": _t(params["pos_embed"]),
    }
    _put_norm(sd, "backbone.ln1", params["final_norm"])
    bl = params["blocks"]
    for i in range(cfg.depth):
        base = f"backbone.layers.{i}"
        for norm in ("ln1", "ln2"):
            sd[f"{base}.{norm}.weight"] = _t(np.asarray(bl[norm]["w"])[i])
            sd[f"{base}.{norm}.bias"] = _t(np.asarray(bl[norm]["b"])[i])
        for ours, theirs in (("qkv", "attn.qkv"), ("proj", "attn.proj"),
                             ("fc1", "ffn.layers.0.0"),
                             ("fc2", "ffn.layers.1")):
            _put_linear(sd, f"{base}.{theirs}", bl[ours], i)
    head = params["head"]
    for i, dp in enumerate(head["deconvs"]):
        w = np.asarray(dp["w"]).transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
        sd[f"head.deconv_layers.{3 * i}.weight"] = _t(w)
        _put_bn(sd, f"head.deconv_layers.{3 * i + 1}", dp["bn"])
    for i, cp in enumerate(head["convs"]):
        sd[f"head.conv_layers.{3 * i}.weight"] = _t(
            np.asarray(cp["w"]).transpose(3, 2, 0, 1))
        _put_bn(sd, f"head.conv_layers.{3 * i + 1}", cp["bn"])
    _put_conv2d(sd, "head.final_layer", head["final"])
    return sd


_INCEPTION_BRANCHES = {
    "a": ("b1x1", "b5x5_1", "b5x5_2", "b3x3dbl_1", "b3x3dbl_2", "b3x3dbl_3",
          "bpool"),
    "b": ("b3x3", "b3x3dbl_1", "b3x3dbl_2", "b3x3dbl_3"),
    "c": ("b1x1", "b7x7_1", "b7x7_2", "b7x7_3", "b7x7dbl_1", "b7x7dbl_2",
          "b7x7dbl_3", "b7x7dbl_4", "b7x7dbl_5", "bpool"),
    "d": ("b3x3_1", "b3x3_2", "b7x7x3_1", "b7x7x3_2", "b7x7x3_3",
          "b7x7x3_4"),
    "e": ("b1x1", "b3x3_1", "b3x3_2a", "b3x3_2b", "b3x3dbl_1", "b3x3dbl_2",
          "b3x3dbl_3a", "b3x3dbl_3b", "bpool"),
}
_INCEPTION_BLOCKS = (("Mixed_5b", "a"), ("Mixed_5c", "a"), ("Mixed_5d", "a"),
                     ("Mixed_6a", "b"), ("Mixed_6b", "c"), ("Mixed_6c", "c"),
                     ("Mixed_6d", "c"), ("Mixed_6e", "c"), ("Mixed_7a", "d"),
                     ("Mixed_7b", "e"), ("Mixed_7c", "e"))


def inception_state_dict_from_jax(params: Mapping[str, Any]) -> StateDict:
    """JAX InceptionV3 params (init_inception / convert_inception_torch)
    -> torchvision names (`omni/inception.py:InceptionV3`)."""
    sd: StateDict = {}

    def conv(name, p):
        sd[f"{name}.conv.weight"] = _t(np.asarray(p["w"]).transpose(
            3, 2, 0, 1))
        _put_bn(sd, f"{name}.bn", p,
                ("bn_scale", "bn_bias", "bn_mean", "bn_var"))

    for stem in ("Conv2d_1a_3x3", "Conv2d_2a_3x3", "Conv2d_2b_3x3",
                 "Conv2d_3b_1x1", "Conv2d_4a_3x3"):
        conv(stem, params[stem])
    for block, kind in _INCEPTION_BLOCKS:
        for ours in _INCEPTION_BRANCHES[kind]:
            theirs = "branch_pool" if ours == "bpool" else \
                "branch" + ours[1:]
            conv(f"{block}.{theirs}", params[block][ours])
    _put_linear(sd, "fc", params["fc"])
    return sd


def i3d_state_dict_from_jax(params: Mapping[str, Any], cfg=None
                            ) -> StateDict:
    """JAX I3D params (init_i3d / convert_i3d) -> piergiaj/pytorch-i3d names
    (`omni/i3d.py:InceptionI3d`): `<unit>.conv3d.weight` [O, I, kT, kH,
    kW], `<unit>.bn.*`, `logits.conv3d.bias`."""
    from omnihuman_tpu_torch.omni.i3d import MIXED
    sd: StateDict = {}

    def unit(name, p):
        sd[f"{name}.conv3d.weight"] = _t(np.asarray(p["w"]).transpose(
            4, 3, 0, 1, 2))
        if "b" in p:
            sd[f"{name}.conv3d.bias"] = _t(p["b"])
        if "bn" in p:
            _put_bn(sd, f"{name}.bn", p["bn"], ("g", "b", "m", "v"))

    for name in ("Conv3d_1a_7x7", "Conv3d_2b_1x1", "Conv3d_2c_3x3",
                 "logits"):
        unit(name, params[name])
    for name, _ in MIXED:
        for b in ("b0", "b1a", "b1b", "b2a", "b2b", "b3b"):
            unit(f"{name}.{b}", params[name][b])
    return sd


def syncc_state_dict_from_jax(params: Mapping[str, Any], cfg) -> StateDict:
    """JAX Sync-C params (init_syncc / convert_syncc) -> the two-tower
    torch names (`omni/syncc.py:SyncCModel`)."""
    sd: StateDict = {}
    for name in ("audio_fc1", "audio_fc2", "visual_fc"):
        _put_linear(sd, name, params[name])
    for i in range(len(cfg.visual_channels)):
        _put_conv3d(sd, f"visual_conv{i}", params[f"visual_conv{i}"])
    return sd
