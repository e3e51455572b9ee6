"""Sapiens pose backbone (port of omnihuman_tpu/omni/sapiens.py).

A plain ViT (patch 16, no cls token, final LayerNorm) with an
mmpose-style heatmap head (2 x ConvTranspose2d(4, 2, 1) + BN + ReLU, 2 x
conv 1x1 + BN + ReLU, a final 1x1 conv to the keypoints), as an
`nn.Module` under the released sapiens-pose names
(`backbone.patch_embed.projection`, `backbone.layers.N.attn.qkv`,
`backbone.layers.N.ffn.layers.0.0`, `backbone.ln1`,
`head.deconv_layers.{3i,3i+1}`, `head.conv_layers.{3i,3i+1}`,
`head.final_layer`), so a released state dict loads as it is. The JAX
converter flips the deconv kernels for its lhs-dilated conv; here they
are ConvTranspose2d weights as the file holds them.

The reference (Omnihuman/keypoint_processor.py:43-66) runs a TorchScript
export at 1024x768; `SapiensBackbone` is the counterpart of JAX's
`JaxSapiensBackbone`: a crop [H, W, 3] uint8 (numpy or a tensor) ->
heatmaps [K, h, w] float32 on its device, `batch` on [B, H, W, 3]. It
reads a state-dict file or a TorchScript file's state dict, sizing the
model from the file, or is random from a seed. Attention is dense (SDPA);
the JAX package leaves it to XLA, so no hand kernel is involved. fp32 by
default; on the card cuDNN may run the convolutions in TF32, as PyTorch
allows by default.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

# normalization of the reference transform (keypoint_processor.py:46-49)
SAPIENS_MEAN = (123.5, 116.5, 103.5)
SAPIENS_STD = (58.5, 57.0, 57.5)


@dataclass(frozen=True)
class SapiensConfig:
    img_size: Tuple[int, int] = (1024, 768)     # (H, W) model input
    patch_size: int = 16
    embed_dim: int = 1536
    depth: int = 40
    num_heads: int = 24
    mlp_ratio: float = 4.0
    num_keypoints: int = 308
    deconv_channels: Tuple[int, ...] = (768, 768)
    conv_channels: Tuple[int, ...] = (768, 768)
    ln_eps: float = 1e-6

    @property
    def grid(self) -> Tuple[int, int]:
        return (self.img_size[0] // self.patch_size,
                self.img_size[1] // self.patch_size)

    @property
    def heatmap_size(self) -> Tuple[int, int]:
        """(H, W) of the head output: the grid upsampled 2x per deconv."""
        s = 2 ** len(self.deconv_channels)
        return (self.grid[0] * s, self.grid[1] * s)


# released sapiens-pose sizes (embed_dim, depth, num_heads)
SAPIENS_PRESETS = {
    "0.3b": SapiensConfig(embed_dim=1024, depth=24, num_heads=16),
    "0.6b": SapiensConfig(embed_dim=1280, depth=32, num_heads=16),
    "1b": SapiensConfig(embed_dim=1536, depth=40, num_heads=24),
    "2b": SapiensConfig(embed_dim=1920, depth=48, num_heads=32),
    "tiny-test": SapiensConfig(img_size=(64, 48), embed_dim=32, depth=2,
                               num_heads=2, num_keypoints=7,
                               deconv_channels=(16, 16),
                               conv_channels=(16, 16)),
}


class PatchEmbed(nn.Module):
    def __init__(self, cfg: SapiensConfig):
        super().__init__()
        self.projection = nn.Conv2d(3, cfg.embed_dim, cfg.patch_size,
                                    stride=cfg.patch_size)


class Attention(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)


class FFN(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.layers = nn.Sequential(
            nn.Sequential(nn.Linear(dim, hidden), nn.GELU()),
            nn.Linear(hidden, dim))


class TransformerLayer(nn.Module):
    def __init__(self, cfg: SapiensConfig):
        super().__init__()
        d = cfg.embed_dim
        self.ln1 = nn.LayerNorm(d, eps=cfg.ln_eps)
        self.attn = Attention(d)
        self.ln2 = nn.LayerNorm(d, eps=cfg.ln_eps)
        self.ffn = FFN(d, int(d * cfg.mlp_ratio))


class SapiensViT(nn.Module):
    def __init__(self, cfg: SapiensConfig):
        super().__init__()
        gh, gw = cfg.grid
        self.patch_embed = PatchEmbed(cfg)
        self.pos_embed = nn.Parameter(torch.zeros(1, gh * gw, cfg.embed_dim))
        self.layers = nn.ModuleList(
            [TransformerLayer(cfg) for _ in range(cfg.depth)])
        self.ln1 = nn.LayerNorm(cfg.embed_dim, eps=cfg.ln_eps)


class HeatmapHead(nn.Module):
    def __init__(self, cfg: SapiensConfig):
        super().__init__()
        layers, cin = [], cfg.embed_dim
        for c in cfg.deconv_channels:
            layers += [nn.ConvTranspose2d(cin, c, 4, stride=2, padding=1,
                                          bias=False),
                       nn.BatchNorm2d(c), nn.ReLU()]
            cin = c
        self.deconv_layers = nn.Sequential(*layers)
        layers = []
        for c in cfg.conv_channels:
            layers += [nn.Conv2d(cin, c, 1, bias=False), nn.BatchNorm2d(c),
                       nn.ReLU()]
            cin = c
        self.conv_layers = nn.Sequential(*layers)
        self.final_layer = nn.Conv2d(cin, cfg.num_keypoints, 1)


class SapiensModel(nn.Module):
    """The released TopdownPoseEstimator's module tree (backbone + head)."""

    def __init__(self, cfg: SapiensConfig):
        super().__init__()
        self.cfg = cfg
        self.backbone = SapiensViT(cfg)
        self.head = HeatmapHead(cfg)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """JAX init_sapiens's rule: linears U(+-1/sqrt(fan_in)) with such
        biases, convs U(+-1/sqrt(fan_in)) with zero biases, positions
        N(0, 0.02), unit norms and BN statistics."""
        def uni(t, fan_in):
            lim = 1.0 / math.sqrt(fan_in)
            t.uniform_(-lim, lim, generator=generator)

        for m in self.modules():
            if isinstance(m, nn.Linear):
                uni(m.weight, m.in_features)
                uni(m.bias, m.in_features)
            elif isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                w = m.weight
                cin = w.shape[0] if isinstance(m, nn.ConvTranspose2d) \
                    else w.shape[1]
                uni(w, cin * w.shape[2] * w.shape[3])
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, (nn.LayerNorm, nn.BatchNorm2d)):
                m.weight.fill_(1.0)
                m.bias.zero_()
                if isinstance(m, nn.BatchNorm2d):
                    m.running_mean.zero_()
                    m.running_var.fill_(1.0)
        self.backbone.pos_embed.normal_(0.0, 0.02, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return sapiens_forward(self, x)


def _block(layer: TransformerLayer, x: torch.Tensor,
           cfg: SapiensConfig) -> torch.Tensor:
    b, s, d = x.shape
    n = cfg.num_heads
    y = F.layer_norm(x, (d,), layer.ln1.weight, layer.ln1.bias, cfg.ln_eps)
    q, k, v = (t.reshape(b, s, n, d // n).transpose(1, 2) for t in
               F.linear(y, layer.attn.qkv.weight,
                        layer.attn.qkv.bias).chunk(3, dim=-1))
    y = F.scaled_dot_product_attention(q, k, v)          # dense softmax
    y = y.transpose(1, 2).reshape(b, s, d)
    x = x + F.linear(y, layer.attn.proj.weight, layer.attn.proj.bias)
    y = F.layer_norm(x, (d,), layer.ln2.weight, layer.ln2.bias, cfg.ln_eps)
    return x + layer.ffn.layers(y)


def sapiens_forward(model: SapiensModel, x: torch.Tensor) -> torch.Tensor:
    """[B, H, W, 3] (normalized) -> [B, K, Hm, Wm] heatmaps (JAX
    sapiens_forward)."""
    cfg, vit = model.cfg, model.backbone
    w = vit.patch_embed.projection.weight
    x = vit.patch_embed.projection(x.permute(0, 3, 1, 2).to(w.dtype))
    b, d, gh, gw = x.shape
    x = x.flatten(2).transpose(1, 2) + vit.pos_embed    # [B, N, D]
    for layer in vit.layers:
        x = _block(layer, x, cfg)
    x = vit.ln1(x)
    y = x.transpose(1, 2).reshape(b, d, gh, gw)
    y = model.head.deconv_layers(y)
    y = model.head.conv_layers(y)
    return model.head.final_layer(y)


def build_sapiens(cfg: SapiensConfig, device,
                  dtype: torch.dtype = torch.float32,
                  seed: Optional[int] = 0) -> SapiensModel:
    """A SapiensModel on `device` in eval mode, random from `seed` (left
    uninitialised where `seed` is None, for a state dict to fill)."""
    with torch.device("meta"):
        model = SapiensModel(cfg)
    model = model.to_empty(device=device)
    if seed is not None:
        model.init_weights(torch.Generator(device=device).manual_seed(seed))
    return model.to(dtype).eval().requires_grad_(False)


# ---------------------------------------------------------------------------
# checkpoints


def _shape(t) -> Tuple[int, ...]:
    return tuple(t.shape)


def infer_sapiens_config(state_dict) -> SapiensConfig:
    """(embed_dim, depth, num_heads, head channels, keypoints, input size)
    of a checkpoint (JAX infer_sapiens_config). The head count is not in
    the shapes: it comes from the released preset of that width, else
    width / 64. The grid is read from pos_embed at the standard 4:3."""
    sd = state_dict
    d = _shape(sd["backbone.ln1.weight"])[0]
    depth = 1 + max(int(k.split(".")[2]) for k in sd
                    if k.startswith("backbone.layers."))
    kps = _shape(sd["head.final_layer.weight"])[0]
    deconvs = sorted(int(k.split(".")[2]) // 3 for k in sd
                     if k.startswith("head.deconv_layers.")
                     and k.endswith(".running_mean"))
    convs = sorted(int(k.split(".")[2]) // 3 for k in sd
                   if k.startswith("head.conv_layers.")
                   and k.endswith(".running_mean"))
    dch = tuple(_shape(sd[f"head.deconv_layers.{3 * i + 1}.weight"])[0]
                for i in deconvs)
    cch = tuple(_shape(sd[f"head.conv_layers.{3 * i + 1}.weight"])[0]
                for i in convs)
    heads = next((c.num_heads for c in SAPIENS_PRESETS.values()
                  if c.embed_dim == d), max(1, d // 64))
    n_tok = _shape(sd["backbone.pos_embed"])[1]
    base = SAPIENS_PRESETS["1b"]
    img = base.img_size
    gh = int(round((n_tok * 4 // 3) ** 0.5))
    if gh * (gh * 3 // 4) in (n_tok, n_tok - 1):
        img = (gh * base.patch_size, (gh * 3 // 4) * base.patch_size)
    return SapiensConfig(img_size=img, embed_dim=d, depth=depth,
                         num_heads=heads, num_keypoints=kps,
                         deconv_channels=dch, conv_channels=cch)


def load_sapiens_state_dict(model: SapiensModel, state_dict) -> None:
    """Load a released state dict into `model` by its names (JAX
    convert_sapiens reads the same ones): a cls token's position is
    dropped from pos_embed; other extra entries are ignored; a missing
    one raises KeyError naming it."""
    from omnihuman_tpu_torch.utils.convert import load_named
    sd = dict(state_dict)
    pos = sd["backbone.pos_embed"]
    n_tok = model.cfg.grid[0] * model.cfg.grid[1]
    if pos.shape[1] == n_tok + 1:                        # a cls slot
        sd["backbone.pos_embed"] = pos[:, 1:]
    elif pos.shape[1] != n_tok:
        raise ValueError(f"pos_embed has {pos.shape[1]} tokens, the config's"
                         f" grid wants {n_tok}")
    load_named(model, sd, "sapiens state dict")


def load_sapiens_file(path: str):
    """The state dict of a Sapiens file: a TorchScript export (its
    state_dict()) or a torch.save'd state dict (a {"state_dict": ...}
    wrapper unwrapped), on the host."""
    try:
        return torch.jit.load(path, map_location="cpu").state_dict()
    except RuntimeError:
        sd = torch.load(path, map_location="cpu", weights_only=True,
                        mmap=True)
        return sd.get("state_dict", sd)


# ---------------------------------------------------------------------------
# pipeline adapter


class SapiensBackbone:
    """Crop [H, W, 3] uint8 -> [K, h, w] heatmaps with the reference's
    normalization (keypoint_processor.py:43-49), on `device` (the GPU
    unless the caller asks for the CPU). Weights: `model`, else the file
    at `checkpoint_path` (a state dict or a TorchScript export, sized from
    the file unless `cfg` is given), else random from `seed` at `preset`."""

    def __init__(self, checkpoint_path: Optional[str] = None,
                 preset: str = "1b", cfg: Optional[SapiensConfig] = None,
                 model: Optional[SapiensModel] = None,
                 dtype: torch.dtype = torch.float32, device=None,
                 seed: int = 0):
        from omnihuman_tpu_torch.pipelines.text2video import resolve_device
        from omnihuman_tpu_torch.utils.logging import logger
        self.device = resolve_device(device)
        if model is not None:
            self.model = model.to(self.device, dtype)
        elif checkpoint_path:
            sd = load_sapiens_file(checkpoint_path)
            cfg = cfg or infer_sapiens_config(sd)
            self.model = build_sapiens(cfg, self.device, dtype, seed=None)
            load_sapiens_state_dict(self.model, sd)
        else:
            logger.warning("SapiensBackbone: random init (no checkpoint): "
                           "heatmaps are structural only")
            self.model = build_sapiens(cfg or SAPIENS_PRESETS[preset],
                                       self.device, dtype, seed=seed)
        self.cfg = self.model.cfg
        self.dtype = dtype
        self._mean = torch.tensor(SAPIENS_MEAN, device=self.device)
        self._std = torch.tensor(SAPIENS_STD, device=self.device)

    def normalize(self, crops) -> torch.Tensor:
        x = torch.as_tensor(crops, device=self.device).float()
        return (x - self._mean) / self._std

    @torch.inference_mode()
    def __call__(self, crop) -> torch.Tensor:
        return self.batch(torch.as_tensor(crop)[None])[0]

    @torch.inference_mode()
    def batch(self, crops) -> torch.Tensor:
        """[B, H, W, 3] uint8 -> [B, K, h, w] float32 in one forward."""
        x = self.normalize(crops).to(self.dtype)
        return sapiens_forward(self.model, x).float()
