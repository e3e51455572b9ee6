"""Frozen dataclass configs for the Wan 2.1 model family (PyTorch port).

Field-for-field copy of omnihuman_tpu/configs/wan.py with torch dtypes in
the DTypePolicy; the values follow the reference Wan configs
(shared_config.py, wan_t2v_1_3B.py, wan_t2v_14B.py, wan_i2v_14B.py,
wan_t2v_1_3B_small.py).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class DTypePolicy:
    """Explicit mixed-precision policy: parameters are stored in `params`,
    matmul-heavy compute runs in `compute`, AdaLN / time / modulation /
    gates and norm statistics in `highprec`, and the DiT residual stream
    between blocks is kept in `residual`."""

    params: torch.dtype = torch.float32
    compute: torch.dtype = torch.bfloat16
    highprec: torch.dtype = torch.float32
    residual: torch.dtype = torch.float32


@dataclasses.dataclass(frozen=True)
class WanModelConfig:
    """DiT denoiser (reference wan/modules/model.py:377-434)."""

    model_type: str = "t2v"  # 't2v' | 'i2v'
    patch_size: Tuple[int, int, int] = (1, 2, 2)
    text_len: int = 512
    in_dim: int = 16
    dim: int = 1536
    ffn_dim: int = 8960
    freq_dim: int = 256
    text_dim: int = 4096
    out_dim: int = 16
    num_heads: int = 12
    num_layers: int = 30
    window_size: Tuple[int, int] = (-1, -1)
    qk_norm: bool = True
    cross_attn_norm: bool = True
    eps: float = 1e-6
    clip_embed_dim: int = 1280
    clip_tokens: int = 257

    @property
    def head_dim(self) -> int:
        return self.dim // self.num_heads


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    """3D causal video VAE (reference wan/modules/vae.py:592-645)."""

    base_dim: int = 96
    z_dim: int = 16
    dim_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    attn_scales: Tuple[float, ...] = ()
    temporal_downsample: Tuple[bool, ...] = (False, True, True)
    dropout: float = 0.0
    cache_t: int = 2

    latent_mean: Tuple[float, ...] = (
        -0.7571, -0.7089, -0.9113, 0.1075, -0.1745, 0.9653, -0.1517, 1.5508,
        0.4134, -0.0715, 0.5517, -0.3632, -0.1922, -0.9497, 0.2503, -0.2921,
    )
    latent_std: Tuple[float, ...] = (
        2.8184, 1.4541, 2.3275, 2.6558, 1.2196, 1.7708, 2.6052, 2.0743,
        3.2687, 2.1526, 2.8652, 1.5579, 1.6382, 1.1253, 2.8251, 1.9160,
    )


@dataclasses.dataclass(frozen=True)
class T5Config:
    """umT5 encoder (reference wan/modules/t5.py:465-478 `umt5_xxl`)."""

    vocab_size: int = 256384
    dim: int = 4096
    dim_attn: int = 4096
    dim_ffn: int = 10240
    num_heads: int = 64
    num_layers: int = 24
    num_buckets: int = 32
    max_dist: int = 128
    dropout: float = 0.0
    shared_pos: bool = False


UMT5_XXL = T5Config()
UMT5_SMALL = T5Config(
    vocab_size=256384, dim=512, dim_attn=384, dim_ffn=1024,
    num_heads=6, num_layers=8,
)


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    """XLM-RoBERTa-CLIP ViT-H/14 (reference wan/modules/clip.py:471-499).
    The visual tower is ported (models/clip.py); the text-tower fields are
    carried for the registry."""

    embed_dim: int = 1024
    image_size: int = 224
    patch_size: int = 14
    vision_dim: int = 1280
    vision_mlp_ratio: float = 4.0
    vision_heads: int = 16
    vision_layers: int = 32
    vision_pool: str = "token"
    activation: str = "gelu"
    vocab_size: int = 250002
    text_dim: int = 1024
    text_heads: int = 16
    text_layers: int = 24
    max_text_len: int = 514
    type_size: int = 1
    pad_id: int = 1
    use_31_block: bool = True


@dataclasses.dataclass(frozen=True)
class WanConfig:
    """One named entry of the model registry."""

    name: str
    model: WanModelConfig
    vae: VAEConfig
    t5: T5Config
    clip: Optional[CLIPConfig] = None
    policy: DTypePolicy = DTypePolicy()

    t5_tokenizer: str = "google/umt5-xxl"
    text_len: int = 512
    num_train_timesteps: int = 1000
    sample_fps: int = 16
    sample_neg_prompt: str = (
        "色调艳丽，过曝，静态，细节模糊不清，字幕，风格，作品，画作，画面，静止，"
        "整体发灰，最差质量，低质量，JPEG压缩残留，丑陋的，残缺的，多余的手指，"
        "画得不好的手部，画得不好的脸部，畸形的，毁容的，形态畸形的肢体，手指融合，"
        "静止不动的画面，杂乱的背景，三条腿，背景人很多，倒着走"
    )
    sample_steps: int = 50
    sample_shift: float = 5.0
    sample_guide_scale: float = 5.0
    frame_num: int = 81
    vae_stride: Tuple[int, int, int] = (4, 8, 8)


_MODEL_1_3B = WanModelConfig(
    model_type="t2v", dim=1536, ffn_dim=8960, num_heads=12, num_layers=30,
)
_MODEL_14B = WanModelConfig(
    model_type="t2v", dim=5120, ffn_dim=13824, num_heads=40, num_layers=40,
)
_MODEL_I2V_14B = WanModelConfig(
    model_type="i2v", dim=5120, ffn_dim=13824, num_heads=40, num_layers=40,
    in_dim=36,
)

T2V_1_3B = WanConfig(name="t2v-1.3B", model=_MODEL_1_3B, vae=VAEConfig(),
                     t5=UMT5_XXL)
T2V_1_3B_SMALL = WanConfig(
    name="t2v-1.3B-small",
    model=dataclasses.replace(_MODEL_1_3B, text_dim=UMT5_SMALL.dim),
    vae=VAEConfig(),
    t5=UMT5_SMALL,
    t5_tokenizer="google/umt5-small",
)
T2V_14B = WanConfig(name="t2v-14B", model=_MODEL_14B, vae=VAEConfig(),
                    t5=UMT5_XXL)
T2I_14B = WanConfig(name="t2i-14B", model=_MODEL_14B, vae=VAEConfig(),
                    t5=UMT5_XXL, frame_num=1)
I2V_14B = WanConfig(
    name="i2v-14B", model=_MODEL_I2V_14B, vae=VAEConfig(), t5=UMT5_XXL,
    clip=CLIPConfig(), sample_steps=40,
)

# tiny config for unit tests / CI — not part of the reference registry
TINY_TEST = WanConfig(
    name="tiny-test",
    model=WanModelConfig(
        model_type="t2v", dim=64, ffn_dim=128, num_heads=4, num_layers=2,
        freq_dim=32, text_dim=32, text_len=16,
    ),
    vae=VAEConfig(base_dim=8, z_dim=16, dim_mult=(1, 1, 1, 1),
                  num_res_blocks=1,
                  temporal_downsample=(False, True, True)),
    t5=T5Config(vocab_size=128, dim=32, dim_attn=32, dim_ffn=64,
                num_heads=4, num_layers=2),
    text_len=16,
)

# test-only DiT with the real head_dim 128 (the kernel's head_dim), at a
# width that runs in the CPU test suite
TINY_TEST_HD128 = dataclasses.replace(
    TINY_TEST, name="tiny-test-hd128",
    model=WanModelConfig(
        model_type="t2v", dim=256, ffn_dim=512, num_heads=2, num_layers=2,
        freq_dim=32, text_dim=32, text_len=16,
    ),
)
