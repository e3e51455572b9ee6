"""The port's CLIP visual tower against JAX at TINY_CLIP
(tests/test_clip_i2v.py), fp32: `clip_visual_forward` (all tokens with
use_31_block, and the pooled head), `preprocess_images` (bicubic resize +
CLIP normalisation), and `CLIPModel.visual`; the port's state dict back
through JAX `convert_clip`.

Tolerances: tokens and pooled output 1e-5 (fp32, other summation order);
preprocessing 1e-4 (an antialiased bicubic resize in each package, from
a 40x32 image down to 28x28 and up from 20x24)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnihuman_tpu.configs.wan import CLIPConfig as JaxCLIPConfig
from omnihuman_tpu.models import clip as jax_clip
from omnihuman_tpu.utils.convert import convert_clip
from omnihuman_tpu_torch.configs.wan import CLIPConfig
from omnihuman_tpu_torch.models import clip as port_clip
from omnihuman_tpu_torch.utils.convert import clip_visual_state_dict_from_jax

torch.set_num_threads(1)

TINY = dict(embed_dim=16, image_size=28, patch_size=14, vision_dim=24,
            vision_heads=4, vision_layers=3, vocab_size=64, text_dim=16,
            text_heads=4, text_layers=2, max_text_len=20)
JAX_TINY_CLIP = JaxCLIPConfig(**TINY)
TINY_CLIP = CLIPConfig(**TINY)


@pytest.fixture(scope="module")
def clip_pair():
    params = jax.tree.map(np.asarray,
                          jax_clip.init_clip(jax.random.key(0), JAX_TINY_CLIP))
    rng = np.random.default_rng(1)   # non-trivial norms and biases
    vb = params["visual"]["blocks"]
    for k in ("norm1", "norm2"):
        vb[k]["w"] = (1 + 0.1 * rng.normal(size=vb[k]["w"].shape)
                      ).astype(np.float32)
        vb[k]["b"] = (0.1 * rng.normal(size=vb[k]["b"].shape)
                      ).astype(np.float32)
    for k in ("qkv", "proj", "fc1", "fc2"):
        vb[k]["b"] = (0.1 * rng.normal(size=vb[k]["b"].shape)
                      ).astype(np.float32)
    model = port_clip.build_clip(TINY_CLIP, "cpu", seed=None)
    model.load_state_dict(clip_visual_state_dict_from_jax(params, TINY_CLIP))
    return params, model


@pytest.mark.parametrize("use_31_block", [True, False])
def test_clip_visual_matches_jax(clip_pair, use_31_block):
    params, model = clip_pair
    x = np.random.default_rng(0).normal(size=(2, 3, 28, 28)
                                        ).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, x: jax_clip.clip_visual_forward(
        p, x, JAX_TINY_CLIP, use_31_block=use_31_block))(params, x))
    got = port_clip.clip_visual_forward(model, torch.from_numpy(x),
                                        use_31_block=use_31_block)
    assert got.shape == ((2, 5, 24) if use_31_block else (2, 16))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("hw", [(40, 32), (20, 24), (28, 28)])
def test_preprocess_images_matches_jax(hw):
    img = np.random.default_rng(2).uniform(-1, 1, size=(1, 3) + hw
                                           ).astype(np.float32)
    want = np.asarray(jax_clip.preprocess_images(img, 28))
    got = port_clip.preprocess_images(img, 28)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


def test_clip_model_visual_matches_jax(clip_pair):
    params, model = clip_pair
    img = np.random.default_rng(3).uniform(-1, 1, size=(1, 3, 64, 48)
                                           ).astype(np.float32)
    jm = jax_clip.CLIPModel(JAX_TINY_CLIP, params=params)
    want = np.asarray(jax.jit(jm.visual)(jnp.asarray(img)))
    pm = port_clip.CLIPModel(TINY_CLIP, "cpu", seed=None)
    pm.model = model
    got = pm.visual(img)
    assert got.shape == (1, 5, 24)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


def test_clip_state_dict_round_trips_through_jax_converter(clip_pair):
    params, model = clip_pair
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    back = convert_clip(_with_textual(sd, params), JAX_TINY_CLIP)["visual"]
    flat_a = jax.tree_util.tree_leaves_with_path(params["visual"])
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), leaf)


def test_clip_file_loads_like_jax_convert_clip(clip_pair, tmp_path):
    """A TINY CLIP state dict in the reference names (visual and XLM-R
    towers, log_scale) as a file: `CLIPModel(checkpoint_path=)` (what
    `WanI2V(checkpoint_dir=)` builds where the directory holds the file)
    and JAX's `convert_clip` -> `clip_visual_forward` give the same
    visual tokens and pooled features (fp32, atol 1e-5)."""
    params, model = clip_pair
    sd = _with_textual({k: v.numpy() for k, v in model.state_dict().items()},
                       params)
    sd["log_scale"] = np.float32(4.6)
    path = str(tmp_path / "clip.pth")
    torch.save({k: torch.as_tensor(np.array(v)) for k, v in sd.items()},
               path)
    pm = port_clip.CLIPModel(TINY_CLIP, "cpu", seed=99, checkpoint_path=path)
    jp = convert_clip({k: v.numpy() for k, v in torch.load(path).items()},
                      JAX_TINY_CLIP)
    x = np.random.default_rng(4).normal(size=(2, 3, 28, 28)
                                        ).astype(np.float32)
    for use_31_block in (True, False):
        want = np.asarray(jax_clip.clip_visual_forward(
            jp, x, JAX_TINY_CLIP, use_31_block=use_31_block))
        got = port_clip.clip_visual_forward(pm.model, torch.from_numpy(x),
                                            use_31_block=use_31_block)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def _with_textual(sd, params):
    """convert_clip also reads the XLM-R tower the port does not carry:
    hand it zeros of the right shapes."""
    sd = dict(sd)
    tp, cfg = params["textual"], JAX_TINY_CLIP
    d, f = cfg.text_dim, 4 * cfg.text_dim
    sd["textual.token_embedding.weight"] = tp["token_embedding"]
    sd["textual.type_embedding.weight"] = tp["type_embedding"]
    sd["textual.pos_embedding.weight"] = tp["pos_embedding"]
    for n in ("weight", "bias"):
        sd[f"textual.norm.{n}"] = np.zeros(d, np.float32)
    for i in range(cfg.text_layers):
        b = f"textual.blocks.{i}"
        for lin, (o, n_in) in {"attn.q": (d, d), "attn.k": (d, d),
                               "attn.v": (d, d), "attn.o": (d, d),
                               "ffn.0": (f, d), "ffn.2": (d, f)}.items():
            sd[f"{b}.{lin}.weight"] = np.zeros((o, n_in), np.float32)
            sd[f"{b}.{lin}.bias"] = np.zeros(o, np.float32)
        for norm in ("norm1", "norm2"):
            for n in ("weight", "bias"):
                sd[f"{b}.{norm}.{n}"] = np.zeros(d, np.float32)
    mid = (d + cfg.embed_dim) // 2
    sd["textual.head.0.weight"] = np.zeros((mid, d), np.float32)
    sd["textual.head.2.weight"] = np.zeros((cfg.embed_dim, mid), np.float32)
    return sd


def test_tiny_config_fields_match():
    assert dataclasses.asdict(TINY_CLIP) == dataclasses.asdict(JAX_TINY_CLIP)
