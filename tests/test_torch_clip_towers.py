"""CLIP's visual and text towers and the reference CLIP file against the
JAX package: the slow cases of tests/test_torch_clip.py (whose helpers
they use), in a file of their own so that a `--dist loadfile` run
schedules them with the files of few tests, beside the longest ones,
instead of before them."""

import jax
import numpy as np
import pytest
import torch

from omnihuman_tpu.models import clip as jax_clip
from omnihuman_tpu.utils.convert import convert_clip
from omnihuman_tpu_torch.models import clip as port_clip
# fixtures and helpers of the file these cases came from
from test_torch_clip import (
    _with_textual, clip_pair, JAX_TINY_CLIP, text_pair, TINY_CLIP)


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


def test_clip_textual_matches_jax_on_padded_ids(text_pair):
    params, model = text_pair
    rng = np.random.default_rng(6)
    ids = rng.integers(2, 64, size=(3, 12)).astype(np.int32)
    ids[1, 7:] = 1                       # pad_id 1: right padding
    ids[2, 3:] = 1
    want = np.asarray(jax.jit(lambda p, i: jax_clip.clip_textual_forward(
        p, i, JAX_TINY_CLIP))(params, ids))
    got = port_clip.clip_textual_forward(model, torch.from_numpy(ids).long())
    assert got.shape == (3, 16)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    # padding beyond a row's length changes nothing
    wider = np.concatenate([ids, np.ones((3, 4), np.int32)], axis=1)
    got2 = port_clip.clip_textual_forward(model,
                                          torch.from_numpy(wider).long())
    np.testing.assert_allclose(got2.numpy(), got.numpy(), atol=1e-5)
