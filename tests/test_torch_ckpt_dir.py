"""Wan checkpoint directories in the port's pipelines and CLI against the
JAX package at TINY_TEST on the CPU: `WanT2V(checkpoint_dir=)` (the DiT
from `*.safetensors`, `Wan2.1_VAE.pth`, the umT5 file where present),
`WanI2V(checkpoint_dir=)`, and `cli.generate --ckpt_dir` for t2v and
`--one_step`.

The parameters both packages load are equal after the cast to the
parameter dtype (bf16 by default; both round to nearest even). One
generation with the same noise and context through both packages'
`sample()` and VAE decode, on fp32 loads: atol 1e-3, the tolerance of
tests/test_torch_pipeline.py (3 UniPC steps, guidance 5 amplifies small
per-step differences)."""

import dataclasses
import os
import shutil

import jax
import numpy as np
import pytest
import torch
from safetensors.torch import save_file

from omnihuman_tpu.configs.wan import TINY_TEST as JAX_TINY
from omnihuman_tpu.pipelines.text2video import WanT2V as JaxWanT2V
from omnihuman_tpu_torch.configs.wan import TINY_TEST, CLIPConfig
from omnihuman_tpu_torch.models.clip import (
    CLIP_CHECKPOINT, CLIPModel, build_clip)
from omnihuman_tpu_torch.models.t5 import T5_CHECKPOINT, build_t5_encoder
from omnihuman_tpu_torch.models.vae import build_vae
from omnihuman_tpu_torch.models.wan_dit import build_wan_model
from omnihuman_tpu_torch.pipelines import text2video as t2v
# imported before WanT2V is patched, so that it binds the real class
from omnihuman_tpu_torch.pipelines.image2video import WanI2V
from omnihuman_tpu_torch.pipelines.text2video import WanT2V
from omnihuman_tpu_torch.utils.checkpoint import CheckpointManager
from omnihuman_tpu_torch.utils.convert import load_torch_state_dict

torch.set_num_threads(1)

TINY_I2V = dataclasses.replace(
    TINY_TEST, name="tiny-i2v",
    model=dataclasses.replace(TINY_TEST.model, model_type="i2v", in_dim=36,
                              clip_embed_dim=24, clip_tokens=5),
    clip=CLIPConfig(embed_dim=16, image_size=28, patch_size=14,
                    vision_dim=24, vision_heads=4, vision_layers=3,
                    vocab_size=64, text_dim=16, text_heads=4, text_layers=2,
                    max_text_len=20))


def _write_dir(d, model_cfg, with_t5):
    """The reference layout: the DiT (random head) as safetensors, the VAE
    as Wan2.1_VAE.pth and, on request, the umT5 encoder's file; fp32."""
    d.mkdir()
    model = build_wan_model(model_cfg, "cpu", torch.float32, seed=0)
    with torch.no_grad():
        model.head.head.weight.normal_(
            0.0, 0.1, generator=torch.Generator().manual_seed(1))
    save_file(model.state_dict(),
              str(d / "diffusion_pytorch_model.safetensors"))
    vae = build_vae(TINY_TEST.vae, "cpu", torch.float32, seed=3)
    torch.save(vae.state_dict(), str(d / "Wan2.1_VAE.pth"))
    if with_t5:
        t5 = build_t5_encoder(TINY_TEST.t5, "cpu", torch.float32, seed=4)
        torch.save(t5.state_dict(), str(d / T5_CHECKPOINT))
    return str(d)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("ckpt")
    return {"t5": _write_dir(root / "t5", TINY_TEST.model, True),
            "no_t5": _write_dir(root / "no_t5", TINY_TEST.model, False),
            "i2v": _write_dir(root / "i2v", TINY_I2V.model, False)}


def _file(d, name):
    return load_torch_state_dict(os.path.join(d, name))


def _f32(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _equal(got, want, what):
    assert set(got) == set(want), what
    for k, w in want.items():
        assert got[k].dtype == w.dtype and torch.equal(got[k], w), (what, k)


def test_missing_vae_file_raises_in_both(dirs, tmp_path):
    d = tmp_path / "no_vae"
    d.mkdir()
    shutil.copy(os.path.join(dirs["no_t5"],
                             "diffusion_pytorch_model.safetensors"), d)
    with pytest.raises((FileNotFoundError, OSError)):
        JaxWanT2V(JAX_TINY, checkpoint_dir=str(d))
    with pytest.raises(FileNotFoundError, match="Wan2.1_VAE.pth"):
        WanT2V(TINY_TEST, device="cpu", checkpoint_dir=str(d))
    empty = tmp_path / "empty"
    empty.mkdir()
    shutil.copy(os.path.join(dirs["no_t5"], "Wan2.1_VAE.pth"), empty)
    with pytest.raises(FileNotFoundError, match="safetensors"):
        WanT2V(TINY_TEST, device="cpu", checkpoint_dir=str(empty))


def test_wan_i2v_loads_the_directory(dirs):
    d = dirs["i2v"]
    pipe = WanI2V(TINY_I2V, device="cpu", checkpoint_dir=d,
                  param_dtype=torch.float32)
    _equal(pipe.model.state_dict(),
           _file(d, "diffusion_pytorch_model.safetensors"), "i2v DiT")
    assert "img_emb.proj.1.weight" in pipe.model.state_dict()
    _equal(pipe.vae.state_dict(), _file(d, "Wan2.1_VAE.pth"), "VAE")
    # no CLIP file is read: CLIP is random from init_seed + 2
    _equal(pipe.clip.model.state_dict(),
           CLIPModel(TINY_I2V.clip, "cpu", seed=2).model.state_dict(), "CLIP")


def test_wan_i2v_reads_the_directorys_clip_file(dirs, tmp_path):
    """With the Wan 2.1 i2v CLIP file in the directory, CLIP's visual tower
    is that file's (its text tower and log_scale are not carried); the
    directory without it keeps the random CLIP above."""
    d = tmp_path / "i2v_clip"
    shutil.copytree(dirs["i2v"], d)
    clip = build_clip(TINY_I2V.clip, "cpu", seed=11)
    sd = dict(clip.state_dict(), log_scale=torch.tensor(4.6),
              **{"textual.norm.weight": torch.ones(16)})
    torch.save(sd, str(d / CLIP_CHECKPOINT))
    pipe = WanI2V(TINY_I2V, device="cpu", checkpoint_dir=str(d),
                  param_dtype=torch.float32)
    _equal(pipe.clip.model.state_dict(), clip.state_dict(), "CLIP file")
    del sd["visual.transformer.2.mlp.2.bias"]
    torch.save(sd, str(d / CLIP_CHECKPOINT))
    with pytest.raises(KeyError, match="transformer.2.mlp.2.bias"):
        WanI2V(TINY_I2V, device="cpu", checkpoint_dir=str(d))


@pytest.mark.parametrize("one_step", [False, True])
def test_cli_generate_with_ckpt_dir(dirs, tmp_path, monkeypatch, one_step):
    from omnihuman_tpu_torch.cli import generate
    built = []         # the pipeline the CLI builds
    monkeypatch.setattr(t2v, "WanT2V", _recording(WanT2V, built))
    argv = ["--task", "tiny-test", "--size", "32*48", "--frame_num", "5",
            "--ckpt_dir", dirs["t5"], "--base_seed", "0", "--device", "cpu",
            "--save_file", str(tmp_path / "clip.mp4")]
    ema = None
    if one_step:
        model = build_wan_model(TINY_TEST.model, "cpu", torch.bfloat16,
                                seed=7)
        ema = {n: p.detach().clone() for n, p in model.named_parameters()}
        CheckpointManager(str(tmp_path / "g")).save(
            1, {"params": ema, "ema_params": ema, "step": 1})
        argv += ["--one_step", "--generator_ckpt", str(tmp_path / "g")]
    else:
        argv += ["--sample_steps", "2"]
    out = generate.main(argv)
    assert os.path.exists(out) and os.path.getsize(out) > 0
    pipe, = built
    want = ema if one_step else {
        k: v.to(torch.bfloat16) for k, v in
        _file(dirs["t5"], "diffusion_pytorch_model.safetensors").items()}
    _equal(dict(pipe.model.named_parameters()) if one_step else
           pipe.model.state_dict(), want, "DiT")
    _equal(pipe.vae.state_dict(), {k: v.to(torch.bfloat16) for k, v in
                                   _file(dirs["t5"], "Wan2.1_VAE.pth").items()},
           "VAE")


def _recording(cls, built):
    """`cls` that keeps each instance it builds in `built`."""
    class Recording(cls):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            built.append(self)
    return Recording
