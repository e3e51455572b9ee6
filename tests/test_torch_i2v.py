"""The port's i2v slice against the JAX package at TINY_I2V
(tests/test_clip_i2v.py), and the one-step generator at TINY_TEST, fp32
compute, the same weights carried by the port's converters and the same
numpy inputs (noise included).

- the i2v DiT (y concat, img_emb, split cross-attention) against JAX
  `wan_model_forward` with clip_fea, y and context_lens=None: 1e-4;
- the text mask (ROADMAP queue C): the port with a padded context and
  context_lens equals the port with the context cut to those lengths;
  JAX equals its own cut context only with context_lens - clip_tokens,
  because it adds clip_tokens to the lengths (wan_dit.py:467-468): 1e-5;
- `first_frame_mask`, `latent_size_for`: exact;
- the i2v sampler against JAX `_i2v_sample`, 2 UniPC steps with CFG:
  1e-3 (per-step differences amplified by guidance scale 5, as in
  tests/test_torch_pipeline.py);
- one-step: the forward at t = T and the decode against JAX `_one_step`
  and `vae_decode`: 1e-3 on the video; a clip's noise does not depend on
  the batch it rides in;
- the CLI end to end on the CPU: i2v from an image file, one-step from a
  prompts file with --generator_ckpt.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnihuman_tpu.configs.wan import DTypePolicy as JaxPolicy
from omnihuman_tpu.configs.wan import TINY_TEST as JAX_TINY
from omnihuman_tpu.models.vae import init_vae, vae_decode as jax_vae_decode
from omnihuman_tpu.models.wan_dit import init_wan_model, wan_model_forward
from omnihuman_tpu.ops.rope import rope_angles_3d as jax_rope_angles
from omnihuman_tpu.pipelines import image2video as jax_i2v
from omnihuman_tpu.pipelines.wan_inference import _one_step as jax_one_step
from omnihuman_tpu_torch import configs
from omnihuman_tpu_torch.configs.wan import TINY_TEST, CLIPConfig, DTypePolicy
from omnihuman_tpu_torch.models.vae import build_vae, vae_decode
from omnihuman_tpu_torch.models.wan_dit import build_wan_model
from omnihuman_tpu_torch.ops.rope import rope_angles_3d
from omnihuman_tpu_torch.pipelines.image2video import WanI2V
from omnihuman_tpu_torch.pipelines.text2video import WanT2V, sample
from omnihuman_tpu_torch.pipelines.wan_inference import (
    SeaweedWanAPTGenerator, one_step_latents)
from omnihuman_tpu_torch.utils.checkpoint import CheckpointManager
from omnihuman_tpu_torch.utils.convert import (
    vae_state_dict_from_jax, wan_dit_state_dict_from_jax)

torch.set_num_threads(1)

TINY_CLIP = CLIPConfig(
    embed_dim=16, image_size=28, patch_size=14, vision_dim=24,
    vision_heads=4, vision_layers=3, vocab_size=64, text_dim=16,
    text_heads=4, text_layers=2, max_text_len=20)
TINY_I2V = dataclasses.replace(
    TINY_TEST, name="tiny-i2v",
    model=dataclasses.replace(TINY_TEST.model, model_type="i2v", in_dim=36,
                              clip_embed_dim=24, clip_tokens=5),
    clip=TINY_CLIP, sample_steps=2)
JAX_I2V_MODEL = dataclasses.replace(JAX_TINY.model, model_type="i2v",
                                    in_dim=36, clip_embed_dim=24,
                                    clip_tokens=5)
F32 = DTypePolicy(compute=torch.float32)
JAX_F32 = JaxPolicy(compute=jnp.float32)
GRID, SEQ = (2, 2, 3), 16           # latents [*, 2, 4, 6]: 12 tokens


def _random_head(params, seed):
    rng = np.random.default_rng(seed)
    for k in ("w", "b"):
        params["head"][k] = (rng.normal(size=params["head"][k].shape)
                             * 0.1).astype(np.float32)
    return params


@pytest.fixture(scope="module")
def i2v_pair():
    params = _random_head(jax.tree.map(np.asarray, init_wan_model(
        jax.random.key(0), JAX_I2V_MODEL)), 1)
    model = build_wan_model(TINY_I2V.model, "cpu", torch.float32, seed=None)
    model.load_state_dict(wan_dit_state_dict_from_jax(params,
                                                      TINY_I2V.model))
    return jax.tree.map(jnp.asarray, params), model


def _i2v_inputs(b=2, seed=0):
    rng = np.random.default_rng(seed)
    return dict(
        x=rng.normal(size=(b, 16, 2, 4, 6)).astype(np.float32),
        y=rng.normal(size=(b, 20, 2, 4, 6)).astype(np.float32),
        clip=rng.normal(size=(b, 5, 24)).astype(np.float32),
        ctx=rng.normal(size=(b, 16, 32)).astype(np.float32))


@jax.jit
def _jax_forward(params, x, t, ctx, clip, y, lens):
    sin, cos = jax_rope_angles(GRID, JAX_I2V_MODEL.head_dim, seq_len=SEQ)
    return wan_model_forward(params, x, t, ctx, cfg=JAX_I2V_MODEL,
                             seq_len=SEQ, rope_sin=sin, rope_cos=cos,
                             context_lens=lens, clip_fea=clip, y=y,
                             policy=JAX_F32, remat=False)


def _port_forward(model, inp, t, ctx, lens=None):
    sin, cos = rope_angles_3d(GRID, TINY_I2V.model.head_dim, seq_len=SEQ)
    with torch.inference_mode():
        return model(torch.from_numpy(inp["x"]), torch.from_numpy(t),
                     torch.from_numpy(ctx), seq_len=SEQ, rope_sin=sin,
                     rope_cos=cos, context_lens=lens,
                     clip_fea=torch.from_numpy(inp["clip"]),
                     y=torch.from_numpy(inp["y"]), policy=F32).numpy()


def test_i2v_dit_matches_jax(i2v_pair):
    params, model = i2v_pair
    inp, t = _i2v_inputs(), np.array([999.0, 312.5], np.float32)
    want = np.asarray(_jax_forward(params, inp["x"], t, inp["ctx"],
                                   inp["clip"], inp["y"], None))
    got = _port_forward(model, inp, t, inp["ctx"])
    assert got.shape == (2, 16, 2, 4, 6)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_i2v_text_mask_counts_text_keys_only(i2v_pair):
    """A padded context with context_lens equals the context cut to those
    lengths. One request per call: the cut context has one length."""
    params, model = i2v_pair
    inp, t = _i2v_inputs(b=1, seed=3), np.array([700.0], np.float32)
    n = 3
    cut = np.ascontiguousarray(inp["ctx"][:, :n])
    lens = np.array([n], np.int32)
    port_pad = _port_forward(model, inp, t, inp["ctx"], torch.tensor(lens))
    port_cut = _port_forward(model, inp, t, cut)
    np.testing.assert_allclose(port_pad, port_cut, atol=1e-5)
    # where the JAX offset lies: lengths minus clip_tokens give its cut
    jax_cut = np.asarray(_jax_forward(params, inp["x"], t, cut, inp["clip"],
                                      inp["y"], None))
    jax_pad = np.asarray(_jax_forward(
        params, inp["x"], t, inp["ctx"], inp["clip"], inp["y"],
        jnp.asarray(lens - JAX_I2V_MODEL.clip_tokens)))
    np.testing.assert_allclose(jax_pad, jax_cut, atol=1e-5)
    np.testing.assert_allclose(port_cut, jax_cut, atol=1e-4)


def test_first_frame_mask_and_latent_size_match_jax():
    for frames, lh, lw in ((9, 4, 4), (81, 60, 104), (1, 2, 2)):
        want = np.asarray(jax_i2v.WanI2V.first_frame_mask(frames, lh, lw))
        got = WanI2V.first_frame_mask(frames, lh, lw).numpy()
        np.testing.assert_array_equal(got, want)
    jax_pipe = jax_i2v.WanI2V.__new__(jax_i2v.WanI2V)
    jax_pipe.vae_stride, jax_pipe.patch_size = (4, 8, 8), (1, 2, 2)
    port_pipe = WanI2V.__new__(WanI2V)
    port_pipe.vae_stride, port_pipe.patch_size = (4, 8, 8), (1, 2, 2)
    for hw, area in (((480, 832), 480 * 832), ((1080, 1920), 720 * 1280),
                     ((40, 40), 32 * 32), ((333, 517), 480 * 832)):
        assert port_pipe.latent_size_for(hw, area) == \
            jax_pipe.latent_size_for(hw, area)


def test_i2v_sample_matches_jax(i2v_pair):
    params, model = i2v_pair
    rng = np.random.default_rng(9)
    noise = rng.normal(size=(1, 16, 2, 4, 6)).astype(np.float32)
    y = rng.normal(size=(1, 20, 2, 4, 6)).astype(np.float32)
    clip = rng.normal(size=(1, 5, 24)).astype(np.float32)
    ctx, ctx_null = (rng.normal(size=(1, 16, 32)).astype(np.float32) * 0.5
                     for _ in range(2))
    kw = dict(seq_len=SEQ, shift=5.0, solver="unipc", steps=2,
              guide_scale=5.0, num_train_timesteps=1000)
    want = np.asarray(jax_i2v._i2v_sample(
        params, jnp.asarray(noise), jnp.asarray(y), jnp.asarray(clip),
        jnp.asarray(ctx), jnp.asarray(ctx_null), model_cfg=JAX_I2V_MODEL,
        policy=JAX_F32, patch_size=(1, 2, 2), **kw))
    got = sample(model, torch.from_numpy(noise), torch.from_numpy(ctx),
                 torch.from_numpy(ctx_null), policy=F32,
                 y=torch.from_numpy(y), clip_fea=torch.from_numpy(clip), **kw)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3)


# ---------------------------------------------------------------------------
# one-step


@pytest.fixture(scope="module")
def t2v_pair():
    params = _random_head(jax.tree.map(np.asarray, init_wan_model(
        jax.random.key(4), JAX_TINY.model)), 5)
    vae_params = jax.tree.map(np.asarray,
                              init_vae(jax.random.key(6), JAX_TINY.vae))
    pipe = WanT2V(TINY_TEST, param_dtype=torch.float32, device="cpu")
    pipe.model.load_state_dict(wan_dit_state_dict_from_jax(params,
                                                           TINY_TEST.model))
    pipe.vae.load_state_dict(vae_state_dict_from_jax(vae_params,
                                                     TINY_TEST.vae))
    return (jax.tree.map(jnp.asarray, params),
            jax.tree.map(jnp.asarray, vae_params), pipe)


def test_one_step_matches_jax(t2v_pair):
    params, vae_params, pipe = t2v_pair
    rng = np.random.default_rng(10)
    noise = rng.normal(size=(2, 16, 2, 4, 6)).astype(np.float32)
    ctx = rng.normal(size=(2, 16, 32)).astype(np.float32)
    lens = np.array([9, 16], np.int32)
    sin, cos = jax_rope_angles(GRID, JAX_TINY.model.head_dim, seq_len=SEQ)
    v = jax_one_step(params, jnp.asarray(noise), jnp.asarray(ctx),
                     JAX_TINY.model, SEQ, sin, cos, JAX_F32, 1000.0,
                     context_lens=jnp.asarray(lens))
    want = np.asarray(jax.jit(lambda p, z: jax_vae_decode(
        p, z, JAX_TINY.vae, streaming=True))(vae_params, noise - v))
    psin, pcos = rope_angles_3d(GRID, TINY_TEST.model.head_dim, seq_len=SEQ)
    lat = one_step_latents(pipe.model, torch.from_numpy(noise),
                           torch.from_numpy(ctx), seq_len=SEQ, rope_sin=psin,
                           rope_cos=pcos, policy=F32, t_final=1000.0,
                           context_lens=torch.from_numpy(lens))
    got = vae_decode(pipe.vae, lat, streaming=True)
    assert got.shape == (2, 3, 5, 32, 48)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3)


def test_one_step_noise_is_independent_of_the_batch(t2v_pair):
    _, _, pipe = t2v_pair
    gen = SeaweedWanAPTGenerator(pipe)
    ctx = torch.from_numpy(np.random.default_rng(11).normal(
        size=(2, 16, 32)).astype(np.float32))
    kw = dict(size=(48, 32), frame_num=5, seed=7, return_latents=True)
    both = gen.generate_batch(["a", "b"], context=ctx, **kw)
    first = gen.generate_batch(["a"], context=ctx[:1], **kw)
    # the same noise: equal up to the batch's own summation order (other
    # noise would differ by the noise's scale, ~1)
    np.testing.assert_allclose(both[:1].numpy(), first.numpy(), atol=1e-5)
    assert not torch.allclose(both[0], both[1], atol=1e-1)
    assert set(gen.timings) == {"text_encode_s", "dit_s"}
    video = gen.generate_batch(["a", "b"], context=ctx, size=(48, 32),
                               frame_num=5, seed=7)
    assert video.shape == (2, 3, 5, 32, 48)
    assert set(gen.timings) == {"text_encode_s", "dit_s", "vae_decode_s",
                                "frames_per_sec"}


# ---------------------------------------------------------------------------
# CLI on the CPU


def test_cli_i2v_writes_video_on_cpu(tmp_path, monkeypatch):
    from PIL import Image

    from omnihuman_tpu_torch.cli.generate import main
    monkeypatch.setitem(configs.WAN_CONFIGS, "tiny-i2v", TINY_I2V)
    img = np.random.default_rng(12).integers(0, 255, size=(40, 56, 3),
                                             dtype=np.uint8)
    Image.fromarray(img).save(tmp_path / "first.png")
    out = main(["--task", "tiny-i2v", "--size", "32*48", "--image",
                str(tmp_path / "first.png"), "--frame_num", "5",
                "--sample_steps", "2", "--base_seed", "0", "--device", "cpu",
                "--save_file", str(tmp_path / "clip.mp4")])
    assert os.path.exists(out) and os.path.getsize(out) > 0


def test_cli_one_step_with_generator_checkpoint(tmp_path):
    from omnihuman_tpu_torch.cli.generate import main
    model = build_wan_model(TINY_TEST.model, "cpu", torch.bfloat16, seed=3)
    ema = {n: p.detach().clone() for n, p in model.named_parameters()}
    CheckpointManager(str(tmp_path / "ck")).save(
        1, {"params": ema, "ema_params": ema, "step": 1})
    (tmp_path / "prompts.txt").write_text("a red fox\n\ntwo cats\n")
    paths = main(["--task", "tiny-test", "--size", "32*48", "--one_step",
                  "--prompts_file", str(tmp_path / "prompts.txt"),
                  "--generator_ckpt", str(tmp_path / "ck"), "--frame_num",
                  "5", "--device", "cpu", "--save_file",
                  str(tmp_path / "one.mp4")])
    assert len(paths) == 2 and all(os.path.getsize(p) > 0 for p in paths)
