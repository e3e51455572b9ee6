"""The port's OmniHuman model and sampling against the JAX package, on the
CPU at the JAX tests' small omni config (dim 32, 2 layers, audio_dim 20,
8 keypoints, 8 temporal rows).

The same weights go to both (the JAX init with a random head, adapter
`o`, gate and `pose_proj`, carried by `omni_state_dict_from_jax`: the
reference zero-inits those, which would make every condition a no-op),
and the same numpy inputs. Tolerances: the condition encoders 1e-4 in
fp32; the forward 1e-4 in fp32 (another summation order in the matmuls,
convs and attention), 1e-3 with the bf16 residual stream ("fast");
`omni_generate` (2 DPM++ steps) and `omni_generate_windowed` (2 windows,
JAX's noise patched into the port) 1e-3, where CFG amplifies the
per-step differences. Each JAX reference is one jitted program, compiled
with `xla_allow_excess_precision` off: XLA:CPU otherwise keeps fused
bf16 intermediates in fp32 and skips the roundings the JAX code asks for
(3.4e-3 off its own eager result on the fast forward), which the port
performs."""

import dataclasses
import os
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnihuman_tpu.configs.wan import DTypePolicy as JaxPolicy
from omnihuman_tpu.configs.wan import WanModelConfig as JaxWanCfg
from omnihuman_tpu.omni.model import OmniModelConfig as JaxOmniCfg
from omnihuman_tpu.omni.model import init_omni_model
from omnihuman_tpu.omni.model import omni_model_forward as jax_forward
from omnihuman_tpu.omni.model import process_audio as jax_process_audio
from omnihuman_tpu.omni.model import process_pose as jax_process_pose
from omnihuman_tpu.pipelines.omni import omni_generate as jax_generate
from omnihuman_tpu.pipelines.omni import (
    omni_generate_windowed as jax_windowed)
from omnihuman_tpu.utils.convert import convert_wan_dit
from omnihuman_tpu_torch.configs.wan import DTypePolicy, WanModelConfig
from omnihuman_tpu_torch.omni.model import (
    OmniModelConfig, build_omni_model, omni_model_forward, process_audio,
    process_pose)
from omnihuman_tpu_torch.ops.flash_attention import KERNELS
from omnihuman_tpu_torch.ops.vae_kernels import KERNELS as VAE_KERNELS
from omnihuman_tpu_torch.pipelines import omni as omni_pipe
from omnihuman_tpu_torch.utils.convert import omni_state_dict_from_jax

torch.set_num_threads(1)

BASE = dict(dim=32, ffn_dim=64, num_heads=4, num_layers=2, freq_dim=16,
            text_dim=24, text_len=8)
JCFG = JaxOmniCfg(base=JaxWanCfg(**BASE), audio_dim=20, num_keypoints=8,
                  num_frames=8)
PCFG = OmniModelConfig(base=WanModelConfig(**BASE), audio_dim=20,
                       num_keypoints=8, num_frames=8)
JFP32 = JaxPolicy(compute=jnp.float32)
PFP32 = DTypePolicy(compute=torch.float32)
B, C, F, H, W = 2, 16, 2, 8, 8
CTX_LENS = (8, 5)


def _randomise(params, rng):
    """Random values where the reference init puts zeros or ones."""
    def rnd(a, scale):
        return (rng.normal(size=np.shape(a)) * scale).astype(np.float32)

    base, cond = params["base"], params["cond"]
    base["head"]["w"] = rnd(base["head"]["w"], 0.1)
    ad = base["blocks"]["audio_attn"]
    ad["o"]["w"] = rnd(ad["o"]["w"], 0.2)
    ad["o"]["b"] = rnd(ad["o"]["b"], 0.1)
    ad["gate"] = (1.0 + rnd(ad["gate"], 0.3)).astype(np.float32)
    ad["norm"]["b"] = rnd(ad["norm"]["b"], 0.1)
    cond["pose_proj"]["w"] = rnd(cond["pose_proj"]["w"], 0.2)
    cond["pose_proj"]["b"] = rnd(cond["pose_proj"]["b"], 0.1)
    return params


@pytest.fixture(scope="module")
def omni():
    params = jax.tree.map(np.asarray, init_omni_model(jax.random.key(0),
                                                      JCFG))
    params = _randomise(params, np.random.default_rng(1))
    model = build_omni_model(PCFG, "cpu", torch.float32, seed=None)
    model.load_state_dict(omni_state_dict_from_jax(params, PCFG),
                          strict=True)
    rng = np.random.default_rng(0)
    batch = {
        "x": rng.normal(size=(B, C, F, H, W)).astype(np.float32),
        "t": np.array([500.0, 100.0], np.float32),
        "context": rng.normal(size=(B, 8, 24)).astype(np.float32),
        "audio": rng.normal(size=(B, 4, 20)).astype(np.float32),
        "pose": (rng.normal(size=(B, 8, F, 2 * H, 2 * W)) * 0.1
                 ).astype(np.float32),
        "ref_latent": rng.normal(size=(B, C, 1, H, W)).astype(np.float32),
        "motion_latent": rng.normal(size=(B, C, 2, H, W)).astype(
            np.float32),
    }
    return params, model, batch


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _run_exact(fn, *args):
    """fn(*args) as one jitted program that rounds wherever the JAX code
    casts (no XLA excess precision)."""
    return jax.jit(fn).lower(*args).compile(
        {"xla_allow_excess_precision": False})(*args)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_process_audio_and_pose_match_jax(omni):
    params, model, batch = omni

    def ref(cond, audio, pose):
        return (jax_process_audio(cond, audio),
                jax_process_pose(cond, pose, JCFG.base.patch_size))

    want_a, want_p = _run_exact(ref, _j(params["cond"]), batch["audio"],
                                batch["pose"])
    got_a = process_audio(model.cond, _t(batch["audio"]))
    got_p = process_pose(model.cond, _t(batch["pose"]), PCFG.base.patch_size)
    assert got_a.shape == (B, 4, 32) and got_p.shape == (B, F * 16, 32)
    np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a), atol=1e-4)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), atol=1e-4)


FORWARD_CASES = {
    "text_only": dict(conds=(), mask=False, fast=False),
    "all_conditions_masked": dict(conds=("audio", "pose", "ref_latent"),
                                  mask=True, fast=False),
    "motion": dict(conds=("audio", "ref_latent", "motion_latent"),
                   mask=False, fast=False),
    "fast": dict(conds=("audio", "pose", "ref_latent", "motion_latent"),
                 mask=False, fast=True),
}
MASK = {"audio": np.array([1.0, 0.0], np.float32),
        "pose": np.array([0.0, 1.0], np.float32),
        "reference": np.array([1.0, 0.0], np.float32)}


@pytest.mark.parametrize("case", sorted(FORWARD_CASES))
def test_forward_matches_jax(omni, case):
    params, model, batch = omni
    c = FORWARD_CASES[case]
    jpol = (dataclasses.replace(JFP32, residual=jnp.bfloat16) if c["fast"]
            else JFP32)
    ppol = (dataclasses.replace(PFP32, residual=torch.bfloat16)
            if c["fast"] else PFP32)
    conds = {k: batch[k] for k in c["conds"]}
    mask = MASK if c["mask"] else None
    lens = np.array(CTX_LENS, np.int32)

    def ref(p, x, t, ctx, conds, mask, lens):
        return jax_forward(p, x, t, ctx, cfg=JCFG, cond_mask=mask,
                           context_lens=lens, policy=jpol, remat=False,
                           **conds)

    want = _run_exact(ref, _j(params), batch["x"], batch["t"],
                      batch["context"], _j(conds),
                      None if mask is None else _j(mask), lens)
    got = omni_model_forward(
        model, _t(batch["x"]), _t(batch["t"]), _t(batch["context"]),
        cond_mask=None if mask is None else {k: _t(v)
                                             for k, v in mask.items()},
        context_lens=_t(lens), policy=ppol,
        **{k: _t(v) for k, v in conds.items()})
    assert got.shape == (B, C, F, H, W) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=1e-3 if c["fast"] else 1e-4)


def test_conditions_move_the_output(omni):
    """Each condition, with the randomised adapters and projection, changes
    the velocity; a temporal embedding row per latent frame is required."""
    _, model, batch = omni
    x, t, ctx = _t(batch["x"]), _t(batch["t"]), _t(batch["context"])
    v0 = omni_model_forward(model, x, t, ctx, policy=PFP32)
    for name in ("audio", "pose", "ref_latent", "motion_latent"):
        v = omni_model_forward(model, x, t, ctx, policy=PFP32,
                               **{name: _t(batch[name])})
        assert (v - v0).abs().max() > 1e-3, name
    long_x = torch.zeros((1, C, PCFG.num_frames + 1, H, W))
    with pytest.raises(ValueError, match="num_frames"):
        omni_model_forward(model, long_x, t[:1], ctx[:1], policy=PFP32)


def test_converter_round_trip(omni):
    """JAX params -> port state dict -> the port model's state dict: the
    DiT part goes back through JAX's convert_wan_dit bit-equal, and every
    adapter / condition tensor comes back as the JAX array."""
    params, model, _ = omni
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    base_sd = {k[len("base."):]: v for k, v in sd.items()
               if k.startswith("base.") and ".audio_attn." not in k}
    back = convert_wan_dit(base_sd, JCFG.base)
    want = dict(params["base"])
    want["blocks"] = {k: v for k, v in want["blocks"].items()
                      if k != "audio_attn"}
    flat_a = jax.tree_util.tree_leaves_with_path(want)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), leaf)
    ad = params["base"]["blocks"]["audio_attn"]
    for i in range(JCFG.base.num_layers):
        p = f"base.blocks.{i}.audio_attn"
        np.testing.assert_array_equal(sd[f"{p}.q.weight"], ad["q"]["w"][i].T)
        np.testing.assert_array_equal(sd[f"{p}.o.bias"], ad["o"]["b"][i])
        np.testing.assert_array_equal(sd[f"{p}.gate"], ad["gate"][i])
        np.testing.assert_array_equal(sd[f"{p}.norm.bias"],
                                      ad["norm"]["b"][i])
    cond = params["cond"]
    np.testing.assert_array_equal(sd["cond.pose_conv2.weight"],
                                  cond["pose_conv2"]["w"].transpose(
                                      4, 3, 0, 1, 2))
    np.testing.assert_array_equal(sd["cond.audio_merge.weight"],
                                  cond["audio_merge"]["w"].T)
    np.testing.assert_array_equal(sd["cond.temporal_embed"],
                                  cond["temporal_embed"])


def _contexts(rng, b):
    ctx = (rng.normal(size=(b, 8, 24)) * 0.5).astype(np.float32)
    ctx_null = (rng.normal(size=(b, 8, 24)) * 0.5).astype(np.float32)
    return ctx, ctx_null


def test_omni_generate_matches_jax(omni):
    params, model, batch = omni
    rng = np.random.default_rng(5)
    noise = rng.normal(size=(B, C, F, H, W)).astype(np.float32)
    ctx, ctx_null = _contexts(rng, B)
    lens = np.array([6, 8], np.int32)
    nlens = np.array([3, 7], np.int32)
    kw = dict(sampling_steps=2, cfg_scale=5.0, shift=1.0)

    def ref(p, noise, ctx, ctx_null, audio, pose, ref_lat, lens, nlens):
        return jax_generate(p, noise, ctx, ctx_null, cfg=JCFG, policy=JFP32,
                            audio=audio, pose=pose, ref_latent=ref_lat,
                            context_lens=lens, null_lens=nlens, **kw)

    want = _run_exact(ref, _j(params), noise, ctx, ctx_null,
                      batch["audio"], batch["pose"], batch["ref_latent"],
                      lens, nlens)
    got = omni_pipe.omni_generate(
        model, _t(noise), _t(ctx), _t(ctx_null), policy=PFP32,
        audio=_t(batch["audio"]), pose=_t(batch["pose"]),
        ref_latent=_t(batch["ref_latent"]), context_lens=_t(lens),
        null_lens=_t(nlens), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3)


def test_omni_generate_windowed_matches_jax(omni, monkeypatch):
    """Two windows of 3 latent frames trimmed to 5, audio and pose tracks
    of 4 frames (the second window repeats their last frame), motion
    tokens of 1 frame; the port draws each window's noise from JAX's key,
    as the JAX package does (`fold_in(key, window)`)."""
    params, model, _ = omni
    rng = np.random.default_rng(9)
    f_win, total, seed = 3, 5, 17
    shape = (1, C, f_win, H, W)
    ctx, ctx_null = _contexts(rng, 1)
    audio = rng.normal(size=(1, 4, 20)).astype(np.float32)
    pose = (rng.normal(size=(1, 8, 4, 2 * H, 2 * W)) * 0.1).astype(
        np.float32)
    ref_lat = rng.normal(size=(1, C, 1, H, W)).astype(np.float32)
    kw = dict(sampling_steps=2, cfg_scale=4.0, shift=1.0)

    want = jax_windowed(
        _j(params), jax.random.key(seed), cfg=JCFG, latent_shape=shape,
        context=jnp.asarray(ctx), context_null=jnp.asarray(ctx_null),
        total_frames=total, motion_frames=1, audio=jnp.asarray(audio),
        pose=jnp.asarray(pose), ref_latent=jnp.asarray(ref_lat),
        policy=JFP32, **kw)

    def jax_noise(s, window, shp, device):
        key = jax.random.fold_in(jax.random.key(s), window)
        return _t(np.asarray(jax.random.normal(key, shp, jnp.float32)))

    monkeypatch.setattr(omni_pipe, "window_noise", jax_noise)
    timings = {}
    got = omni_pipe.omni_generate_windowed(
        model, seed, latent_shape=shape, context=_t(ctx),
        context_null=_t(ctx_null), total_frames=total, motion_frames=1,
        audio=_t(audio), pose=_t(pose), ref_latent=_t(ref_lat),
        timings=timings, policy=PFP32, **kw)
    assert got.shape == (1, C, total, H, W)
    assert len(timings["windows_s"]) == 2
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3)


def _write_inputs(tmp_path):
    from PIL import Image
    rng = np.random.default_rng(3)
    img = tmp_path / "ref.png"
    Image.fromarray(rng.integers(0, 255, (64, 64, 3), dtype=np.uint8)
                    ).save(img)
    wav = tmp_path / "speech.wav"
    with wave.open(str(wav), "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(16000)
        f.writeframes((rng.normal(size=8000) * 3000).astype(np.int16)
                      .tobytes())
    return str(img), str(wav)


@pytest.mark.parametrize("precision", ["fast", "int8"])
def test_cli_writes_video_on_cpu(tmp_path, precision):
    """Two windows (3 latent frames, 2 a window, 1 motion frame), log-mel
    audio, through `main`; int8 quantizes the base blocks."""
    from omnihuman_tpu_torch.cli.omni_inference import main
    img, wav = _write_inputs(tmp_path)
    out = main(["--task", "tiny-test", "--reference_image", img,
                "--audio", wav, "--size", "64*64", "--num_frames", "2",
                "--total_frames", "3", "--motion_frames", "1",
                "--num_inference_steps", "2", "--precision", precision,
                "--device", "cpu", "--output", str(tmp_path / "o.mp4")])
    assert os.path.exists(out) and os.path.getsize(out) > 0


def test_run_takes_arrays_and_pose(tmp_path):
    """`run` on arrays: seeded keypoints -> heatmaps at 2x the latent grid,
    the video's shape and range, and the stage timings."""
    from omnihuman_tpu_torch.cli.omni_inference import build_parser, run
    from omnihuman_tpu_torch.omni.dataset import generate_heatmaps
    args = build_parser().parse_args(
        ["--task", "tiny-test", "--size", "64*48", "--num_frames", "2",
         "--num_inference_steps", "1", "--device", "cpu"])
    args.output = None
    rng = np.random.default_rng(4)
    kps = rng.uniform(0.0, 1.0, (2, 308, 3)).astype(np.float32)
    pose = np.stack([generate_heatmaps(k, (12, 16)) for k in kps], axis=1)
    out = run(args, rng.integers(0, 255, (48, 64, 3), dtype=np.uint8),
              rng.normal(size=4000).astype(np.float32) * 0.1, 8000,
              pose=pose)
    video = out["video"]
    assert out["path"] is None and video.shape == (3, 5, 48, 64)
    assert torch.isfinite(video).all() and video.abs().max() <= 1.0
    assert {"t5_encode_s", "ref_encode_s", "windows_s", "vae_decode_s",
            "audio_features_s"} <= set(out["timings"])


@pytest.mark.parametrize("argv", [["--pose_video", "drive.mp4"],
                                  ["--checkpoint", "ckpt"],
                                  ["--ckpt_dir", "wan"],
                                  ["--sp_size", "2"],
                                  ["--fsdp_size", "2"]])
def test_cli_refuses_paths_not_ported(argv):
    from omnihuman_tpu_torch.cli.omni_inference import main
    with pytest.raises(SystemExit, match="item"):
        main(argv + ["--reference_image", "x.png", "--device", "cpu"])


def test_reference_encode_keeps_channels_last(monkeypatch):
    """The reference image arrives as an HWC array viewed [1, 3, 1, H, W]:
    the streaming VAE must still hand the fused convs (K3 on the card,
    which refuses any other layout) channels-last tensors."""
    from omnihuman_tpu_torch.configs.wan import VAEConfig
    from omnihuman_tpu_torch.models import vae as vae_mod
    from omnihuman_tpu_torch.ops import vae_kernels as vk
    vae = vae_mod.build_vae(VAEConfig(base_dim=16, dim_mult=(1, 2, 4, 4),
                                      num_res_blocks=1), "cpu",
                            torch.bfloat16, seed=3)
    plain = vk.fused_act_causal_conv3d_plain
    seen = []

    def checked(x, *a, **kw):
        seen.append(x.is_contiguous(memory_format=torch.channels_last_3d))
        return plain(x, *a, **kw)

    monkeypatch.setattr(vk, "fused_act_causal_conv3d_plain", checked)
    img = np.random.default_rng(0).random((48, 80, 3), np.float32)
    ref = torch.as_tensor(img.transpose(2, 0, 1))       # strides (1, 240, 3)
    vae_mod.vae_encode(vae, ref[None, :, None], conv_impl="plain")
    assert seen and all(seen)


def test_no_kernel_launch_on_cpu():
    assert [kn.launches for kn in KERNELS + VAE_KERNELS] == [0] * 5
