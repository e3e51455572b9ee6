"""The port's t2v pipeline against the JAX package at TINY_TEST on the CPU.

The same weights (carried by the port's converters), the same numpy noise
and the same context go into JAX `sample()` and the port's `sample()`;
JAX's noise comes from jax.random and cannot be made in torch, so both
get the array. Tolerance 1e-3 on latents after 3 UniPC steps and on the
decoded video: fp32 throughout, with small per-step differences amplified
by classifier-free guidance (scale 5)."""

import os

import jax
import numpy as np
import pytest
import torch

from omnihuman_tpu.configs.wan import TINY_TEST as JAX_TINY
from omnihuman_tpu.models.vae import init_vae
from omnihuman_tpu.models.wan_dit import init_wan_model
from omnihuman_tpu_torch.configs.wan import TINY_TEST, DTypePolicy
from omnihuman_tpu_torch.models.vae import build_vae
from omnihuman_tpu_torch.models.wan_dit import build_wan_model
from omnihuman_tpu_torch.ops.flash_attention import KERNELS
from omnihuman_tpu_torch.pipelines.text2video import WanT2V, sample
from omnihuman_tpu_torch.utils.convert import (
    vae_state_dict_from_jax, wan_dit_state_dict_from_jax)

torch.set_num_threads(1)

NOISE_SHAPE = (1, 16, 3, 8, 8)   # 9 frames at 64x64 -> 48 tokens
SEQ = 48
CTX_LENS = (7, 12)


@pytest.fixture(scope="module")
def weights():
    params = jax.tree.map(np.asarray, init_wan_model(jax.random.key(0),
                                                     JAX_TINY.model))
    rng = np.random.default_rng(42)
    params["head"]["w"] = (rng.normal(size=params["head"]["w"].shape)
                           * 0.1).astype(np.float32)
    vae_params = jax.tree.map(np.asarray,
                              init_vae(jax.random.key(1), JAX_TINY.vae))
    model = build_wan_model(TINY_TEST.model, "cpu", torch.float32, seed=None)
    model.load_state_dict(wan_dit_state_dict_from_jax(params,
                                                      TINY_TEST.model))
    vae = build_vae(TINY_TEST.vae, "cpu", torch.float32, seed=None)
    vae.load_state_dict(vae_state_dict_from_jax(vae_params, TINY_TEST.vae))
    return params, vae_params, model, vae


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    noise = rng.normal(size=NOISE_SHAPE).astype(np.float32)
    ctx = (rng.normal(size=(1, 16, 32)) * 0.5).astype(np.float32)
    ctx_null = (rng.normal(size=(1, 16, 32)) * 0.5).astype(np.float32)
    return noise, ctx, ctx_null


def _port_sample(model, noise, ctx, ctx_null, solver="unipc", steps=3,
                 cfg_mode="fused"):
    return sample(model, torch.from_numpy(noise), torch.from_numpy(ctx),
                  torch.from_numpy(ctx_null),
                  policy=DTypePolicy(compute=torch.float32), seq_len=SEQ,
                  shift=5.0, solver=solver, steps=steps, guide_scale=5.0,
                  num_train_timesteps=1000, cfg_mode=cfg_mode,
                  context_lens=torch.tensor(CTX_LENS))


def test_sequential_cfg_equals_fused(weights):
    _, _, model, _ = weights
    noise, ctx, ctx_null = _inputs(1)
    a = _port_sample(model, noise, ctx, ctx_null, solver="dpm++", steps=2)
    b = _port_sample(model, noise, ctx, ctx_null, solver="dpm++", steps=2,
                     cfg_mode="sequential")
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)


@pytest.fixture(scope="module")
def pipe():
    p = WanT2V(TINY_TEST, device="cpu", param_dtype=torch.float32)
    with torch.no_grad():
        p.model.head.head.weight.normal_(0.0, 0.1, generator=torch.Generator(
        ).manual_seed(0))
    return p


def test_loaded_t5_weights_survive_the_unload():
    """The encoder leaves the card after each request; the weights a caller
    loaded are the ones the next request encodes with, never a re-init."""
    p = WanT2V(TINY_TEST, device="cpu", param_dtype=torch.float32)
    loaded = {k: v * 2 for k, v in p.t5.state_dict().items()}
    p.t5.load_state_dict(loaded)
    for _ in range(2):
        p.generate("a dog", size=(64, 64), frame_num=1, sampling_steps=1,
                   seed=0, return_latents=True)
        for k, v in p.t5.state_dict().items():
            torch.testing.assert_close(v, loaded[k], rtol=0, atol=0)


def test_context_trim_to_bucket_is_exact(pipe):
    """Trimming masked context columns to the 128-bucket changes nothing:
    the 512-wide and the trimmed context give the same latents."""
    rng = np.random.default_rng(4)
    ctx = torch.from_numpy((rng.normal(size=(1, 200, 32)) * 0.5
                            ).astype(np.float32))
    ctx_null = torch.from_numpy((rng.normal(size=(1, 200, 32)) * 0.5
                                 ).astype(np.float32))
    lens = torch.tensor([9, 20], dtype=torch.int32)
    kw = dict(size=(64, 64), frame_num=5, sampling_steps=2, seed=1,
              return_latents=True)
    trimmed = pipe.generate("", context=ctx, context_null=ctx_null,
                            context_lens=lens, **kw)
    full = sample(pipe.model, torch.randn(
        (1, 16, 2, 8, 8), generator=torch.Generator().manual_seed(1)),
        ctx, ctx_null, policy=pipe.policy, seq_len=32, shift=5.0,
        solver="unipc", steps=2, guide_scale=5.0, context_lens=lens)
    np.testing.assert_allclose(trimmed.numpy(), full.numpy(), atol=1e-6)


def test_cli_writes_video_on_cpu(tmp_path):
    from omnihuman_tpu_torch.cli.generate import main
    out = main(["--task", "tiny-test", "--size", "64*64", "--frame_num", "5",
                "--sample_steps", "2", "--base_seed", "0", "--device", "cpu",
                "--save_file", str(tmp_path / "clip.mp4")])
    assert os.path.exists(out) and os.path.getsize(out) > 0


@pytest.mark.parametrize("argv", [["--sp_size", "2"],
                                  ["--fsdp_size", "2"],
                                  ["--sp_size=4"],
                                  ["--fsdp_size=8"]])
def test_cli_refuses_paths_of_later_slices(argv):
    """The multi-GPU flags parse; one process asked for sizes above 1
    exits with the torchrun command that starts one process per device
    (the mesh runs in tests/test_torch_sp_model.py)."""
    from omnihuman_tpu_torch.cli.generate import build_parser, main
    args = build_parser().parse_args(argv)
    assert max(args.sp_size, args.fsdp_size) in (2, 4, 8)
    with pytest.raises(SystemExit, match="torchrun --nproc_per_node"):
        main(argv + ["--device", "cpu"])


def test_no_kernel_launch_on_cpu():
    assert [kn.launches for kn in KERNELS] == [0] * len(KERNELS) == [0] * 3
