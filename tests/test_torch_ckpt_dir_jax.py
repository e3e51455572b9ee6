"""WanT2V from a checkpoint directory against JAX's: the slow cases of
tests/test_torch_ckpt_dir.py (whose helpers they use), in a file of their
own so that a `--dist loadfile` run schedules them with the files of few
tests, beside the longest ones, instead of before them."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnihuman_tpu.configs.wan import DTypePolicy as JaxPolicy
from omnihuman_tpu.configs.wan import TINY_TEST as JAX_TINY
from omnihuman_tpu.models.vae import vae_decode as jax_vae_decode
from omnihuman_tpu.pipelines.text2video import WanT2V as JaxWanT2V
from omnihuman_tpu.pipelines.text2video import sample as jax_sample
from omnihuman_tpu_torch.configs.wan import DTypePolicy, TINY_TEST
from omnihuman_tpu_torch.models.t5 import build_t5_encoder, T5_CHECKPOINT
from omnihuman_tpu_torch.models.vae import vae_decode
from omnihuman_tpu_torch.pipelines.text2video import sample, WanT2V
from omnihuman_tpu_torch.utils.convert import (
    t5_state_dict_from_jax, vae_state_dict_from_jax,
    wan_dit_state_dict_from_jax)
# fixtures and helpers of the file these cases came from
from test_torch_ckpt_dir import _equal, _f32, _file, dirs


@pytest.mark.parametrize("which", ["t5", "no_t5"])
def test_wan_t2v_loads_what_jax_loads(dirs, which):
    d = dirs[which]
    jpipe = JaxWanT2V(JAX_TINY, checkpoint_dir=d)
    pipe = WanT2V(TINY_TEST, device="cpu", checkpoint_dir=d)
    bf16 = lambda sd: {k: v.to(torch.bfloat16) for k, v in sd.items()}
    _equal(pipe.model.state_dict(), bf16(wan_dit_state_dict_from_jax(
        _f32(jpipe.params), TINY_TEST.model)), "DiT")
    _equal(pipe.model.state_dict(), bf16(_file(
        d, "diffusion_pytorch_model.safetensors")), "DiT file")
    _equal(pipe.vae.state_dict(), bf16(vae_state_dict_from_jax(
        _f32(jpipe.vae_params), TINY_TEST.vae)), "VAE")
    t5 = pipe.t5.state_dict()
    if which == "t5":
        _equal(t5, bf16(t5_state_dict_from_jax(_f32(jpipe.t5_params),
                                               TINY_TEST.t5)), "umT5")
        _equal(t5, bf16(_file(d, T5_CHECKPOINT)), "umT5 file")
    else:      # random from the init seed, as without a directory
        _equal(t5, build_t5_encoder(TINY_TEST.t5, "cpu", torch.bfloat16,
                                    seed=1000).state_dict(), "umT5 random")


def test_generate_from_the_directory_matches_jax(dirs):
    d = dirs["t5"]
    jpipe = JaxWanT2V(JAX_TINY, checkpoint_dir=d, param_dtype=jnp.float32)
    pipe = WanT2V(TINY_TEST, device="cpu", checkpoint_dir=d,
                  param_dtype=torch.float32)
    rng = np.random.default_rng(0)
    noise = rng.normal(size=(1, 16, 3, 8, 8)).astype(np.float32)
    ctx, ctx_null = ((rng.normal(size=(1, 16, 32)) * 0.5).astype(np.float32)
                     for _ in range(2))
    lens = np.array([7, 12], np.int32)
    kw = dict(seq_len=48, shift=5.0, solver="unipc", steps=3,
              guide_scale=5.0, num_train_timesteps=1000)
    want = jax_sample(jpipe.params, jnp.asarray(noise), jnp.asarray(ctx),
                      jnp.asarray(ctx_null), model_cfg=JAX_TINY.model,
                      policy=JaxPolicy(compute=jnp.float32),
                      patch_size=(1, 2, 2), context_lens=jnp.asarray(lens),
                      **kw)
    video_want = jax_vae_decode(jpipe.vae_params, want, JAX_TINY.vae,
                                streaming=True)
    with torch.inference_mode():
        got = sample(pipe.model, torch.from_numpy(noise),
                     torch.from_numpy(ctx), torch.from_numpy(ctx_null),
                     policy=DTypePolicy(compute=torch.float32),
                     solver="unipc", context_lens=torch.from_numpy(lens),
                     **{k: v for k, v in kw.items() if k != "solver"})
        video = vae_decode(pipe.vae, got, streaming=True)
    assert float(np.abs(np.asarray(want)).max()) > 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3)
    assert video.shape == (1, 3, 9, 64, 64)
    np.testing.assert_allclose(video.numpy(), np.asarray(video_want),
                               atol=1e-3)
