"""One-step (Seaweed-APT) inference (port of
omnihuman_tpu/pipelines/wan_inference.py).

Reference seaweed_apt/wan_inference.py:16-251 (`SeaweedWanAPTGenerator`):
encode the prompts, run ONE DiT forward at t = T (no CFG loop, no solver),
take x = noise - v, decode with the streaming VAE (K3 / K4 on the card),
with per-stage seconds. Batch serving stacks B prompts into one forward
and one decode.
"""

from __future__ import annotations

import math
import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from omnihuman_tpu_torch.models.vae import vae_decode
from omnihuman_tpu_torch.models.wan_dit import WanModel
from omnihuman_tpu_torch.ops.rope import rope_angles_3d
from omnihuman_tpu_torch.pipelines.text2video import WanT2V, _sync


def clip_noise(seed: int, index: int, shape, device) -> torch.Tensor:
    """The noise of clip `index` of a request with `seed`: a function of
    (seed, index) alone, never of the batch the clip rides in with (the
    JAX package folds the index into its key)."""
    gen = torch.Generator(device=device).manual_seed(
        (int(seed) * 1_000_003 + int(index)) % (2 ** 63))
    return torch.randn(tuple(shape), generator=gen, device=device,
                       dtype=torch.float32)


@torch.inference_mode()
def one_step_latents(model: WanModel, noise: torch.Tensor, context, *,
                     seq_len: int, rope_sin, rope_cos, policy,
                     t_final: float, context_lens=None) -> torch.Tensor:
    """x = noise - v(noise, t = T) (JAX _one_step, then noise - v)."""
    t = torch.full((noise.shape[0],), t_final, dtype=torch.float32,
                   device=noise.device)
    v = model(noise, t, context, seq_len=seq_len, rope_sin=rope_sin,
              rope_cos=rope_cos, policy=policy, context_lens=context_lens)
    return noise - v


class SeaweedWanAPTGenerator:
    """One-step text-to-video generator over a WanT2V pipeline (T5, VAE,
    config). `generator` is the one-step DiT; by default the pipeline's
    own, e.g. after loading a distilled / APT EMA state into it."""

    def __init__(self, pipe: WanT2V, generator: Optional[WanModel] = None):
        self.pipe = pipe
        self.config = pipe.config
        self.model = generator if generator is not None else pipe.model
        self.timings: dict = {}

    def generate(self, prompt: str, size: Tuple[int, int] = (832, 480),
                 frame_num: int = 1, seed: int = 0, **kw) -> torch.Tensor:
        """video [3, F, H, W] from one model forward."""
        out = self.generate_batch([prompt], size=size, frame_num=frame_num,
                                  seed=seed, **kw)
        return out[0]

    @torch.inference_mode()
    def generate_batch(self, prompts: Sequence[str],
                       size: Tuple[int, int] = (832, 480),
                       frame_num: int = 1, seed: int = 0,
                       context: Optional[torch.Tensor] = None,
                       context_lens: Optional[torch.Tensor] = None,
                       return_latents: bool = False) -> torch.Tensor:
        """videos [B, 3, F, H, W] for B prompts from one batched forward
        and one batched decode; clip i's noise is `clip_noise(seed, i)`."""
        cfg, pipe, dev = self.config, self.pipe, self.pipe.device
        timings: dict = {}
        t0 = time.perf_counter()
        if context is None:
            context, context_lens = pipe.encode_text(list(prompts))
        if context_lens is not None:
            longest = max(1, int(torch.as_tensor(context_lens).max()))
            bucket = int(math.ceil(longest / 128) * 128)
            if bucket < context.shape[1]:
                context = context[:, :bucket]
        _sync(dev)
        timings["text_encode_s"] = time.perf_counter() - t0

        lat_shape = pipe.latent_shape(size, frame_num)
        seq_len = pipe.seq_len_for(lat_shape)
        pt, ph, pw = cfg.model.patch_size
        grid = (lat_shape[1] // pt, lat_shape[2] // ph, lat_shape[3] // pw)
        sin, cos = rope_angles_3d(grid, cfg.model.head_dim, seq_len=seq_len,
                                  device=dev)
        seed = seed if seed >= 0 else int(np.random.randint(0, 2 ** 31))
        noise = torch.stack([clip_noise(seed, i, lat_shape, dev)
                             for i in range(context.shape[0])])

        t0 = time.perf_counter()
        latents = one_step_latents(
            self.model, noise, context, seq_len=seq_len, rope_sin=sin,
            rope_cos=cos, policy=pipe.policy,
            t_final=float(cfg.num_train_timesteps),
            context_lens=None if context_lens is None else torch.as_tensor(
                context_lens, device=dev).to(torch.int32))
        _sync(dev)
        timings["dit_s"] = time.perf_counter() - t0
        if return_latents:
            self.timings = timings
            return latents

        t0 = time.perf_counter()
        video = vae_decode(pipe.vae, latents, streaming=True)
        _sync(dev)
        timings["vae_decode_s"] = time.perf_counter() - t0
        timings["frames_per_sec"] = (video.shape[0] * video.shape[2]
                                     / sum(timings.values()))
        self.timings = timings
        return video
