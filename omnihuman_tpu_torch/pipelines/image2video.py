"""Image-to-video generation pipeline (port of
omnihuman_tpu/pipelines/image2video.py).

Reference wan/image2video.py:129-350 (`WanI2V`): the latent size follows
`max_area` and the image's aspect ratio, snapped to patch multiples; the
first-frame mask (frame 0 = 1, grouped 4 to a latent frame) and the VAE
latent of [image, frame_num - 1 zero frames] make the 20-channel
conditioning y; CLIP's 257 image tokens join the text context inside the
DiT; UniPC / DPM++ steps with classifier-free guidance run as in WanT2V,
and the streaming VAE decodes.

On the card the VAE encode and decode run the K3 / K4 kernels and every
DiT attention (self, text and image cross-attention) the K1 kernel.
"""

from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np
import torch

from omnihuman_tpu_torch.configs.wan import WanConfig
from omnihuman_tpu_torch.models.clip import CLIPModel, resize_bicubic
from omnihuman_tpu_torch.models.vae import vae_decode, vae_encode
from omnihuman_tpu_torch.pipelines.text2video import WanT2V, _sync, sample


class WanI2V(WanT2V):
    """WanT2V with the CLIP image encoder and the mask + reference-latent
    conditioning; weights random from `init_seed` (CLIP from
    init_seed + 2)."""

    def __init__(self, config: WanConfig, init_seed: int = 0,
                 param_dtype: torch.dtype = torch.bfloat16, tokenizer=None,
                 precision: str = "reference", device=None):
        if config.clip is None:
            raise ValueError(f"{config.name}: i2v needs a CLIP config")
        super().__init__(config, init_seed=init_seed, param_dtype=param_dtype,
                         tokenizer=tokenizer, precision=precision,
                         device=device)
        self.clip = CLIPModel(config.clip, self.device, seed=init_seed + 2)

    def latent_size_for(self, img_hw: Tuple[int, int],
                        max_area: int) -> Tuple[int, int]:
        """(lat_h, lat_w) snapped to patch multiples (image2video.py:180-190)."""
        h, w = img_hw
        ar = h / w
        lat_h = int(round(np.sqrt(max_area * ar) // self.vae_stride[1]
                          // self.patch_size[1] * self.patch_size[1]))
        lat_w = int(round(np.sqrt(max_area / ar) // self.vae_stride[2]
                          // self.patch_size[2] * self.patch_size[2]))
        return lat_h, lat_w

    @staticmethod
    def first_frame_mask(frame_num: int, lat_h: int, lat_w: int,
                         device=None) -> torch.Tensor:
        """[4, F_lat, lat_h, lat_w] fp32: frame 0 repeated 4 times, then
        every 4 frames grouped into one latent frame (image2video.py:208-216)."""
        msk = torch.zeros((frame_num + 3, lat_h, lat_w), device=device)
        msk[:4] = 1.0
        return msk.reshape(-1, 4, lat_h, lat_w).transpose(0, 1)

    @torch.inference_mode()
    def generate(
        self,
        input_prompt: str,
        img,
        max_area: int = 720 * 1280,
        frame_num: int = 81,
        shift: float = 5.0,
        sample_solver: str = "unipc",
        sampling_steps: int = 40,
        guide_scale: float = 5.0,
        n_prompt: str = "",
        seed: int = -1,
        context: Optional[torch.Tensor] = None,
        context_null: Optional[torch.Tensor] = None,
        context_lens: Optional[torch.Tensor] = None,
        return_latents: bool = False,
        cfg_mode: str = "fused",
    ) -> torch.Tensor:
        """One clip from an image [3, H, W] in [-1, 1]: video [3, F, h, w]
        in [-1, 1] (reference WanI2V.generate). Stage seconds of the call
        are left in `self.timings`."""
        cfg, dev = self.config, self.device
        seed = seed if seed >= 0 else int(np.random.randint(0, 2 ** 31))
        timings: dict = {}
        context, context_null, context_lens = self.text_context(
            input_prompt, n_prompt, context, context_null, context_lens,
            timings)

        img = torch.as_tensor(np.asarray(img) if not torch.is_tensor(img)
                              else img, dtype=torch.float32, device=dev)
        lat_h, lat_w = self.latent_size_for(tuple(img.shape[1:]), max_area)
        h, w = lat_h * self.vae_stride[1], lat_w * self.vae_stride[2]
        f_lat = (frame_num - 1) // self.vae_stride[0] + 1

        t0 = time.perf_counter()
        clip_fea = self.clip.visual(img[None])
        _sync(dev)
        timings["clip_s"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        img_r = resize_bicubic(img[None], (h, w))
        vid = torch.cat([img_r[:, :, None],
                         torch.zeros((1, 3, frame_num - 1, h, w), device=dev)],
                        dim=2)
        ref_lat = vae_encode(self.vae, vid, streaming=True)[0]
        y = torch.cat([self.first_frame_mask(frame_num, lat_h, lat_w, dev),
                       ref_lat.float()], dim=0)[None]
        _sync(dev)
        timings["vae_encode_s"] = time.perf_counter() - t0

        lat_shape = (cfg.vae.z_dim, f_lat, lat_h, lat_w)
        seq_len = self.seq_len_for(lat_shape)
        gen = torch.Generator(device=dev).manual_seed(seed)
        noise = torch.randn((1,) + lat_shape, generator=gen, device=dev,
                            dtype=torch.float32)

        t0 = time.perf_counter()
        latents = sample(
            self.model, noise, context, context_null, policy=self.policy,
            seq_len=seq_len, shift=shift, solver=sample_solver,
            steps=sampling_steps, guide_scale=guide_scale,
            num_train_timesteps=cfg.num_train_timesteps, cfg_mode=cfg_mode,
            context_lens=context_lens, y=y, clip_fea=clip_fea)
        _sync(dev)
        timings["denoise_s"] = time.perf_counter() - t0
        timings["steps"] = sampling_steps
        self.timings = timings
        if return_latents:
            return latents
        t0 = time.perf_counter()
        video = vae_decode(self.vae, latents, streaming=True)
        _sync(dev)
        timings["vae_decode_s"] = time.perf_counter() - t0
        return video[0]
