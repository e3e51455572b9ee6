"""OmniHuman sampling (port of omnihuman_tpu/pipelines/omni.py): CFG-annealed
flow sampling, chained window by window through motion tokens, and the
`OmniHuman` pipeline that serves it (T5, reference encode, denoise,
decode).

`omni_generate`: DPM++ (shift 1.0 by default) with classifier-free
guidance annealed from `cfg_scale` to 1, cfg_t = cfg * (1 - i/steps) +
i/steps (reference omnihuman_wan_t2v.py:432-438). CFG is sequential: the
unconditional forward sees only the negative prompt's context, with no
audio, pose, reference or motion tokens, so its packed length differs
from the conditional one.

`omni_generate_windowed`: window k+1 packs the last `motion_frames`
latent frames of window k as motion tokens; the per-frame audio and pose
tracks are cut per window, repeating their last frame when they run out;
the result is trimmed to `total_frames`. Each window's noise is drawn by
`window_noise` from a torch.Generator seeded by (seed, window).

One GPU: no mesh (sequence parallelism is ROADMAP queue A, item 19). On
the card every attention of the DiT (packed self-attention, text and
audio cross-attention) runs the K1 kernel and the VAE encode / decode the
K3 / K4 kernels.
"""

from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np
import torch

from omnihuman_tpu_torch.configs.wan import DTypePolicy, WanConfig
from omnihuman_tpu_torch.models.vae import vae_decode, vae_encode
from omnihuman_tpu_torch.omni.model import (
    OmniModel, OmniModelConfig, build_omni_model, omni_model_forward)
from omnihuman_tpu_torch.pipelines.text2video import WanT2V, _sync
from omnihuman_tpu_torch.samplers.fm_solvers import get_solver


def window_noise(seed: int, window: int, shape, device) -> torch.Tensor:
    """The fp32 noise of window `window` of a request with `seed`: a
    function of (seed, window) alone."""
    gen = torch.Generator(device=device).manual_seed(
        (int(seed) * 1_000_003 + int(window)) % (2 ** 63))
    return torch.randn(tuple(shape), generator=gen, device=device,
                       dtype=torch.float32)


@torch.inference_mode()
def omni_generate(
    model: OmniModel,
    noise: torch.Tensor,                  # [B, C, F, H, W] fp32
    context: torch.Tensor,                # [B, Lc, text_dim]
    context_null: torch.Tensor,
    *,
    policy: DTypePolicy = DTypePolicy(),
    sampling_steps: int = 25,
    cfg_scale: float = 7.5,
    solver: str = "dpm++",
    shift: float = 1.0,
    audio: Optional[torch.Tensor] = None,
    pose: Optional[torch.Tensor] = None,
    ref_latent: Optional[torch.Tensor] = None,
    motion_latent: Optional[torch.Tensor] = None,
    context_lens: Optional[torch.Tensor] = None,
    null_lens: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Sampled latents [B, C, F, H, W] fp32 from `noise` (JAX
    `omni_generate`), one conditional and one unconditional forward a
    step."""
    sol = get_solver(solver, sampling_steps, float(shift))
    b = noise.shape[0]
    x = noise
    state = sol.init_state(noise)
    for i in range(sampling_steps):
        # the JAX float32 arithmetic of the annealed scale
        progress = np.float32(i) / np.float32(sampling_steps)
        cfg_t = (np.float32(cfg_scale) * (np.float32(1.0) - progress)
                 + progress)
        tb = torch.full((b,), float(np.float32(sol.timesteps[i])),
                        dtype=torch.float32, device=noise.device)
        v_c = omni_model_forward(
            model, x, tb, context, audio=audio, pose=pose,
            ref_latent=ref_latent, motion_latent=motion_latent,
            context_lens=context_lens, policy=policy)
        v_u = omni_model_forward(model, x, tb, context_null,
                                 context_lens=null_lens, policy=policy)
        v = v_u + float(cfg_t) * (v_c - v_u)
        x, state = sol.step(state, v, x, i)
    return x


def _slice_frames(x: torch.Tensor, dim: int, start: int,
                  f_win: int) -> torch.Tensor:
    """x[start:start + f_win] along `dim`, repeating the last frame when
    the track runs out before the window ends."""
    n = x.shape[dim]
    take = min(f_win, max(0, n - start))
    sl = x.narrow(dim, min(start, n), take)
    if take < f_win:
        last = x.narrow(dim, n - 1, 1)
        reps = [1] * x.dim()
        reps[dim] = f_win - take
        sl = torch.cat([sl, last.repeat(*reps)], dim=dim)
    return sl


@torch.inference_mode()
def omni_generate_windowed(
    model: OmniModel,
    seed: int,
    *,
    latent_shape: Tuple[int, int, int, int, int],   # (B, C, F_win, H, W)
    context: torch.Tensor,
    context_null: torch.Tensor,
    total_frames: int,                    # latent frames wanted
    motion_frames: int = 2,
    audio: Optional[torch.Tensor] = None,  # [B, F_total(+), audio_dim]
    pose: Optional[torch.Tensor] = None,   # [B, K, F_total(+), 2h, 2w]
    ref_latent: Optional[torch.Tensor] = None,
    timings: Optional[dict] = None,
    **gen_kw,
) -> torch.Tensor:
    """Latents [B, C, total_frames, H, W] (JAX `omni_generate_windowed`).
    Every window has `latent_shape`'s F_win frames. Seconds of each
    window's denoise go to `timings["windows_s"]` when a dict is given."""
    f_win = latent_shape[2]
    device = next(model.parameters()).device
    win_s = [] if timings is None else timings.setdefault("windows_s", [])
    if total_frames > f_win and not 0 < motion_frames < f_win:
        raise ValueError(f"motion_frames {motion_frames} must be in "
                         f"(0, window {f_win})")
    clips = []
    motion = None
    start = 0
    widx = 0
    while start < total_frames:
        t0 = time.perf_counter()
        noise = window_noise(seed, widx, latent_shape, device)
        lat = omni_generate(
            model, noise, context, context_null,
            audio=None if audio is None else _slice_frames(audio, 1, start,
                                                           f_win),
            pose=None if pose is None else _slice_frames(pose, 2, start,
                                                         f_win),
            ref_latent=ref_latent, motion_latent=motion, **gen_kw)
        _sync(device)
        win_s.append(time.perf_counter() - t0)
        clips.append(lat)
        motion = lat[:, :, -motion_frames:]
        start += f_win
        widx += 1
    return torch.cat(clips, dim=2)[:, :, :total_frames]


class OmniHuman(WanT2V):
    """The OmniHuman serving pipeline: WanT2V's umT5 (on the card only
    while encoding), VAE and text handling around the omni DiT, random
    weights from `init_seed`. `num_frames`: latent frames a window (the
    temporal embedding's rows)."""

    def __init__(self, config: WanConfig, num_frames: int = 13,
                 init_seed: int = 0,
                 param_dtype: torch.dtype = torch.bfloat16, tokenizer=None,
                 precision: str = "fast", device=None):
        self.omni_config = OmniModelConfig(base=config.model,
                                           num_frames=num_frames)
        super().__init__(config, init_seed=init_seed,
                         param_dtype=param_dtype, tokenizer=tokenizer,
                         precision=precision, device=device)

    def _build_model(self) -> OmniModel:
        return build_omni_model(self.omni_config, self.device,
                                self.param_dtype, seed=self._init_seed)

    @torch.inference_mode()
    def generate(
        self,
        input_prompt: str,
        ref_image,                         # [3, H, W] in [-1, 1]
        *,
        audio=None,                        # [F_total, audio_dim]
        pose=None,                         # [K, F_total, 2h, 2w]
        num_frames: int = 13,
        total_frames: Optional[int] = None,
        motion_frames: int = 2,
        sampling_steps: int = 25,
        cfg_scale: float = 7.5,
        seed: int = 42,
        n_prompt: str = "",
    ) -> torch.Tensor:
        """One conditioned clip: video [3, 1 + 4 (total_frames - 1), H, W]
        in [-1, 1] (the JAX omni CLI's generation steps). The output size
        is the reference image's. Stage seconds go to `self.timings`."""
        dev = self.device
        timings: dict = {}
        context, context_null, lens = self.text_context(
            input_prompt, n_prompt, None, None, None, timings)
        ref = torch.as_tensor(np.asarray(ref_image) if not
                              torch.is_tensor(ref_image) else ref_image,
                              dtype=torch.float32, device=dev)
        _, h_px, w_px = ref.shape
        lat_h, lat_w = h_px // self.vae_stride[1], w_px // self.vae_stride[2]
        f_total = total_frames or num_frames

        t0 = time.perf_counter()
        ref_lat = vae_encode(self.vae, ref[None, :, None], streaming=True)
        ref_lat = ref_lat.float()
        _sync(dev)
        timings["ref_encode_s"] = time.perf_counter() - t0

        def track(a):
            return (None if a is None else torch.as_tensor(
                np.asarray(a) if not torch.is_tensor(a) else a,
                dtype=torch.float32, device=dev)[None])

        t0 = time.perf_counter()
        latents = omni_generate_windowed(
            self.model, seed,
            latent_shape=(1, self.config.vae.z_dim, num_frames, lat_h,
                          lat_w),
            context=context, context_null=context_null,
            total_frames=f_total, motion_frames=motion_frames,
            audio=track(audio), pose=track(pose), ref_latent=ref_lat,
            timings=timings, policy=self.policy,
            sampling_steps=sampling_steps, cfg_scale=cfg_scale, shift=1.0,
            context_lens=lens[:1], null_lens=lens[1:])
        _sync(dev)
        timings["denoise_s"] = time.perf_counter() - t0
        timings["steps"] = sampling_steps
        self.timings = timings
        t0 = time.perf_counter()
        video = vae_decode(self.vae, latents, streaming=True)
        _sync(dev)
        timings["vae_decode_s"] = time.perf_counter() - t0
        return video[0]
