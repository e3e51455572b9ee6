"""EMA evaluation of the one-step generator (port of
omnihuman_tpu/apt/eval_ema.py; reference seaweed_apt/eval_ema.py:39-247).

The generator (the pipeline's DiT, e.g. a distill EMA loaded into it)
regenerates one-step samples from the teacher artifact's cached noise and
contexts, x = z - v(z, t = T); the streaming VAE decodes them and the
teacher's x0 = noise - v_teacher; the first frames are written as images
and compared: PSNR and global SSIM in float64 numpy (data range 2), and
the latent MSE against the teacher's x0. On the card the forward runs K1
and the decodes K3 / K4 (a bf16 VAE, as every pipeline of the port loads
it).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from omnihuman_tpu_torch.apt.generate import load_teacher_data
from omnihuman_tpu_torch.models.vae import vae_decode
from omnihuman_tpu_torch.ops.rope import rope_angles_3d
from omnihuman_tpu_torch.pipelines.wan_inference import one_step_latents
from omnihuman_tpu_torch.utils.logging import logger
from omnihuman_tpu_torch.utils.media import cache_image


def psnr(a: np.ndarray, b: np.ndarray, data_range: float = 2.0) -> float:
    mse = float(np.mean(np.square(a.astype(np.float64) - b)))
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(data_range ** 2 / mse))


def ssim(a: np.ndarray, b: np.ndarray, data_range: float = 2.0) -> float:
    """Global SSIM (one window over the whole image), the reference's
    per-image scalar."""
    a = a.astype(np.float64)
    b = b.astype(np.float64)
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    mu_a, mu_b = a.mean(), b.mean()
    va, vb = a.var(), b.var()
    cov = ((a - mu_a) * (b - mu_b)).mean()
    return float(((2 * mu_a * mu_b + c1) * (2 * cov + c2))
                 / ((mu_a ** 2 + mu_b ** 2 + c1) * (va + vb + c2)))


@torch.inference_mode()
def evaluate_ema(pipe, data_path: str, num_samples: int = 10,
                 out_dir: str = "eval_images",
                 t_final: Optional[float] = None) -> Dict[str, float]:
    """One-step samples from the first `num_samples` cached noises and
    contexts of `data_path`, decoded and held against the teacher's x0
    (eval_ema.py:109-161); `pipe` is a WanT2V with the generator loaded.
    Writes `out_dir/eval_image_{i}.png` and returns the mean metrics."""
    cfg, dev = pipe.config, pipe.device
    data = load_teacher_data(data_path)
    os.makedirs(out_dir, exist_ok=True)
    t_final = float(t_final if t_final is not None
                    else cfg.num_train_timesteps)

    noise_np = data["noise"][:num_samples].astype(np.float32)
    noise = torch.from_numpy(noise_np).to(dev)
    ctx = torch.from_numpy(
        data["positive_contexts"][:num_samples].astype(np.float32)).to(dev)
    n, c, f, h, w = noise.shape
    pt, ph, pw = cfg.model.patch_size
    grid = (f // pt, h // ph, w // pw)
    seq_len = pipe.seq_len_for((c, f, h, w))
    sin, cos = rope_angles_3d(grid, cfg.model.head_dim, seq_len=seq_len,
                              device=dev)

    latents = one_step_latents(pipe.model, noise, ctx, seq_len=seq_len,
                               rope_sin=sin, rope_cos=cos, policy=cfg.policy,
                               t_final=t_final)
    videos = vae_decode(pipe.vae, latents, streaming=True)
    # the teacher's x0 = noise - v_teacher, decoded the same way
    x0_teacher = noise_np - data["v_teacher"][:num_samples]
    teacher_videos = vae_decode(pipe.vae, torch.from_numpy(x0_teacher).to(
        dev), streaming=True)

    first = videos[:, :, 0].float().cpu().numpy()     # [n, 3, H, W]
    first_t = teacher_videos[:, :, 0].float().cpu().numpy()
    psnrs, ssims = [], []
    for i in range(n):
        cache_image(first[i], os.path.join(out_dir, f"eval_image_{i}.png"))
        psnrs.append(psnr(first[i], first_t[i]))
        ssims.append(ssim(first[i], first_t[i]))

    metrics = {
        "psnr_vs_teacher": float(np.mean(psnrs)),
        "ssim_vs_teacher": float(np.mean(ssims)),
        "latent_mse_vs_teacher_x0": float(np.mean(np.square(
            latents.cpu().numpy() - x0_teacher))),
        "num_samples": n,
    }
    logger.info(f"EMA eval: {metrics}")
    return metrics
