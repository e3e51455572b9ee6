"""Teacher data for consistency distillation (port of
omnihuman_tpu/apt/generate.py).

Reference seaweed_apt/generate.py:143-300: encode N prompts with umT5
(the full padded [512, 4096] context, no lengths), draw per-sample seeded
noise [16, 1, 60, 104] (one latent frame at 480x832: 1,560 tokens), run
the teacher once at t = T - 1 = 999 with CFG 7.5,
    v_teacher = v_uncond + cfg * (v_cond - v_uncond),
and store {dummy_data, noise, dummy_prompts, positive_contexts,
negative_context, v_teacher} as `.npz`, the JAX package's keys and shapes;
`visualize_and_save_batch_with_vae` draws such a batch through the VAE.

The noise of sample i comes from a CPU torch.Generator seeded with
base_seed + i (the JAX package draws it with jax.random, which torch cannot
reproduce), so the artifact is the same whichever device runs the teacher.
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, List

import numpy as np
import torch

from omnihuman_tpu_torch.configs.wan import DTypePolicy, WanConfig
from omnihuman_tpu_torch.models.wan_dit import WanModel, latent_rope

# the JAX package's 100 procedural prompts (subjects x actions)
_SUBJECTS = [
    "a red fox", "an astronaut", "a street dancer", "a golden retriever",
    "a violinist", "a chef", "a surfer", "a calico cat", "a cyclist",
    "a painter",
]
_ACTIONS = [
    "running through a snowy forest", "walking on the moon",
    "performing under neon lights", "catching a frisbee mid-air",
    "playing in a rainy courtyard", "flipping a pancake in a busy kitchen",
    "riding a towering wave at sunset", "chasing a butterfly in a garden",
    "speeding down a mountain road", "sketching a city skyline at dawn",
]
RANDOM_PROMPTS: List[str] = [f"{s} {a}" for s in _SUBJECTS for a in _ACTIONS]
TEACHER_BATCH = 8   # samples in one teacher forward (cond + uncond: 2x)


@torch.no_grad()
def teacher_cfg_velocity(model: WanModel, noise, context, context_null, *,
                         seq_len: int, rope_sin, rope_cos, policy: DTypePolicy,
                         t_value: float, cfg_scale: float) -> torch.Tensor:
    """The teacher's CFG velocity at one timestep, cond and uncond stacked
    on the batch in one forward (JAX `teacher_cfg`): noise [B, C, F, H, W],
    context [B, L, text_dim], context_null [B, L, text_dim] -> fp32."""
    b = noise.shape[0]
    x2 = torch.cat([noise, noise], dim=0)
    c2 = torch.cat([context, context_null], dim=0)
    t2 = torch.full((2 * b,), t_value, dtype=torch.float32,
                    device=noise.device)
    v = model(x2, t2, c2, seq_len=seq_len, rope_sin=rope_sin,
              rope_cos=rope_cos, policy=policy)
    v_cond, v_uncond = v.chunk(2, dim=0)
    return v_uncond + cfg_scale * (v_cond - v_uncond)


def generate_batch(
    pipe,                       # pipelines.text2video.WanT2V
    num_samples: int = 100,
    size=(480, 832),
    base_seed: int = 0,
    cfg_scale: float = 7.5,
    out_dir: str = ".",
) -> Dict[str, np.ndarray]:
    """Build the teacher dataset for the first `num_samples` of
    RANDOM_PROMPTS, TEACHER_BATCH samples a forward; `size` is (H, W).
    Saved as `out_dir/dummy_data_{H}x{W}.npz`."""
    cfg: WanConfig = pipe.config
    dev = pipe.device
    prompts = RANDOM_PROMPTS[:num_samples]

    h, w = size
    target_shape = (cfg.vae.z_dim, 1, h // cfg.vae_stride[1],
                    w // cfg.vae_stride[2])
    geo = latent_rope(cfg.model, target_shape, dev)

    # no context_lens: the reference teacher sees the full padded context,
    # and the student is trained on the same artifact
    pos_ctx, _ = pipe.encode_text(prompts)
    neg_ctx, _ = pipe.encode_text([cfg.sample_neg_prompt])
    pipe.unload_t5()
    pos_ctx = pos_ctx.float()
    neg_ctx0 = neg_ctx[0].float()

    noise = torch.stack([
        torch.randn(target_shape, generator=torch.Generator().manual_seed(
            base_seed + i), dtype=torch.float32)
        for i in range(num_samples)])

    v_teacher = np.empty(noise.shape, np.float32)
    for i in range(0, num_samples, TEACHER_BATCH):
        nb = min(TEACHER_BATCH, num_samples - i)
        v = teacher_cfg_velocity(
            pipe.model, noise[i:i + nb].to(dev), pos_ctx[i:i + nb],
            neg_ctx0[None].expand(nb, -1, -1), **geo, policy=cfg.policy,
            t_value=float(cfg.num_train_timesteps - 1), cfg_scale=cfg_scale)
        v_teacher[i:i + nb] = v.cpu().numpy()

    data = {
        "dummy_data": noise.numpy(),      # the reference stores noise twice
        "noise": noise.numpy(),
        "dummy_prompts": np.asarray(prompts),
        "positive_contexts": pos_ctx.cpu().numpy(),
        "negative_context": neg_ctx0.cpu().numpy(),
        "v_teacher": v_teacher,
    }
    assert data["positive_contexts"].shape == (num_samples, cfg.text_len,
                                               cfg.t5.dim)
    os.makedirs(out_dir, exist_ok=True)
    np.savez(os.path.join(out_dir, f"dummy_data_{h}x{w}.npz"), **data)
    return data


def create_dataloader(data: Dict[str, np.ndarray], batch_size: int = 1,
                      shuffle: bool = True, seed: int = 0,
                      skip_epochs: int = 0, device="cpu"):
    """Batch iterator over the teacher dataset: `loader()` yields one
    epoch of {"noise", "context", "v_teacher"} tensors on `device`, the
    last partial batch dropped. The shuffle is numpy's, as in the JAX
    package, so both see the same order for a seed.

    skip_epochs: burn that many permutations, so a resumed run replays
    the shuffle of the epoch it was interrupted in."""
    n = data["noise"].shape[0]
    rng = np.random.default_rng(seed)
    for _ in range(skip_epochs):
        rng.permutation(n)

    def epoch() -> Iterator[Dict[str, torch.Tensor]]:
        idx = rng.permutation(n) if shuffle else np.arange(n)
        for i in range(0, n - batch_size + 1, batch_size):
            sel = idx[i:i + batch_size]
            yield {
                "noise": torch.from_numpy(data["noise"][sel]).to(device),
                "context": torch.from_numpy(
                    data["positive_contexts"][sel]).to(device),
                "v_teacher": torch.from_numpy(
                    data["v_teacher"][sel]).to(device),
            }

    return epoch


def load_teacher_data(path: str) -> Dict[str, np.ndarray]:
    return dict(np.load(path, allow_pickle=True))


@torch.no_grad()
def visualize_and_save_batch_with_vae(data, pipe, out_path: str =
                                      "teacher_data_viz.png",
                                      num_samples: int = 4) -> str:
    """Decode noise, v_teacher and x0 = noise - v_teacher with the
    pipeline's VAE and draw their first frames in a 3 x n panel (JAX
    apt/generate.py:164, reference generate.py:304-362). matplotlib is
    needed (utils/viz.pyplot)."""
    from omnihuman_tpu_torch.models.vae import vae_decode
    from omnihuman_tpu_torch.utils.viz import pyplot

    plt = pyplot()
    n = min(num_samples, data["noise"].shape[0])
    dev = pipe.device
    dt = pipe.vae.conv2.weight.dtype
    noise = torch.as_tensor(np.asarray(data["noise"][:n]), device=dev)
    v = torch.as_tensor(np.asarray(data["v_teacher"][:n]), device=dev)
    panels = []
    for name, lat in (("noise", noise), ("v_teacher", v),
                      ("x0", noise - v)):
        imgs = vae_decode(pipe.vae, lat.to(dt), streaming=True)
        panels.append((name, imgs[:, :, 0].float().cpu().numpy()))

    fig, axes = plt.subplots(3, n, figsize=(3 * n, 9), squeeze=False)
    for r, (name, imgs) in enumerate(panels):
        for c in range(n):
            img = np.clip(imgs[c].transpose(1, 2, 0) * 0.5 + 0.5, 0, 1)
            axes[r][c].imshow(img)
            axes[r][c].set_axis_off()
            if c == 0:
                axes[r][c].set_title(name, loc="left")
    fig.tight_layout()
    fig.savefig(out_path, dpi=100)
    plt.close(fig)
    return out_path
