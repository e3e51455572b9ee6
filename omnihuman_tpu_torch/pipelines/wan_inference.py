"""One-step (Seaweed-APT) inference (port of
omnihuman_tpu/pipelines/wan_inference.py).

Reference seaweed_apt/wan_inference.py:16-251 (`SeaweedWanAPTGenerator`):
encode the prompts, run ONE DiT forward at t = T (no CFG loop, no solver),
take x = noise - v, decode with the streaming VAE (K3 / K4 on the card),
with per-stage seconds and, under a profiler, the spans of the request
(`utils/spans.py`). Batch serving stacks B prompts into one forward
and one decode.

On a pipeline with a mesh (JAX `:108-157`), every rank runs the forward
with the pipeline's plan (the ring and sp_cross on its 1/sp of the
tokens, FSDP2's shards of the DiT) and then decodes with W sharded over
the whole world, data x fsdp x sp (JAX's `P(None, None, None,
mesh.axis_names, None)`): each rank decodes its columns of the latent
with K3 / K4 on the halo-extended shards, and the video is all-gathered,
so every rank returns the whole of it, as JAX returns its global array.
Serving runs under `torch.no_grad` (FSDP2 refuses inference tensors).
"""

from __future__ import annotations

import math
import time
from typing import Optional, Sequence, Tuple

import torch

from omnihuman_tpu_torch.models.vae import vae_decode
from omnihuman_tpu_torch.models.wan_dit import WanModel, latent_rope
from omnihuman_tpu_torch.parallel.mesh import use_mesh
from omnihuman_tpu_torch.pipelines.text2video import WanT2V, request_seed
from omnihuman_tpu_torch.utils.spans import span, stage


def clip_noise(seed: int, index: int, shape, device) -> torch.Tensor:
    """The noise of clip `index` of a request with `seed`: a function of
    (seed, index) alone, never of the batch the clip rides in with (the
    JAX package folds the index into its key)."""
    gen = torch.Generator(device=device).manual_seed(
        (int(seed) * 1_000_003 + int(index)) % (2 ** 63))
    return torch.randn(tuple(shape), generator=gen, device=device,
                       dtype=torch.float32)


@torch.no_grad()
def one_step_latents(model: WanModel, noise: torch.Tensor, context, *,
                     seq_len: int, rope_sin, rope_cos, policy,
                     t_final: float, context_lens=None,
                     mesh=None) -> torch.Tensor:
    """x = noise - v(noise, t = T) (JAX _one_step, then noise - v); with
    `mesh`, the forward runs under it (`WanModel.body`)."""
    t = torch.full((noise.shape[0],), t_final, dtype=torch.float32,
                   device=noise.device)
    with use_mesh(mesh):
        v = model(noise, t, context, seq_len=seq_len, rope_sin=rope_sin,
                  rope_cos=rope_cos, policy=policy, context_lens=context_lens)
    return noise - v


def world_group(mesh):
    """The group a mesh pipeline's decode shards W over: the whole world
    the mesh spans, ranks in the mesh's (data, fsdp, sp) order."""
    import torch.distributed as dist
    if mesh.size() != dist.get_world_size():
        raise ValueError(f"the mesh holds {mesh.size()} of the world's "
                         f"{dist.get_world_size()} ranks; the decode shards "
                         "over the whole world")
    return dist.group.WORLD


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

    @torch.no_grad()
    def generate_batch(self, prompts: Sequence[str],
                       size: Tuple[int, int] = (832, 480),
                       frame_num: int = 1, seed: int = 0,
                       context: Optional[torch.Tensor] = None,
                       context_lens: Optional[torch.Tensor] = None,
                       return_latents: bool = False) -> torch.Tensor:
        """videos [B, 3, F, H, W] for B prompts from one batched forward
        and one batched decode; clip i's noise is `clip_noise(seed, i)`.
        On a mesh pipeline every rank calls it with the same arguments
        (module docstring)."""
        cfg, pipe, dev = self.config, self.pipe, self.pipe.device
        seed = request_seed(seed, pipe.mesh)
        timings: dict = {}
        with span("request", seed=seed, batch=len(prompts)):
            t_request = time.perf_counter()
            with stage("text_encode_s", timings, dev):
                if context is None:
                    context, context_lens = pipe.encode_text(list(prompts))
                if context_lens is not None:
                    with span("trim"):
                        longest = max(1, int(torch.as_tensor(
                            context_lens).max()))
                        bucket = int(math.ceil(longest / 128) * 128)
                        if bucket < context.shape[1]:
                            context = context[:, :bucket]

            with span("prep"):
                lat_shape = pipe.latent_shape(size, frame_num)
                geo = latent_rope(cfg.model, lat_shape, dev, sp=pipe.sp_size)
                noise = torch.stack([clip_noise(seed, i, lat_shape, dev)
                                     for i in range(context.shape[0])])

            with stage("dit_s", timings, dev, tokens=geo["seq_len"]):
                latents = one_step_latents(
                    self.model, noise, context, **geo, policy=pipe.policy,
                    t_final=float(cfg.num_train_timesteps),
                    context_lens=None if context_lens is None
                    else torch.as_tensor(context_lens,
                                         device=dev).to(torch.int32),
                    mesh=pipe.mesh)
            if return_latents:
                self.timings = timings
                return latents

            with stage("vae_decode_s", timings, dev):
                video = vae_decode(pipe.vae, latents, streaming=True,
                                   spatial=None if pipe.mesh is None
                                   else world_group(pipe.mesh))
        # frames over the request's wall time, on the stages' clock
        timings["frames_per_sec"] = (video.shape[0] * video.shape[2]
                                     / (time.perf_counter() - t_request))
        self.timings = timings
        return video
