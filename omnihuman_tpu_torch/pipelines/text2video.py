"""Text-to-video generation pipeline (port of omnihuman_tpu/pipelines/text2video.py).

Reference wan/text2video.py:28-269 (`WanT2V`): umT5 encodes the prompt and
the negative prompt, the encoder is freed, the context is trimmed to a
128-token bucket, flow-matching UniPC / DPM++ steps with classifier-free
guidance run one DiT forward each (cond and uncond batched, or one after
the other), and the streaming causal VAE decodes.

Every attention of the DiT runs on the hand-written Hopper kernel when the
pipeline lives on a CUDA device. The pipeline runs on the card unless the
caller asks for the CPU (`device="cpu"`, as the tests do); without a GPU
the default raises.

With `mesh` (parallel/mesh.py, one process per GPU, every rank calling
`generate` with the same arguments) the pipeline runs JAX's mesh plan
(text2video.py:85-107): self-attention as the ring at any sp (sp 1
included), cross-attention as sp_cross, the tokens sharded over `sp`
(`WanModel.body`), the DiT and umT5 parameters sharded over `fsdp` by
FSDP2 (`parallel.shard_params`, the int8 weights included); umT5 stays on
the card between requests; the VAE stays whole on every rank and each
rank decodes the whole clip (JAX's t2v decode is unsharded too; the
one-step generator's decode shards W, pipelines/wan_inference.py).
The noise comes from the same seeded generator on every rank (a random
seed is rank 0's). Serving runs under `torch.no_grad`, with or without a
mesh: FSDP2's gathers refuse inference tensors, and `torch.export`
(cli/export_step.py) does too.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from omnihuman_tpu_torch.configs.wan import DTypePolicy, WanConfig, WanModelConfig
from omnihuman_tpu_torch.models.t5 import load_t5_encoder
from omnihuman_tpu_torch.models.tokenizers import HuggingfaceTokenizer
from omnihuman_tpu_torch.models.vae import build_vae, vae_decode
from omnihuman_tpu_torch.models.wan_dit import (
    WanModel, build_wan_model, padded_seq_len)
from omnihuman_tpu_torch.ops.quant import quantize_wan_model
from omnihuman_tpu_torch.ops.rope import rope_angles_3d
from omnihuman_tpu_torch.parallel.mesh import AXIS_SP, use_mesh
from omnihuman_tpu_torch.parallel.partition import shard_params
from omnihuman_tpu_torch.samplers.fm_solvers import get_solver
from omnihuman_tpu_torch.utils.convert import load_wan_checkpoint_dir
from omnihuman_tpu_torch.utils.spans import span, stage


def resolve_device(device=None) -> torch.device:
    """`None` means the GPU; a missing GPU is an error, never a silent CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the GPU; pass "
                "device='cpu' explicitly to run on the host")
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is absent")
    return device


def serving_policy(config: WanConfig, precision: str) -> DTypePolicy:
    """The dtype policy of a serving precision: "reference" is the
    config's (the fp32 residual the torch reference keeps,
    model.py:287-296); "fast" a bf16 residual stream; "int8" is "fast"
    with the DiT's block GEMMs in W8A8 (ops/quant.py), serving only."""
    if precision not in ("reference", "fast", "int8"):
        raise ValueError(f"unknown precision {precision!r}; "
                         "supported: 'reference', 'fast', 'int8'")
    if precision == "reference":
        return config.policy
    return dataclasses.replace(config.policy, residual=torch.bfloat16)


def mesh_plan(mesh):
    """(attn_impl, token_sharding, sp) of an optional mesh: any mesh runs
    the ring with the tokens on `mesh["sp"]` (JAX WanT2V), and pads them to
    a multiple of sp."""
    if mesh is None:
        return "auto", None, 1
    return "ring", mesh[AXIS_SP], int(mesh[AXIS_SP].size())


def request_seed(seed: int, mesh=None) -> int:
    """`seed`, or a random one when it is negative: rank 0's under a mesh,
    so every rank draws the same noise."""
    if seed >= 0:
        return seed
    seed = int(np.random.randint(0, 2 ** 31))
    if mesh is not None:
        import torch.distributed as dist
        box = [seed]
        dist.broadcast_object_list(box, src=0)
        seed = int(box[0])
    return seed


class WanT2V:
    """Wan text-to-video pipeline. Every module keeps the reference
    parameter names. With `checkpoint_dir` (the reference layout, JAX
    `WanT2V._load_checkpoint`) the DiT comes from its `*.safetensors`
    files, the VAE from `Wan2.1_VAE.pth` (required) and umT5 from
    `models_t5_umt5-xxl-enc-bf16.pth` where present, each cast to
    `param_dtype`; whatever the directory does not give is random from
    `init_seed`. `generator_ckpt`: a distill / APT training directory
    whose latest EMA (the one-step generator) replaces the DiT's weights
    before any int8 quantisation and sharding. `mesh`: the multi-GPU plan
    (module docstring); `precision="int8"` shards the int8 weights over
    fsdp too (ops/quant.py)."""

    # a checkpoint directory without Wan2.1_VAE.pth is an error (JAX
    # WanT2V); OmniHuman builds a random VAE instead
    vae_file_required = True

    def __init__(
        self,
        config: WanConfig,
        init_seed: int = 0,
        param_dtype: torch.dtype = torch.bfloat16,
        tokenizer: Optional[HuggingfaceTokenizer] = None,
        precision: str = "reference",
        device=None,
        checkpoint_dir: Optional[str] = None,
        mesh=None,
        generator_ckpt: Optional[str] = None,
    ):
        self.policy = serving_policy(config, precision)
        self.device = resolve_device(device)
        self.mesh = mesh
        self.attn_impl, _, self.sp_size = mesh_plan(mesh)
        # JAX's t5_auto_unload: a mesh keeps umT5 on the card
        self.t5_auto_unload = mesh is None
        self.config = config
        self.param_dtype = param_dtype
        self.precision = precision
        self.vae_stride = config.vae_stride
        self.patch_size = config.model.patch_size
        self._init_seed = init_seed
        self.checkpoint_dir = checkpoint_dir
        self._dit_sd = vae = None
        if checkpoint_dir is not None:
            self._dit_sd, vae = load_wan_checkpoint_dir(
                checkpoint_dir, config.model, config.vae,
                vae_seed=None if self.vae_file_required else init_seed + 1,
                device=self.device, dtype=param_dtype)
        self.model = self._build_model()
        if generator_ckpt is not None:
            from omnihuman_tpu_torch.utils.checkpoint import restore_ema_into
            restore_ema_into(self.model, generator_ckpt)
        if precision == "int8":     # after the weights are final
            quantize_wan_model(self.model)
        if mesh is not None:
            shard_params(self.model, mesh)
        self.vae = vae if vae is not None else build_vae(
            config.vae, self.device, param_dtype, seed=init_seed + 1)
        # umT5 is built lazily on first encode and moved to host memory
        # after it: the card need not hold the encoder through the denoise
        # loop (text2video.py:274-278)
        self._t5 = None
        self.tokenizer = tokenizer
        self.timings: dict = {}

    def _build_model(self) -> WanModel:
        """The denoiser: the checkpoint's DiT, else random from the init
        seed (a subclass builds another)."""
        if self.checkpoint_dir is not None and self._dit_sd is None:
            raise FileNotFoundError(
                f"no *.safetensors in {self.checkpoint_dir}")
        model = build_wan_model(
            self.config.model, self.device, self.param_dtype,
            seed=self._init_seed if self._dit_sd is None else None)
        if self._dit_sd is not None:
            model.load_state_dict(self._dit_sd, strict=True)
            self._dit_sd = None
        return model

    def _build_t5(self):
        """The umT5 encoder: the checkpoint directory's umT5 file where it
        has one, else random from the init seed."""
        return load_t5_encoder(self.config.t5, self.checkpoint_dir,
                               self.device, self.param_dtype,
                               seed=self._init_seed + 1000)

    # -- text encoding ------------------------------------------------------

    @property
    def t5(self):
        """The umT5 encoder on the pipeline's device: built from the seed on
        first use, brought back from host memory after `unload_t5`."""
        if self._t5 is None:
            self._t5 = self._build_t5()
            if self.mesh is not None:
                shard_params(self._t5, self.mesh)
        elif next(self._t5.parameters()).device != self.device:
            self._t5.to(self.device)
        return self._t5

    def unload_t5(self) -> None:
        """Move the encoder's weights to host memory (the reference's
        offload_model, text2video.py:172-182), whatever weights it holds;
        the `t5` property moves them back. The host copies are pinned, so
        both copies run at DMA speed, and PyTorch's pinned-memory cache
        hands the same blocks back on every later unload."""
        if self._t5 is None or self.device.type == "cpu":
            return
        for p in self._t5.parameters():
            host = torch.empty(p.shape, dtype=p.dtype, pin_memory=True)
            host.copy_(p.data)
            p.data = host
        torch.cuda.empty_cache()

    def _get_tokenizer(self) -> HuggingfaceTokenizer:
        if self.tokenizer is None:
            self.tokenizer = HuggingfaceTokenizer(
                name=self.config.t5_tokenizer, seq_len=self.config.text_len,
                clean="whitespace")
        return self.tokenizer

    @torch.no_grad()
    def encode_text(self, prompts) -> Tuple[torch.Tensor, torch.Tensor]:
        """[prompts] -> (context [B, text_len, t5.dim] fp32, lens [B] int32)."""
        with span("tokenize", batch=len(prompts)):
            ids, mask = self._get_tokenizer()(prompts, return_mask=True)
        with span("t5", tokens=int(mask.sum())):
            ids_t = torch.from_numpy(ids).to(self.device)
            mask_t = torch.from_numpy(mask).to(self.device)
            ctx = self.t5(ids_t, mask_t)
            lens = mask_t.sum(dim=-1).to(torch.int32)
        return ctx, lens

    # -- geometry -----------------------------------------------------------

    def latent_shape(self, size: Tuple[int, int], frame_num: int):
        """(C, F, H, W) of the latent for a (W, H) pixel size."""
        w, h = size
        f = (frame_num - 1) // self.vae_stride[0] + 1
        return (self.config.vae.z_dim, f,
                h // self.vae_stride[1], w // self.vae_stride[2])

    def seq_len_for(self, latent_shape) -> int:
        """Padded token length of a latent (`wan_dit.padded_seq_len` at the
        pipeline's sp degree)."""
        _, f, h, w = latent_shape
        pt, ph, pw = self.patch_size
        return padded_seq_len((f // pt) * (h // ph) * (w // pw),
                              self.sp_size)

    # -- generation ---------------------------------------------------------

    def text_context(self, prompt: str, n_prompt: str, context, context_null,
                     context_lens, timings: dict):
        """(context, context_null, lens) of a request: umT5 encodes the
        prompt and the negative prompt unless the caller gives contexts,
        the encoder then moves to host memory; a padded context is trimmed
        to a 128-bucket of the longest prompt (masked context columns
        contribute nothing, so this is exact). Stage seconds go to
        `timings`."""
        dev = self.device
        if n_prompt == "":
            n_prompt = self.config.sample_neg_prompt
        if context is None:
            with stage("t5_load_s", timings, dev):
                self._get_tokenizer()
                self.t5                  # built, or brought back to the card
            with stage("t5_encode_s", timings, dev):
                context, lens_c = self.encode_text([prompt])
                context_null, lens_n = self.encode_text([n_prompt])
                context_lens = torch.cat([lens_c, lens_n])
            if self.t5_auto_unload:
                with stage("t5_unload_s", timings, None):
                    self.unload_t5()
        if context_lens is not None:
            with span("trim"):
                longest = max(1, int(torch.as_tensor(context_lens).max()))
                bucket = int(math.ceil(longest / 128) * 128)
                if bucket < context.shape[1]:
                    context = context[:, :bucket]
                    context_null = context_null[:, :bucket]
        return context, context_null, context_lens

    @torch.no_grad()
    def generate(
        self,
        input_prompt: str,
        size: Tuple[int, int] = (832, 480),
        frame_num: int = 81,
        shift: float = 5.0,
        sample_solver: str = "unipc",
        sampling_steps: int = 50,
        guide_scale: float = 5.0,
        n_prompt: str = "",
        seed: int = -1,
        context: Optional[torch.Tensor] = None,
        context_null: Optional[torch.Tensor] = None,
        context_lens: Optional[torch.Tensor] = None,
        return_latents: bool = False,
        cfg_mode: str = "fused",
    ) -> torch.Tensor:
        """One clip: video [3, F, H, W] in [-1, 1] (reference
        WanT2V.generate, text2video.py:112-269). The noise comes from a
        torch.Generator seeded by `seed` (-1: a random seed). Stage times
        of the call are left in `self.timings` (seconds).

        `cfg_mode` "fused" batches cond and uncond in one DiT forward;
        "sequential" runs two and lowers the activation peak, for a card
        with less memory: on an 80 GB H100 fused fits at t2v-14B 720p and
        takes as long (PERF.md)."""
        cfg = self.config
        dev = self.device
        seed = request_seed(seed, self.mesh)
        timings = {}
        with span("request", seed=seed, batch=1):
            context, context_null, context_lens = self.text_context(
                input_prompt, n_prompt, context, context_null, context_lens,
                timings)

            with span("prep"):
                lat_shape = self.latent_shape(size, frame_num)
                seq_len = self.seq_len_for(lat_shape)
                gen = torch.Generator(device=dev).manual_seed(seed)
                noise = torch.randn((1,) + lat_shape, generator=gen,
                                    device=dev, dtype=torch.float32)

            with stage("denoise_s", timings, dev, tokens=seq_len):
                latents = sample(
                    self.model, noise, context, context_null,
                    policy=self.policy, seq_len=seq_len, shift=shift,
                    solver=sample_solver, steps=sampling_steps,
                    guide_scale=guide_scale,
                    num_train_timesteps=cfg.num_train_timesteps,
                    cfg_mode=cfg_mode, context_lens=context_lens,
                    mesh=self.mesh)
            timings["steps"] = sampling_steps
            self.timings = timings
            if return_latents:
                return latents
            with stage("vae_decode_s", timings, dev):
                video = vae_decode(self.vae, latents, streaming=True)
        return video[0]


def _t_batch(t, n: int, device) -> torch.Tensor:
    """[n] fp32 copies of the timestep: a Python float, or a 0-d tensor
    (the exported step's input, utils/export.py)."""
    if torch.is_tensor(t):
        return t.to(device=device, dtype=torch.float32).reshape(1).repeat(n)
    return torch.full((n,), t, dtype=torch.float32, device=device)


def cfg_model_step(model: WanModel, x, t, ctx2, rope_sin, rope_cos,
                   ctx_lens=None, *, policy: DTypePolicy, seq_len: int,
                   guide_scale: float, cfg_mode: str = "fused", y=None,
                   clip_fea=None, attn_impl: str = "auto",
                   token_sharding=None):
    """One classifier-free-guidance model call (JAX _cfg_model_step and
    _i2v_cfg_model_step): 'fused' stacks cond / uncond on the batch,
    'sequential' runs two forwards (half the activation peak). `t` is a
    float or a 0-d tensor. i2v: y [1, C, F, H, W] and clip_fea [1, 257, D]
    condition both halves, or come stacked cond / uncond ([2, ...], JAX
    `_i2v_cfg_model_step`'s y2 and clip2, whose 'sequential' mode gives
    the cond half to both forwards). `attn_impl` / `token_sharding`: the
    mesh plan (`mesh_plan`)."""
    fwd = dict(seq_len=seq_len, rope_sin=rope_sin, rope_cos=rope_cos,
               policy=policy, y=y, clip_fea=clip_fea, attn_impl=attn_impl,
               token_sharding=token_sharding)
    with span("cfg"):
        b = x.shape[0]
        if cfg_mode == "fused":
            x2 = torch.cat([x, x], dim=0)
            t2 = _t_batch(t, x2.shape[0], x.device)
            if y is not None and y.shape[0] == b:
                fwd["y"] = torch.cat([y, y], dim=0)
                fwd["clip_fea"] = torch.cat([clip_fea, clip_fea], dim=0)
            v2 = model(x2, t2, ctx2, context_lens=ctx_lens, **fwd)
            v_cond, v_uncond = v2.chunk(2, dim=0)
        elif cfg_mode == "sequential":
            ctx, ctx_null = ctx2.chunk(2, dim=0)
            lens_c = lens_n = None
            if ctx_lens is not None:
                lens_c, lens_n = ctx_lens[:1], ctx_lens[1:]
            if y is not None:
                fwd["y"], fwd["clip_fea"] = y[:b], clip_fea[:b]
            t1 = _t_batch(t, b, x.device)
            v_cond = model(x, t1, ctx, context_lens=lens_c, **fwd)
            v_uncond = model(x, t1, ctx_null, context_lens=lens_n, **fwd)
        else:
            raise ValueError(f"unknown cfg_mode {cfg_mode!r}; "
                             "expected 'fused' or 'sequential'")
        return v_uncond + guide_scale * (v_cond - v_uncond)


@torch.no_grad()
def sample(model: WanModel, noise, context, context_null, *,
           policy: DTypePolicy, seq_len: int, shift: float, solver: str,
           steps: int, guide_scale: float, num_train_timesteps: int = 1000,
           cfg_mode: str = "fused", context_lens=None, y=None,
           clip_fea=None, mesh=None) -> torch.Tensor:
    """Denoising loop from the caller's noise [1, C, F, H, W] (fp32); with
    y and clip_fea, the i2v loop (JAX _i2v_sample). With `mesh`, every
    model call runs the mesh plan under `use_mesh`."""
    attn_impl, token_sharding, _ = mesh_plan(mesh)
    cfg: WanModelConfig = model.cfg
    pt, ph, pw = cfg.patch_size
    grid = (noise.shape[2] // pt, noise.shape[3] // ph, noise.shape[4] // pw)
    rope_sin, rope_cos = rope_angles_3d(grid, cfg.head_dim, seq_len=seq_len,
                                        device=noise.device)
    sol = get_solver(solver, steps, float(shift), num_train_timesteps)
    ctx2 = torch.cat([context, context_null], dim=0)
    ctx_lens = (None if context_lens is None else torch.as_tensor(
        context_lens, device=noise.device).to(torch.int32))
    ts = sol.timesteps
    x = noise
    state = sol.init_state(noise)
    with use_mesh(mesh):
        for i in range(steps):
            with span("step", index=i):
                v = cfg_model_step(model, x, float(np.float32(ts[i])), ctx2,
                                   rope_sin, rope_cos, ctx_lens,
                                   policy=policy, seq_len=seq_len,
                                   guide_scale=float(guide_scale),
                                   cfg_mode=cfg_mode, y=y, clip_fea=clip_fea,
                                   attn_impl=attn_impl,
                                   token_sharding=token_sharding)
                x, state = sol.step(state, v, x, i)
    return x
