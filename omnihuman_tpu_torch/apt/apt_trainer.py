"""Stage-2 Seaweed-APT adversarial post-training: the G and D steps (port
of omnihuman_tpu/apt/apt_trainer.py).

Reference seaweed_apt/apt_trainer.py:18-375:
  - generator = the one-step distilled model (x = z - v at t = T);
    discriminator = frozen Wan backbone + 3 cross-attention probes;
  - non-saturating GAN: d_loss = softplus(-real) + softplus(fake),
    g_loss = softplus(-fake);
  - approximated R1 on real samples, lambda 100, sigma 0.01 image /
    0.1 video;
  - RMSprop(alpha 0.9, eps 1e-8 inside the root, as optax), lr 5e-6 image
    phase / 3e-6 video phase; EMA decay 0.995;
  - timestep shift s=1 image / s=12 video on the discriminator timestep;
  - two phases: image, then video with a fresh D and the generator
    restarted from the image-phase EMA (`start_video_phase`).

The random draws (the discriminator's timestep, the R1 noise) come from a
torch.Generator in `apt_d_step` / `apt_g_step`; `d_step_with_draws` /
`g_step_with_draws` take them as tensors, so a caller can give the port
the draws of another implementation. The states are updated in place and
returned.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from omnihuman_tpu_torch.apt.distill import (
    copy_params, to_device, trainable_params)
from omnihuman_tpu_torch.apt.model import (
    APTDiscriminator, apt_discriminator_forward, apt_generator_forward,
    ema_update, timestep_shift)
from omnihuman_tpu_torch.apt.optim import Masked, MultiSteps, Optimizer, RMSprop
from omnihuman_tpu_torch.configs.wan import DTypePolicy
from omnihuman_tpu_torch.models.wan_dit import WanModel

Tensors = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class SeaweedAPTConfig:
    """Paper hyperparameters (reference apt_trainer.py:346-375)."""

    num_train_timesteps: int = 1000
    g_lr_image: float = 5e-6
    d_lr_image: float = 5e-6
    g_lr_video: float = 3e-6
    d_lr_video: float = 3e-6
    image_updates: int = 350
    video_updates: int = 300
    ema_decay: float = 0.995
    lambda_r1: float = 100.0
    r1_sigma_image: float = 0.01
    r1_sigma_video: float = 0.1
    shift_image: float = 1.0
    shift_video: float = 12.0


@dataclasses.dataclass
class APTState:
    """The JAX APTState: `g_model` holds the generator's parameters,
    `disc` the discriminator (only its probes and head train)."""

    g_model: WanModel
    disc: APTDiscriminator
    g_opt: Dict
    d_opt: Dict
    ema_params: Tensors
    step: int

    def state_dict(self) -> Dict:
        """What a checkpoint holds: the generator, the discriminator's
        trainables (the frozen backbone is the teacher, rebuilt from the
        Wan weights), both optimizer states, the EMA and the step."""
        return {"g_params": {n: p.detach() for n, p in
                             trainable_params(self.g_model).items()},
                "d_params": {n: p.detach() for n, p in
                             d_trainable_params(self.disc).items()},
                "g_opt": self.g_opt, "d_opt": self.d_opt,
                "ema_params": self.ema_params, "step": self.step}

    def load_state_dict(self, sd: Dict) -> None:
        copy_params(trainable_params(self.g_model), sd["g_params"],
                    "generator parameters")
        copy_params(d_trainable_params(self.disc), sd["d_params"],
                    "discriminator parameters")
        dev = next(self.g_model.parameters()).device
        self.g_opt = to_device(sd["g_opt"], dev)
        self.d_opt = to_device(sd["d_opt"], dev)
        self.ema_params = to_device(sd["ema_params"], dev)
        self.step = int(sd["step"])


def make_rmsprop(lr: float, accumulation_steps: int = 1) -> Optimizer:
    """RMSprop(alpha 0.9) as optax.rmsprop(lr, decay=0.9, eps=1e-8); with
    accumulation_steps > 1, the mean of that many gradients makes one
    update (optax.MultiSteps), so the effective batch can approach the
    paper's 9062-image / 2048-video recipe."""
    opt: Optimizer = RMSprop(lr, decay=0.9, eps=1e-8)
    if accumulation_steps > 1:
        opt = MultiSteps(opt, accumulation_steps)
    return opt


def d_trainable_mask(disc: APTDiscriminator) -> Dict[str, bool]:
    """True for the probes and head, False for the frozen backbone: the
    optimizer allocates no state for the backbone."""
    return {n: not n.startswith("backbone.")
            for n, _ in disc.named_parameters()}


def make_d_optimizer(lr: float, disc: APTDiscriminator,
                     accumulation_steps: int = 1) -> Optimizer:
    """RMSprop masked to the trainables, the mask outside the accumulation
    (no accumulator for the frozen backbone)."""
    return Masked(make_rmsprop(lr, accumulation_steps),
                  d_trainable_mask(disc))


def d_trainable_params(disc: APTDiscriminator) -> Tensors:
    mask = d_trainable_mask(disc)
    return {n: p for n, p in disc.named_parameters() if mask[n]}


def init_apt_state(g_model: WanModel, disc: APTDiscriminator, g_lr: float,
                   d_lr: float, accumulation_steps: int = 1) -> APTState:
    g_params = trainable_params(g_model)
    return APTState(
        g_model=g_model, disc=disc,
        g_opt=make_rmsprop(g_lr, accumulation_steps).init(g_params),
        d_opt=make_d_optimizer(d_lr, disc, accumulation_steps).init(
            dict(disc.named_parameters())),
        ema_params={n: p.detach().clone() for n, p in g_params.items()},
        step=0)


def _softplus_gan_losses(real_logits, fake_logits) -> torch.Tensor:
    """Non-saturating D loss: -log sigmoid(real) - log(1 - sigmoid(fake))
    = softplus(-real) + softplus(fake), batch means."""
    return (torch.mean(F.softplus(-real_logits))
            + torch.mean(F.softplus(fake_logits)))


def d_step_with_draws(state: APTState, batch: Tensors, t_norm, r1_noise, *,
                      apt_cfg: SeaweedAPTConfig, video: bool, seq_len: int,
                      rope_sin, rope_cos, d_optimizer: Optimizer,
                      policy: DTypePolicy = DTypePolicy()
                      ) -> Tuple[APTState, Dict]:
    """Discriminator update (apt_trainer.py:113-137) with the timestep
    draw t_norm [B] in [0, 1) and the R1 noise (real's shape) given.

    batch: {"real": [B,C,F,H,W] latents, "context": [B,L,text_dim],
            "noise": [B,C,F,H,W]}"""
    s = apt_cfg.shift_video if video else apt_cfg.shift_image
    sigma = apt_cfg.r1_sigma_video if video else apt_cfg.r1_sigma_image
    t_shifted = timestep_shift(t_norm, s) * apt_cfg.num_train_timesteps
    fwd = dict(seq_len=seq_len, rope_sin=rope_sin, rope_cos=rope_cos,
               policy=policy)
    with torch.no_grad():
        fake = apt_generator_forward(
            state.g_model, batch["noise"], batch["context"],
            final_timestep=apt_cfg.num_train_timesteps, **fwd)

    def disc(x):
        return apt_discriminator_forward(state.disc, x, t_shifted,
                                         batch["context"], **fwd)

    real_logits = disc(batch["real"])
    d_loss = _softplus_gan_losses(real_logits, disc(fake))
    r1 = torch.mean(torch.square(      # approximated R1, D(x) reused
        real_logits - disc(batch["real"] + sigma * r1_noise)))
    total = d_loss + apt_cfg.lambda_r1 * r1
    params = d_trainable_params(state.disc)
    grads = dict(zip(params, torch.autograd.grad(total,
                                                 list(params.values()))))
    d_optimizer.step(params, grads, state.d_opt)
    return state, {"d_loss": d_loss.detach(), "r1_loss": r1.detach(),
                   "d_total": total.detach()}


def g_step_with_draws(state: APTState, batch: Tensors, t_norm, *,
                      apt_cfg: SeaweedAPTConfig, video: bool, seq_len: int,
                      rope_sin, rope_cos, g_optimizer: Optimizer,
                      policy: DTypePolicy = DTypePolicy(), remat=True
                      ) -> Tuple[APTState, Dict]:
    """Generator update (apt_trainer.py:139-157) with the timestep draw
    given. The gradient flows through the discriminator's frozen backbone
    into the generated sample (stop_features=False). remat: True = per
    block, int g = grouped two-level."""
    s = apt_cfg.shift_video if video else apt_cfg.shift_image
    t_shifted = timestep_shift(t_norm, s) * apt_cfg.num_train_timesteps
    fwd = dict(seq_len=seq_len, rope_sin=rope_sin, rope_cos=rope_cos,
               policy=policy, remat=remat)
    params = trainable_params(state.g_model)
    fake = apt_generator_forward(
        state.g_model, batch["noise"], batch["context"],
        final_timestep=apt_cfg.num_train_timesteps, **fwd)
    fake_logits = apt_discriminator_forward(
        state.disc, fake, t_shifted, batch["context"], stop_features=False,
        **fwd)
    g_loss = torch.mean(F.softplus(-fake_logits))
    grads = dict(zip(params, torch.autograd.grad(g_loss,
                                                 list(params.values()))))
    g_optimizer.step(params, grads, state.g_opt)
    ema_update(state.ema_params, params, apt_cfg.ema_decay)
    state.step += 1
    return state, {"g_loss": g_loss.detach()}


def _uniform(b: int, generator: Optional[torch.Generator], device):
    return torch.rand((b,), generator=generator).to(device)


def apt_d_step(state: APTState, batch: Tensors,
               generator: Optional[torch.Generator] = None, **kw
               ) -> Tuple[APTState, Dict]:
    """`d_step_with_draws` with t_norm ~ U[0, 1) and the R1 noise ~ N(0, 1)
    drawn from the (CPU) `generator`."""
    real = batch["real"]
    t_norm = _uniform(real.shape[0], generator, real.device)
    noise = torch.randn(real.shape, generator=generator).to(real.device)
    return d_step_with_draws(state, batch, t_norm, noise, **kw)


def apt_g_step(state: APTState, batch: Tensors,
               generator: Optional[torch.Generator] = None, **kw
               ) -> Tuple[APTState, Dict]:
    """`g_step_with_draws` with t_norm ~ U[0, 1) drawn from `generator`."""
    noise = batch["noise"]
    return g_step_with_draws(
        state, batch, _uniform(noise.shape[0], generator, noise.device), **kw)


@torch.no_grad()
def start_video_phase(state: APTState, fresh_disc: APTDiscriminator,
                      apt_cfg: SeaweedAPTConfig,
                      accumulation_steps: int = 1) -> APTState:
    """Phase 2: the generator restarts from the image-phase EMA, with a
    fresh discriminator and fresh optimizers at the video learning rates
    (apt_trainer.py:202-232)."""
    for n, p in trainable_params(state.g_model).items():
        p.copy_(state.ema_params[n])
    return init_apt_state(state.g_model, fresh_disc, apt_cfg.g_lr_video,
                          apt_cfg.d_lr_video, accumulation_steps)
