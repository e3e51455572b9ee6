"""f-divergence-weighted one-step distillation (port of
omnihuman_tpu/apt/f_distill.py).

Reference seaweed_apt/f_distilled_trainer.py:20-351:
  - the weighting h(r) of a density ratio r: reverse-KL (h = 1),
    forward-KL (r), Jensen-Shannon (r / (r + 1)), squared Hellinger
    (1 / (4 sqrt(r))), softened RKL (1 / (r + 1));
  - the teacher's CFG velocity computed live each step;
  - a small MLP discriminator on velocity features estimates
    r = exp(D(features)), clipped to [0.01, 100]; the features are the
    first 512 elements of the flattened velocity (the reference's
    placeholder, kept as the default `feature_fn`);
  - loss = beta * E[(h(r) / mean h(r) * (v_teacher - v_student))^2]
    + alpha * the non-saturating GAN loss through D.

The order of one step is JAX's: D is updated first on detached features,
then the density ratio and the student's GAN term read the updated D. The
teacher's cond and uncond forwards run as one batch-2 forward
(`apt/generate.py:teacher_cfg_velocity`), where JAX runs two. The student
and the discriminator are updated in place.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from omnihuman_tpu_torch.apt.distill import (
    copy_params, to_device, trainable_params)
from omnihuman_tpu_torch.apt.generate import teacher_cfg_velocity
from omnihuman_tpu_torch.apt.optim import AdamW, Optimizer
from omnihuman_tpu_torch.configs.wan import DTypePolicy
from omnihuman_tpu_torch.models.wan_dit import WanModel

Tensors = Dict[str, torch.Tensor]

F_DIVERGENCES = ("reverse-kl", "forward-kl", "jensen-shannon",
                 "squared-hellinger", "softened-rkl")


def get_f_divergence_fn(divergence_type: str = "reverse-kl"
                        ) -> Callable[[torch.Tensor], torch.Tensor]:
    """h(r) weighting (f_distilled_trainer.py:20-38)."""
    if divergence_type == "reverse-kl":
        return torch.ones_like
    if divergence_type == "forward-kl":
        return lambda r: r
    if divergence_type == "jensen-shannon":
        return lambda r: r / (r + 1.0)
    if divergence_type == "squared-hellinger":
        return lambda r: 1.0 / (4.0 * torch.sqrt(r + 1e-8))
    if divergence_type == "softened-rkl":
        return lambda r: 1.0 / (r + 1.0)
    raise ValueError(f"Unsupported f-divergence type: {divergence_type}")


def default_feature_fn(v: torch.Tensor, dim: int = 512) -> torch.Tensor:
    """The first `dim` elements of each sample's velocity flattened in its
    logical [C, F, H, W] order, whatever its memory layout."""
    return v.reshape(v.shape[0], -1)[:, :dim]


class MLPDiscriminator(nn.Module):
    """Linear(in -> 256), LeakyReLU 0.2, Linear(256 -> 128), LeakyReLU 0.2,
    Linear(128 -> 1) (f_distilled_trainer.py:120-126)."""

    def __init__(self, in_dim: int = 512):
        super().__init__()
        self.fc1 = nn.Linear(in_dim, 256)
        self.fc2 = nn.Linear(256, 128)
        self.fc3 = nn.Linear(128, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.leaky_relu(self.fc1(x), 0.2)
        h = F.leaky_relu(self.fc2(h), 0.2)
        return self.fc3(h)


def init_mlp_discriminator(in_dim: int = 512, device="cpu",
                           generator: Optional[torch.Generator] = None
                           ) -> MLPDiscriminator:
    """fp32, He-normal weights (normal * sqrt(2 / fan_in)) from `generator`
    (on `device`), zero biases, as the JAX init draws them."""
    disc = MLPDiscriminator(in_dim).to(device)
    with torch.no_grad():
        for lin in (disc.fc1, disc.fc2, disc.fc3):
            lin.weight.normal_(0.0, (2.0 / lin.in_features) ** 0.5,
                               generator=generator)
            lin.bias.zero_()
    return disc


def make_student_optimizer(lr: float) -> Optimizer:
    """optax.adamw(lr, weight_decay=0.01): no clipping."""
    return AdamW(lr, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01,
                 grad_clip=None)


def make_d_optimizer(lr: float) -> Optimizer:
    """optax.adam(lr)."""
    return AdamW(lr, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0,
                 grad_clip=None)


@dataclasses.dataclass
class FDistillState:
    """The JAX FDistillState: `student` holds the parameters, `disc` the
    discriminator's."""

    student: WanModel
    opt_state: Dict
    disc: MLPDiscriminator
    d_opt_state: Dict
    step: int

    def state_dict(self) -> Dict:
        return {"params": {n: p.detach() for n, p in
                           trainable_params(self.student).items()},
                "opt_state": self.opt_state,
                "d_params": {n: p.detach() for n, p in
                             self.disc.named_parameters()},
                "d_opt_state": self.d_opt_state, "step": self.step}

    def load_state_dict(self, sd: Dict) -> None:
        copy_params(trainable_params(self.student), sd["params"],
                    "student parameters")
        copy_params(dict(self.disc.named_parameters()), sd["d_params"],
                    "discriminator parameters")
        dev = next(self.student.parameters()).device
        self.opt_state = to_device(sd["opt_state"], dev)
        self.d_opt_state = to_device(sd["d_opt_state"], dev)
        self.step = int(sd["step"])


def init_f_distill_state(student: WanModel, disc: MLPDiscriminator,
                         optimizer: Optimizer,
                         d_optimizer: Optimizer) -> FDistillState:
    return FDistillState(
        student=student, opt_state=optimizer.init(trainable_params(student)),
        disc=disc, d_opt_state=d_optimizer.init(dict(disc.named_parameters())),
        step=0)


def f_distill_train_step(
    state: FDistillState,
    teacher: WanModel,
    batch: Tensors,        # noise, context, context_null
    *,
    optimizer: Optimizer,
    d_optimizer: Optimizer,
    seq_len: int,
    rope_sin, rope_cos,
    policy: DTypePolicy = DTypePolicy(),
    f_divergence: str = "reverse-kl",
    cfg_scale: float = 7.5,
    alpha: float = 0.1,
    beta: float = 1.0,
    use_discriminator: bool = True,
    t_max: float = 1000.0,
    feature_fn: Callable = default_feature_fn,
    remat=True,
) -> Tuple[FDistillState, Dict]:
    """One f-distill step (f_distilled_trainer.py:175-300); the state is
    updated in place and returned with 0-dim metric tensors {"loss",
    "f_div_loss", "g_loss", "d_loss", "density_ratio_mean",
    "weight_mean"}. remat: the student's graded forward (True = per
    block, an int = grouped)."""
    h_fn = get_f_divergence_fn(f_divergence)
    noise, ctx = batch["noise"], batch["context"]
    b = noise.shape[0]
    t = torch.full((b,), t_max, dtype=torch.float32, device=noise.device)
    fwd = dict(seq_len=seq_len, rope_sin=rope_sin, rope_cos=rope_cos,
               policy=policy)

    # the frozen teacher's CFG velocity (":186-204")
    v_teacher = teacher_cfg_velocity(
        teacher, noise, ctx, batch["context_null"], t_value=t_max,
        cfg_scale=cfg_scale, **fwd)

    # the discriminator update on detached features (":236-259")
    disc = state.disc
    if use_discriminator:
        with torch.no_grad():
            sf = feature_fn(state.student(noise, t, ctx, **fwd))
        tf = feature_fn(v_teacher)
        d_params = dict(disc.named_parameters())
        d_loss = (torch.mean(F.softplus(-disc(tf)))
                  + torch.mean(F.softplus(disc(sf))))
        d_grads = dict(zip(d_params, torch.autograd.grad(
            d_loss, list(d_params.values()))))
        d_optimizer.step(d_params, d_grads, state.d_opt_state)
        d_loss = d_loss.detach()
        with torch.no_grad():    # r = exp(D(sf)) through the updated D
            ratio = torch.clamp(torch.exp(disc(sf)), 0.01, 100.0)
    else:
        d_loss = torch.zeros((), device=noise.device)
        ratio = torch.ones((b, 1), device=noise.device)

    weights = h_fn(ratio)
    weights = weights / (torch.mean(weights) + 1e-8)
    w_exp = weights.reshape(b, 1, 1, 1, 1)

    # the student update (":267-281")
    params = trainable_params(state.student)
    v_student = state.student(noise, t, ctx, remat=remat, **fwd)
    f_div = torch.mean(torch.square(w_exp * (v_teacher - v_student)))
    gan = torch.zeros((), device=noise.device)
    if use_discriminator:
        gan = torch.mean(F.softplus(-disc(feature_fn(v_student))))
    loss = beta * f_div + alpha * gan
    grads = dict(zip(params, torch.autograd.grad(loss,
                                                 list(params.values()))))
    optimizer.step(params, grads, state.opt_state)
    state.step += 1
    return state, {"loss": loss.detach(), "f_div_loss": f_div.detach(),
                   "g_loss": gan.detach(), "d_loss": d_loss,
                   "density_ratio_mean": torch.mean(ratio),
                   "weight_mean": torch.mean(weights)}
