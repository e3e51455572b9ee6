"""Stage-1 consistency distillation (Seaweed-APT), port of
omnihuman_tpu/apt/distill.py.

One-step student regression v_student = model(noise, t=T_max, ctx) against
the cached teacher CFG velocity: MSE loss, AdamW(5e-6) with global-norm
clipping at 1.0, EMA decay 0.995 (reference seaweed_apt/
distilled_trainer.py:26-334).

The student is a trainable `WanModel`; the optimizer state and the EMA are
kept in the parameter dtype, as optax and the JAX step keep them (with
bf16 parameters at lr 5e-6 most updates are below half a bf16 ulp, so
most weights do not move: ROADMAP C records it as a fault of the
reference, and the port copies it). Every attention of the forward and
its recompute goes through the flash kernel with the LSE, and the backward
through the flash backward kernels, when the model lives on a GPU. With a
training mesh (`plan`, parallel/train_mesh.py) the step runs the ring on
this rank's token shard, takes its gradients the way FSDP2 supports and
averages them over the mesh; the logged loss is the global batch's.
Under a profiler the step records the spans `train_step` > `forward`,
`backward`, `optimizer` (`utils/spans.py`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from omnihuman_tpu_torch.apt.model import ema_update
from omnihuman_tpu_torch.apt.optim import AdamW, MultiSteps, Optimizer, global_norm
from omnihuman_tpu_torch.configs.wan import DTypePolicy
from omnihuman_tpu_torch.models.wan_dit import WanModel
from omnihuman_tpu_torch.parallel.partition import (
    copy_whole_into, place_like)
from omnihuman_tpu_torch.parallel.train_mesh import NO_MESH, TrainMeshPlan
from omnihuman_tpu_torch.utils.spans import span

Tensors = Dict[str, torch.Tensor]
T_MAX = 1000.0     # the student's one timestep


def trainable_params(model: torch.nn.Module) -> Tensors:
    """{name: parameter} of the parameters that take gradients."""
    return {n: p for n, p in model.named_parameters() if p.requires_grad}


@dataclasses.dataclass
class DistillState:
    """The JAX DistillState: `model` holds the parameters."""

    model: WanModel
    opt_state: Dict
    ema_params: Tensors
    step: int

    def state_dict(self) -> Dict:
        return {"params": {n: p.detach() for n, p in
                           trainable_params(self.model).items()},
                "opt_state": self.opt_state,
                "ema_params": self.ema_params,
                "step": self.step}

    def load_state_dict(self, sd: Dict) -> None:
        """Load a checkpoint's whole tensors; on a mesh each rank keeps its
        shards (`place_like`)."""
        copy_params(trainable_params(self.model), sd["params"], "parameters")
        self.opt_state = place_like(sd["opt_state"], self.opt_state)
        self.ema_params = place_like(sd["ema_params"], self.ema_params)
        self.step = int(sd["step"])


@torch.no_grad()
def copy_params(params: Tensors, saved: Tensors, what: str) -> None:
    """Copy a checkpoint's tensors into the live parameters of the same
    names (cast to their dtype and device; a sharded parameter takes its
    own slice)."""
    if set(saved) != set(params):
        raise ValueError(f"checkpoint {what} do not match the model")
    for n, p in params.items():
        copy_whole_into(p, saved[n])


def make_optimizer(lr: float = 5e-6,
                   accumulation_steps: int = 1) -> Optimizer:
    """AdamW like the reference (distilled_trainer.py:74-77), with optax's
    clip at 1.0; accumulation_steps > 1 averages that many gradients before
    one update (optax.MultiSteps)."""
    opt: Optimizer = AdamW(lr, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01,
                           grad_clip=1.0)
    if accumulation_steps > 1:
        opt = MultiSteps(opt, accumulation_steps)
    return opt


def init_distill_state(model: WanModel, optimizer: Optimizer) -> DistillState:
    params = trainable_params(model)
    return DistillState(
        model=model, opt_state=optimizer.init(params),
        ema_params={n: p.detach().clone() for n, p in params.items()},
        step=0)


def distill_loss(model: WanModel, batch: Tensors, *, seq_len: int,
                 rope_sin, rope_cos, policy: DTypePolicy,
                 remat=True, attn_impl: str = "auto",
                 token_sharding=None) -> torch.Tensor:
    """MSE(v_student(noise, t=T), v_teacher) (distilled_trainer.py:241-316).
    attn_impl / token_sharding: the mesh plan's (`TrainMeshPlan`).

    batch: {"noise": [B,C,F,H,W], "context": [B,text_len,text_dim],
            "v_teacher": [B,C,F,H,W]}"""
    noise = batch["noise"]
    t = torch.full((noise.shape[0],), T_MAX, dtype=torch.float32,
                   device=noise.device)
    v = model(noise, t, batch["context"], seq_len=seq_len, rope_sin=rope_sin,
              rope_cos=rope_cos, policy=policy, remat=remat,
              attn_impl=attn_impl, token_sharding=token_sharding)
    return torch.mean(torch.square(v - batch["v_teacher"].float()))


def distill_train_step(state: DistillState, batch: Tensors, *,
                       optimizer: Optimizer, seq_len: int, rope_sin,
                       rope_cos, policy: DTypePolicy = DTypePolicy(),
                       ema_decay: float = 0.995, remat=True,
                       plan: TrainMeshPlan = NO_MESH
                       ) -> Tuple[DistillState, Dict]:
    """One optimization step; the state is updated in place and returned.
    Metrics are 0-dim tensors on the model's device: {"loss",
    "grad_norm"} (the norm of the raw gradients, before clipping). On a
    `plan` with a mesh, `batch` is this data rank's slice
    (`plan.put_batch`)."""
    with span("train_step", step=state.step,
              batch=batch["noise"].shape[0], tokens=seq_len):
        params = trainable_params(state.model)
        with plan.mesh_context():
            with span("forward"):
                loss = distill_loss(state.model, batch, seq_len=seq_len,
                                    rope_sin=rope_sin, rope_cos=rope_cos,
                                    policy=policy, remat=remat,
                                    attn_impl=plan.attn_impl,
                                    token_sharding=plan.token_sharding)
            with span("backward"):
                grads = plan.grads(loss, params)
        with span("optimizer"):
            optimizer.step(params, grads, state.opt_state)
            ema_update(state.ema_params, params, ema_decay)
        state.step += 1
        return state, {"loss": plan.mean_over_data(loss.detach()),
                       "grad_norm": global_norm(grads.values())}
