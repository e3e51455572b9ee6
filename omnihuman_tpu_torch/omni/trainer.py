"""OmniHuman 3-stage trainer (port of omnihuman_tpu/omni/trainer.py).

  - stages with per-condition activation ratios (`DEFAULT_STAGES`: text
    and reference always; audio 0.5 in stage 2, audio 0.25 and pose 0.13
    in stage 3), drawn per sample as [B] masks each step;
  - AdamW behind a global-norm clip, with a cosine / linear / constant
    learning-rate schedule over all stages (optax's formulas, in fp32);
  - the flow-matching loss: x_t = (1 - t) x + t eps, the velocity target
    eps - x by default (`target="sample"` regresses onto x, the
    reference's objective), weighted by (1 - t);
  - a checkpoint every `checkpoint_interval` steps and one at the end of
    each stage with {"stage", "final"} metadata, and a resume that
    returns (global step, stage).

The step's random inputs are drawn by `draw_step_inputs` from an explicit
`torch.Generator` and handed to `omni_train_step` as tensors, so a test
can feed it the draws of `jax.random` instead.

Dtypes: the omni parameters are fp32 (`DTypePolicy().params`), and so are
the AdamW moments, which optax keeps in the parameter dtype. The blocks
cast their activations to `policy.compute` (bf16), and a bf16 activation
times an fp32 weight promotes to an fp32 GEMM, as in JAX
(`models/wan_dit.py:_linear`); attention runs in bf16. On the card every
attention forward, its remat recompute and its backward run the K1 / K2
kernels (ops/flash_attention.py).

The mesh plan (JAX `:185-244`, parallel/train_mesh.py): `OmniHumanTrainer
(plan=)` shards the model with FSDP2 before its AdamW state is made, runs
the step inside `plan.mesh_context()`, where the forward runs the ring
self-attention and sp_cross on this rank's 1/sp of the packed tokens
(padded to a multiple of sp), takes each
data rank's slice of the global batch and each sp rank's rows of the pose
heatmaps (`plan.put_batch`; the pose guider runs on them with halos) and
averages the gradients over the mesh. The draws are made for the global batch on every
rank from the same generator and then sliced, so every rank of a data
group trains on the same t, noise and masks.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from omnihuman_tpu_torch.apt.distill import trainable_params
from omnihuman_tpu_torch.apt.optim import AdamW, global_norm
from omnihuman_tpu_torch.configs.wan import DTypePolicy
from omnihuman_tpu_torch.omni.model import (
    OmniModel, OmniModelConfig, omni_model_forward)
from omnihuman_tpu_torch.parallel.partition import copy_whole_into
from omnihuman_tpu_torch.parallel.train_mesh import NO_MESH, TrainMeshPlan
from omnihuman_tpu_torch.utils.checkpoint import CheckpointManager
from omnihuman_tpu_torch.utils.logging import logger

Tensors = Dict[str, torch.Tensor]
# the conditions a step draws a mask for, in the JAX fold_in order
MASKED_CONDITIONS = ("audio", "pose", "reference")


@dataclasses.dataclass(frozen=True)
class StageConfig:
    name: str
    num_steps: int
    condition_ratios: Dict[str, float]

    def __hash__(self):
        return hash((self.name, self.num_steps,
                     tuple(sorted(self.condition_ratios.items()))))


DEFAULT_STAGES: Tuple[StageConfig, ...] = (
    StageConfig("text_reference", 50_000,
                {"text": 1.0, "reference": 1.0, "audio": 0.0, "pose": 0.0}),
    StageConfig("text_reference_audio", 30_000,
                {"text": 1.0, "reference": 1.0, "audio": 0.5, "pose": 0.0}),
    StageConfig("all_conditions", 20_000,
                {"text": 1.0, "reference": 1.0, "audio": 0.25,
                 "pose": 0.13}),
)


@dataclasses.dataclass
class OmniTrainState:
    """The JAX OmniTrainState: `model` holds the parameters, `opt_state`
    AdamW's {"count", "mu", "nu"}, `step` the global step."""

    model: OmniModel
    opt_state: Dict
    step: int

    def params(self) -> Tensors:
        return trainable_params(self.model)

    def state_dict(self) -> Dict:
        return {"params": {n: p.detach() for n, p in self.params().items()},
                "opt_state": self.opt_state, "step": self.step}

    @torch.no_grad()
    def load_state_dict(self, sd: Dict) -> None:
        """Copy a saved state into this one's tensors (same names, shapes
        and dtypes, or it raises), so the device holds one copy."""
        params = self.params()
        _copy_into(params, sd["params"], "params")
        opt = sd["opt_state"]
        if set(opt) != set(self.opt_state):
            raise ValueError(f"optimizer state keys {sorted(opt)} != "
                             f"{sorted(self.opt_state)}")
        for key in ("mu", "nu"):
            _copy_into(self.opt_state[key], opt[key], f"opt_state/{key}")
        self.opt_state["count"] = int(opt["count"])
        self.step = int(sd["step"])


def _copy_into(dst: Tensors, src: Tensors, where: str) -> None:
    """dst[n] <- src[n] for every name (a sharded dst takes its slice)."""
    if set(dst) != set(src):
        missing, extra = set(dst) - set(src), set(src) - set(dst)
        raise ValueError(f"{where}: missing {sorted(missing)[:5]}, "
                         f"unexpected {sorted(extra)[:5]}")
    for n, t in dst.items():
        s = src[n]
        if s.shape != t.shape or s.dtype != t.dtype:
            raise ValueError(f"{where}/{n}: {tuple(s.shape)} {s.dtype} != "
                             f"{tuple(t.shape)} {t.dtype}")
        copy_whole_into(t, s)


def make_lr_schedule(kind: str, base_lr: float, total_steps: int,
                     min_lr: float = 1e-6,
                     end_factor: float = 0.1) -> Callable[[int], float]:
    """cosine / linear / constant: count -> learning rate, optax's
    `cosine_decay_schedule(base_lr, total_steps, alpha=min_lr / base_lr)`,
    `linear_schedule(base_lr, base_lr * end_factor, total_steps)` and
    `constant_schedule(base_lr)` in their fp32 arithmetic. An unknown kind
    falls back to cosine with a warning, as in JAX."""
    f32 = np.float32
    if kind == "constant":
        return lambda count: float(f32(base_lr))
    if kind == "linear":
        end = base_lr * end_factor

        def linear(count: int) -> float:
            c = min(max(int(count), 0), total_steps)
            frac = f32(1.0) - f32(c) / f32(total_steps)
            return float(f32(base_lr - end) * frac + f32(end))
        return linear
    if kind != "cosine":
        logger.warning(f"Unknown scheduler type: {kind}, using cosine")
    alpha = min_lr / base_lr

    def cosine(count: int) -> float:
        c = f32(min(int(count), total_steps))
        decay = f32(0.5) * (f32(1.0) + np.cos(f32(np.pi) * c
                                              / f32(total_steps)))
        return float(f32(base_lr) * (f32(1.0 - alpha) * decay + f32(alpha)))
    return cosine


def make_omni_optimizer(lr_schedule: Callable[[int], float],
                        weight_decay: float = 0.01,
                        max_grad_norm: float = 1.0,
                        b1: float = 0.9, b2: float = 0.999) -> AdamW:
    """optax.chain(clip_by_global_norm(max_grad_norm), adamw(lr_schedule,
    b1, b2, eps=1e-8, weight_decay))."""
    return AdamW(lr_schedule, b1=b1, b2=b2, eps=1e-8,
                 weight_decay=weight_decay, grad_clip=max_grad_norm)


def init_omni_train_state(model: OmniModel, optimizer: AdamW
                          ) -> OmniTrainState:
    return OmniTrainState(model=model,
                          opt_state=optimizer.init(trainable_params(model)),
                          step=0)


def draw_step_inputs(generator: torch.Generator, frames_shape,
                     ratios: Dict[str, float], device
                     ) -> Tuple[Tensors, torch.Tensor, torch.Tensor]:
    """The step's random inputs: ([B] fp32 masks {"audio", "pose",
    "reference"}, each 1 with its stage ratio; t [B] uniform in (1e-4,
    1 - 1e-4); the fp32 noise of the frames' shape)."""
    b = frames_shape[0]
    masks = {name: (torch.rand(b, generator=generator, device=device)
                    < float(ratios.get(name, 0.0))).to(torch.float32)
             for name in MASKED_CONDITIONS}
    t = (torch.rand(b, generator=generator, device=device) * (1.0 - 2e-4)
         + 1e-4)
    noise = torch.randn(tuple(frames_shape), generator=generator,
                        device=device, dtype=torch.float32)
    return masks, t, noise


def omni_flow_matching_loss(model: OmniModel, batch: Dict, masks: Tensors,
                            t: torch.Tensor, noise: torch.Tensor, *,
                            policy: DTypePolicy = DTypePolicy(),
                            target: str = "velocity",
                            remat=True) -> torch.Tensor:
    """mean((v - target)^2 * (1 - t)) at x_t = (1 - t) x + t noise; under
    a current mesh, its plan (`omni_model_forward`).

    batch: "frames" (clean latents [B, C, F, H, W]), "context", and
    optionally "audio", "pose", "reference", and "pose_sharding" where
    "pose" is an H shard (`TrainMeshPlan.put_batch`)."""
    if target not in ("velocity", "sample"):
        raise ValueError(f"unknown target {target!r}")
    frames = batch["frames"].to(torch.float32)
    tb = t.reshape(-1, 1, 1, 1, 1)
    noisy = (1.0 - tb) * frames + tb * noise
    pred = omni_model_forward(
        model, noisy, t * 1000.0, batch["context"], audio=batch.get("audio"),
        pose=batch.get("pose"), ref_latent=batch.get("reference"),
        cond_mask=masks, policy=policy, remat=remat,
        pose_sharding=batch.get("pose_sharding"))
    tgt = noise - frames if target == "velocity" else frames
    return torch.mean(torch.square(pred - tgt) * (1.0 - tb))


def omni_train_step(state: OmniTrainState, batch: Dict, masks: Tensors,
                    t: torch.Tensor, noise: torch.Tensor, *,
                    optimizer: AdamW, policy: DTypePolicy = DTypePolicy(),
                    target: str = "velocity", remat=True,
                    plan: TrainMeshPlan = NO_MESH
                    ) -> Tuple[OmniTrainState, Dict]:
    """One update from the given draws; the state changes in place and is
    returned with {"loss", "grad_norm"} (0-dim device tensors; the norm of
    the raw gradients, in fp32). Parameters the batch does not reach (the
    audio adapters without audio, the pose guider without pose) get zero
    gradients, as in JAX, so AdamW still decays them. On a `plan` with a
    mesh, the batch and the draws are this data rank's slices and the
    loss is the global batch's."""
    params = state.params()
    with plan.mesh_context():
        loss = omni_flow_matching_loss(
            state.model, batch, masks, t, noise, policy=policy,
            target=target, remat=remat)
        grads = plan.grads(loss, params, allow_unused=True)
    optimizer.step(params, grads, state.opt_state)
    state.step += 1
    return state, {"loss": plan.mean_over_data(loss.detach()),
                   "grad_norm": global_norm(grads.values())}


def _stage_seed(seed: int, stage: int) -> int:
    return (int(seed) * 1_000_003 + int(stage)) % (2 ** 63)


class OmniHumanTrainer:
    """Stage orchestration and checkpointing around `omni_train_step`.

    `model` is a trainable OmniModel (fp32 parameters); `data_iter`s yield
    device batches for `omni_flow_matching_loss`."""

    def __init__(self, model: OmniModel, cfg: OmniModelConfig,
                 stages: Tuple[StageConfig, ...] = DEFAULT_STAGES,
                 learning_rate: float = 1e-4,
                 scheduler_type: str = "cosine",
                 weight_decay: float = 0.01,
                 max_grad_norm: float = 1.0,
                 checkpoint_dir: str = "checkpoints/omni",
                 checkpoint_interval: int = 1000,
                 log_interval: int = 100,
                 policy: DTypePolicy = DTypePolicy(),
                 metric_writer: Optional[Callable[[Dict, int], None]] = None,
                 remat=True, plan: TrainMeshPlan = NO_MESH):
        """remat: True per block, an int g grouped by g blocks. plan: the
        training mesh (module docstring); the model is sharded here."""
        self.cfg = cfg
        self.stages = stages
        total = sum(s.num_steps for s in stages)
        self.optimizer = make_omni_optimizer(
            make_lr_schedule(scheduler_type, learning_rate, total),
            weight_decay, max_grad_norm)
        self.plan = plan
        self.state = init_omni_train_state(plan.shard_tree(model),
                                           self.optimizer)
        self.device = next(model.parameters()).device
        self.ckpt = CheckpointManager(checkpoint_dir)
        self.checkpoint_interval = checkpoint_interval
        self.log_interval = log_interval
        self.policy = policy
        self.remat = remat
        self.metric_writer = metric_writer or (lambda m, s: None)
        # one record a save: {"step", "bytes", "seconds"}
        self.saves: List[Dict] = []

    def train_stage(self, stage_idx: int, data_iter: Iterator[Dict],
                    generator: torch.Generator, start_step: int = 0) -> Dict:
        """One stage; `start_step` skips the steps a resumed run already
        took."""
        stage = self.stages[stage_idx]
        logger.info(f"Starting stage {stage_idx + 1} '{stage.name}' "
                    f"at step {start_step}/{stage.num_steps}; "
                    f"ratios {stage.condition_ratios}")
        # losses stay on the device between log points
        pending: List[torch.Tensor] = []
        last: Dict = {}
        put = self.plan.put_batch
        for i in range(start_step, stage.num_steps):
            batch = next(data_iter)
            masks, t, noise = draw_step_inputs(
                generator, batch["frames"].shape, stage.condition_ratios,
                self.device)
            draws = put({"t": t, "noise": noise, **masks})
            t, noise = draws.pop("t"), draws.pop("noise")
            self.state, metrics = omni_train_step(
                self.state, put(batch), draws, t, noise,
                optimizer=self.optimizer, policy=self.policy,
                remat=self.remat, plan=self.plan)
            pending.append(metrics["loss"])
            if i % self.log_interval == 0:
                last = {"loss": float(torch.stack(pending).mean()),
                        "stage": stage_idx}
                self.metric_writer(last, self.state.step)
                pending = []
            if ((i + 1) % self.checkpoint_interval == 0
                    and (i + 1) < stage.num_steps):  # the final save follows
                self.save_checkpoint(self.state.step, stage_idx)
        self.save_checkpoint(self.state.step, stage_idx, is_final=True)
        return last

    def train(self, data_iter_factory: Callable[[int], Iterator[Dict]],
              seed: int = 0, resume: bool = False) -> None:
        """All stages, each with the iterator `data_iter_factory(stage)`
        and a generator seeded by (seed, stage). With `resume`, continue
        from the latest checkpoint's (step, stage): finished stages are
        skipped and the stage in progress goes on at its offset."""
        start_stage, within = 0, 0
        if resume:
            gstep, start_stage = self.load_checkpoint()
            offset = sum(s.num_steps for s in self.stages[:start_stage])
            within = max(0, gstep - offset)
            if within >= self.stages[start_stage].num_steps:
                start_stage, within = start_stage + 1, 0
        for si in range(start_stage, len(self.stages)):
            gen = torch.Generator(device=self.device).manual_seed(
                _stage_seed(seed, si))
            self.train_stage(si, data_iter_factory(si), gen,
                             start_step=within if si == start_stage else 0)
            within = 0

    def save_checkpoint(self, step: int, stage: int,
                        is_final: bool = False) -> None:
        t0 = time.perf_counter()
        self.ckpt.save(step, self.state,
                       metadata={"stage": stage, "final": is_final})
        sd = self.state.state_dict()
        n_bytes = sum(x.numel() * x.element_size() for part in
                      (sd["params"], sd["opt_state"]["mu"],
                       sd["opt_state"]["nu"]) for x in part.values())
        rec = {"step": step, "bytes": n_bytes,
               "seconds": time.perf_counter() - t0}
        self.saves.append(rec)
        logger.info(f"checkpoint of step {step} (stage {stage}, final "
                    f"{is_final}): {n_bytes / 1e9:.2f} GB in "
                    f"{rec['seconds']:.1f} s")

    def load_checkpoint(self, step: Optional[int] = None) -> Tuple[int, int]:
        """Restore the state of `step` (default: the latest) and return
        (global_step, stage); (0, 0) when there is no checkpoint. A stage
        saved as final resumes at the next stage (clamped to the last); a
        checkpoint without metadata takes the stage its global step falls
        in."""
        if self.ckpt.restore(step, target=self.state) is None:
            return 0, 0
        gstep = self.state.step
        meta = self.ckpt.restore_metadata(step) or {}
        if "stage" in meta:
            stage = int(meta["stage"])
            if meta.get("final"):
                stage = min(stage + 1, len(self.stages) - 1)
            return gstep, stage
        stage, acc = len(self.stages) - 1, 0
        for i, s in enumerate(self.stages):
            if gstep < acc + s.num_steps:
                stage = i
                break
            acc += s.num_steps
        logger.warning(f"checkpoint has no stage metadata; derived stage "
                       f"{stage} from global step {gstep}")
        return gstep, stage
