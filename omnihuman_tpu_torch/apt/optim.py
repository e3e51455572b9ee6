"""The optax transforms the trainers use, written out in PyTorch.

The JAX trainers build their optimizers from optax
(omnihuman_tpu/apt/distill.py:make_optimizer, apt_trainer.py:make_rmsprop):
`clip_by_global_norm` + `adamw`, `rmsprop`, `MultiSteps` and `masked`. The
port keeps their arithmetic and their dtypes rather than torch.optim's:

  - state (moments, accumulators) is kept in the parameter dtype (optax's
    default `mu_dtype=None`), so bf16 parameters get bf16 moments. Each
    update is computed in fp32 and rounded once, where it is stored: XLA
    fuses optax's elementwise chain and keeps the intermediates of a
    fusion in fp32, so the JAX step rounds at the same points;
  - clipping is optax's `where(|g| < c, g, g / |g| * c)`; AdamW's weight
    decay is added to the Adam direction before the learning rate
    (decoupled, `add_decayed_weights`); RMSprop puts eps inside the square
    root (`g * rsqrt(nu + eps)`), where torch.optim puts it outside;
  - the gradient norm is summed in fp32 (optax sums in the gradients'
    dtype); for fp32 parameters the two agree.

An optimizer works on dicts {name: tensor}: `init(params)` returns its
state (tensors and Python ints, so `torch.save` stores it), and
`step(params, grads, state)` updates the parameters and the state in place.

On a training mesh (parallel/train_mesh.py) the parameters FSDP2 shards,
their gradients and the states made from them are DTensors: the
elementwise updates run on each rank's local shard, and `global_norm`
(and so the clip) sums the shards' squares over their mesh and counts
every whole parameter once.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional, Union

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from omnihuman_tpu_torch.parallel.partition import local as _local

Tensors = Dict[str, torch.Tensor]


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt(sum of squares) over all tensors, in fp32 (a 0-dim tensor). A
    DTensor adds the squares of every rank's shard (one all-reduce per
    mesh); a plain tensor, whole on every rank, counts once."""
    whole, shards = [], {}
    for t in tensors:
        if isinstance(t, DTensor):
            shards.setdefault(t.device_mesh, []).append(t.to_local())
        else:
            whole.append(t)
    norms = [torch.linalg.vector_norm(t, dtype=torch.float32)
             for t in whole]
    for mesh, parts in shards.items():
        sq = torch.stack([torch.linalg.vector_norm(
            t, dtype=torch.float32) for t in parts]).square().sum()
        dist.all_reduce(sq, group=mesh.get_group())
        norms.append(sq.sqrt())
    return torch.linalg.vector_norm(torch.stack(norms))


def _bias_correction(decay: float, count: int) -> float:
    """1 - decay**count in fp32, as optax computes it before casting."""
    return float(np.float32(1.0) - np.float32(decay) ** np.int32(count))


class Optimizer:
    """init(params) -> state; step(params, grads, state) in place."""

    def init(self, params: Tensors) -> Dict:
        raise NotImplementedError

    def step(self, params: Tensors, grads: Tensors, state: Dict) -> None:
        raise NotImplementedError


class AdamW(Optimizer):
    """optax.chain(clip_by_global_norm(grad_clip), adamw(lr, b1, b2, eps,
    weight_decay)), or optax.adamw alone with grad_clip None (optax.adam
    with weight_decay 0). `lr` is a number or a schedule, a function of the
    count of updates made before this one (0 on the first step), which is
    where optax's `scale_by_schedule` evaluates it; the bias corrections
    use that count + 1."""

    def __init__(self, lr: Union[float, Callable[[int], float]], b1: float,
                 b2: float, eps: float, weight_decay: float,
                 grad_clip: Optional[float]):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.weight_decay, self.grad_clip = weight_decay, grad_clip

    def init(self, params: Tensors) -> Dict:
        return {"count": 0,
                "mu": {n: torch.zeros_like(p) for n, p in params.items()},
                "nu": {n: torch.zeros_like(p) for n, p in params.items()}}

    @torch.no_grad()
    def step(self, params: Tensors, grads: Tensors, state: Dict) -> None:
        scale = 1.0
        if self.grad_clip is not None:
            g_norm = global_norm(grads.values())
            scale = torch.where(g_norm < self.grad_clip,
                                torch.ones_like(g_norm),
                                self.grad_clip / g_norm)
        lr = self.lr(state["count"]) if callable(self.lr) else self.lr
        count = state["count"] + 1
        state["count"] = count
        bc1 = _bias_correction(self.b1, count)
        bc2 = _bias_correction(self.b2, count)
        for n, p in params.items():
            p = _local(p)
            g = _local(grads[n]).float() * scale
            mu, nu = _local(state["mu"][n]), _local(state["nu"][n])
            mu_f = self.b1 * mu.float() + (1 - self.b1) * g
            nu_f = self.b2 * nu.float() + (1 - self.b2) * g.square()
            mu.copy_(mu_f)
            nu.copy_(nu_f)
            u = (mu_f / bc1) / ((nu_f / bc2).sqrt() + self.eps)
            u = u + self.weight_decay * p.float()
            p.copy_(p.float() - lr * u)


class RMSprop(Optimizer):
    """optax.rmsprop(lr, decay, eps): nu = decay nu + (1 - decay) g^2,
    p -= lr * g * rsqrt(nu + eps) (no centering, no momentum)."""

    def __init__(self, lr: float, decay: float = 0.9, eps: float = 1e-8):
        self.lr, self.decay, self.eps = lr, decay, eps

    def init(self, params: Tensors) -> Dict:
        return {"nu": {n: torch.zeros_like(p) for n, p in params.items()}}

    @torch.no_grad()
    def step(self, params: Tensors, grads: Tensors, state: Dict) -> None:
        for n, p in params.items():
            p = _local(p)
            g, nu = _local(grads[n]).float(), _local(state["nu"][n])
            nu_f = self.decay * nu.float() + (1 - self.decay) * g.square()
            nu.copy_(nu_f)
            p.copy_(p.float() - self.lr * (torch.rsqrt(nu_f + self.eps) * g))


class MultiSteps(Optimizer):
    """optax.MultiSteps(inner, every_k): the running mean of k gradients,
    acc + (g - acc) / (n + 1), then one inner step with it; the steps in
    between leave the parameters as they are."""

    def __init__(self, inner: Optimizer, every_k: int):
        if every_k < 1:
            raise ValueError(f"every_k must be >= 1, got {every_k}")
        self.inner, self.every_k = inner, every_k

    def init(self, params: Tensors) -> Dict:
        return {"mini_step": 0, "gradient_step": 0,
                "inner": self.inner.init(params),
                "acc_grads": {n: torch.zeros_like(p)
                              for n, p in params.items()}}

    @torch.no_grad()
    def step(self, params: Tensors, grads: Tensors, state: Dict) -> None:
        n_acc = state["mini_step"]
        acc = state["acc_grads"]
        for n, g in grads.items():
            a = _local(acc[n])
            a.copy_(a.float() + (_local(g).float() - a.float()) / (n_acc + 1))
        if n_acc + 1 < self.every_k:
            state["mini_step"] = n_acc + 1
            return
        self.inner.step(params, acc, state["inner"])
        for a in acc.values():
            a.zero_()
        state["mini_step"] = 0
        state["gradient_step"] += 1


class Masked(Optimizer):
    """optax.masked(inner, mask): the inner optimizer sees, and keeps state
    for, only the names the mask marks True."""

    def __init__(self, inner: Optimizer, mask: Dict[str, bool]):
        self.inner, self.mask = inner, dict(mask)

    def _pick(self, tensors: Tensors) -> Tensors:
        return {n: t for n, t in tensors.items() if self.mask.get(n, False)}

    def init(self, params: Tensors) -> Dict:
        return self.inner.init(self._pick(params))

    def step(self, params: Tensors, grads: Tensors, state: Dict) -> None:
        self.inner.step(self._pick(params), self._pick(grads), state)
