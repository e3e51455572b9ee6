"""Seaweed-APT's consistency-distillation step in plain fp32 (reference
seaweed_apt/distilled_trainer.py): the student's velocity at t = T_max on
the noise, MSE against the teacher's velocity, AdamW (b1 0.9, b2 0.999,
eps 1e-8, decoupled weight decay) after clipping the global gradient norm.
Parameters and moments are stored in bf16, as the configuration states;
every update is computed in fp32 and rounded once, where it is stored
(optax's fused chain). The EMA (decay 0.995) is not followed: over the
first steps its change, 0.005 of the parameters' few-ulp moves, rounds
away in bf16 in the program and the reference alike.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from benchmark.reference.dit import dit_forward

T_MAX = 1000.0


def _bias_correction(decay: float, count: int) -> float:
    return float(np.float32(1.0) - np.float32(decay) ** np.int32(count))


def loss_and_grads(params: Dict[str, torch.Tensor], m: dict, batch: dict,
                   fp8: bool = False):
    """(loss, {name: gradient}) of one step, fp32."""
    leaves = {n: p.detach().float().requires_grad_(True)
              for n, p in params.items()}
    noise, ctx = batch["noise"][0], batch["context"][0]
    v = dit_forward(leaves, m, noise, T_MAX, ctx, ctx.shape[0], fp8=fp8,
                    train=True)
    loss = torch.mean(torch.square(v - batch["v_teacher"][0].float()))
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return float(loss.detach()), dict(zip(leaves, grads))


def train(p0: Dict[str, torch.Tensor], m: dict, batches: List[dict],
          hp: dict, fp8: bool = False, dtype=torch.bfloat16) -> dict:
    """Follow the first len(batches) steps from the parameters p0.
    Returns {"loss": [...], "grad_norm": {name: the norm of the step-1
    gradient as the optimizer takes it, clipped}, "raw_grad_norm": {name:
    its norm before clipping}, "params": {name: the parameters after the
    last step}}."""
    params = {n: p.to(dtype) for n, p in p0.items()}
    mu = {n: torch.zeros_like(p) for n, p in params.items()}
    nu = {n: torch.zeros_like(p) for n, p in params.items()}
    b1, b2, eps = hp["b1"], hp["b2"], hp["eps"]
    out = {"loss": []}
    for step, batch in enumerate(batches, start=1):
        loss, grads = loss_and_grads(params, m, batch, fp8)
        out["loss"].append(loss)
        g_norm = float(torch.sqrt(sum(g.double().square().sum()
                                      for g in grads.values())))
        scale = 1.0 if g_norm < hp["grad_clip"] else hp["grad_clip"] / g_norm
        if step == 1:
            out["grad_norm"] = {n: float(torch.linalg.vector_norm(g)) * scale
                                for n, g in grads.items()}
            out["raw_grad_norm"] = {n: float(torch.linalg.vector_norm(g))
                                    for n, g in grads.items()}
        bc1, bc2 = _bias_correction(b1, step), _bias_correction(b2, step)
        with torch.no_grad():
            for n, p in params.items():
                g = grads[n] * scale
                mu_f = b1 * mu[n].float() + (1 - b1) * g
                nu_f = b2 * nu[n].float() + (1 - b2) * g.square()
                mu[n], nu[n] = mu_f.to(dtype), nu_f.to(dtype)
                u = (mu_f / bc1) / ((nu_f / bc2).sqrt() + eps)
                u = u + hp["weight_decay"] * p.float()
                params[n] = (p.float() - hp["lr"] * u).to(dtype)
        del grads
    out["params"] = params
    return out
