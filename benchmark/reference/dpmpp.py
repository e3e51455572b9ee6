"""The flow-matching DPM-Solver++ step and OmniHuman's annealed
classifier-free guidance, from the published formulas.

DPM-Solver++ (Lu et al., arXiv:2211.01095) as Wan 2.1's
FlowDPMSolverMultistepScheduler applies it to flow matching
(wan/utils/fm_solvers.py: `convert_model_output`,
`dpm_solver_first_order_update`, `multistep_dpm_solver_second_order_update`,
`step`), with the settings OmniHuman samples with: data prediction,
order 2, multistep, the midpoint rule, the first step in first order
(no history yet) and the last in first order (final sigma zero), the
sigmas of `get_sampling_sigmas` at shift 1.0. With alpha = 1 - sigma and
lambda = log(alpha) - log(sigma), at step i from sigma_s = sigma_i to
sigma_t = sigma_{i+1}, h = lambda_t - lambda_s:
    x0  = x - sigma_s v
    1st: x_t = (sigma_t / sigma_s) x - alpha_t (e^-h - 1) x0
    2nd: r0 = (lambda_s - lambda_{i-1}) / h, D1 = (x0 - x0_prev) / r0,
         x_t = (sigma_t / sigma_s) x - alpha_t (e^-h - 1) (x0 + D1 / 2)
The guidance (OmniHuman-1-hack omnihuman_wan_t2v.py:432-438): v = v_u +
cfg_t (v_c - v_u), cfg_t = cfg (1 - i/steps) + i/steps.

The coefficients in float64 numpy, the tensors in `dtype` (float64; the
control passes bf16). lambda at sigma = 1 is -inf, as in the published
code's IEEE arithmetic: step 0 then takes all of x0 and, at step 1, r0 is
infinite and D1 = 0.

A departure of the program from the published formulas (not copied
here): it clamps alpha and sigma at 1e-300 before the log, so lambda at
sigma = 1 is -690.8; its D1 at step 1 is (x0 - x0_prev) / r0 with r0 near
a thousand, not 0: a few 1e-4 of that step's update at 25 steps (3e-4 in
the CPU test of the port against this file), none at any other step.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def sigmas(steps: int, shift: float) -> np.ndarray:
    """[steps + 1]: linspace(1, 0)[:steps] warped by shift*s / (1 +
    (shift-1) s), then the final 0."""
    s = np.linspace(1.0, 0.0, steps + 1)[:steps]
    s = shift * s / (1.0 + (shift - 1.0) * s)
    return np.concatenate([s, [0.0]]).astype(np.float64)


def timesteps(steps: int, shift: float, num_train: int = 1000) -> np.ndarray:
    return sigmas(steps, shift)[:-1] * num_train


def _lam(sig: np.ndarray) -> np.ndarray:
    with np.errstate(divide="ignore"):
        return np.log(1.0 - sig) - np.log(sig)


def cfg_scale(i: int, steps: int, cfg: float) -> float:
    """The guidance scale of step i, annealed from cfg to 1."""
    return cfg * (1.0 - i / steps) + i / steps


def guide(v_c: torch.Tensor, v_u: torch.Tensor, scale: float,
          dtype: torch.dtype = torch.float64) -> torch.Tensor:
    v_c, v_u = v_c.to(dtype), v_u.to(dtype)
    return v_u + scale * (v_c - v_u)


def coefficients(i: int, steps: int, shift: float
                 ) -> Tuple[float, float, float, float]:
    """(sigma_s, a, b, c) of step i: x0 = x - sigma_s v and x_t = a x +
    b x0 + c (x0 - x0_prev)."""
    sig = sigmas(steps, shift)
    lam = _lam(sig)
    s, tt = sig[i], sig[i + 1]
    with np.errstate(over="ignore", invalid="ignore"):
        h = lam[i + 1] - lam[i]
        phi = np.exp(-h) - 1.0
        a, b = tt / s, -(1.0 - tt) * phi
        c = 0.0
        if 0 < i < steps - 1:
            r0 = (lam[i] - lam[i - 1]) / h
            c = 0.5 * b / r0
    return float(s), float(a), float(b), float(c)


def step(i: int, steps: int, shift: float, x: torch.Tensor, v: torch.Tensor,
         x0_prev: torch.Tensor, dtype: torch.dtype = torch.float64
         ) -> torch.Tensor:
    """x at the next sigma from sample x with velocity v at step i;
    x0_prev: the previous step's x0 prediction (unused at step 0)."""
    s, a, b, c = coefficients(i, steps, shift)
    x, v, x0_prev = (z.to(dtype) for z in (x, v, x0_prev))
    x0 = x - s * v
    out = a * x + b * x0
    if c:
        out = out + c * (x0 - x0_prev)
    return out
