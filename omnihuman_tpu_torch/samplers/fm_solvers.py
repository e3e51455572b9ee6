"""Flow-matching multistep solvers, UniPC and DPM-Solver++ (port of
omnihuman_tpu/samplers/fm_solvers.py).

The sigma schedule is static, so every scalar coefficient is computed once
in float64 numpy (`plan_unipc`, `plan_dpm`, copied from the JAX package)
and baked into per-step tables. `_PlanSolver.step` applies one step to
tensors in fp32: a handful of multiply-adds over the latent and a short
history of x0 predictions (reference FlowUniPCMultistepScheduler /
FlowDPMSolverMultistepScheduler, wan/utils/fm_solvers*.py).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Tuple

import numpy as np
import torch


def get_sampling_sigmas(sampling_steps: int, shift: float) -> np.ndarray:
    """sigma = linspace(1, 0)[:-1] warped by shift*s/(1+(shift-1)s)."""
    sigma = np.linspace(1.0, 0.0, sampling_steps + 1)[:sampling_steps]
    return (shift * sigma / (1.0 + (shift - 1.0) * sigma)).astype(np.float64)


def retrieve_timesteps(num_inference_steps: int, shift: float,
                       num_train_timesteps: int = 1000
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """(timesteps, sigmas_with_final_zero) for a shifted linear schedule."""
    sigmas = get_sampling_sigmas(num_inference_steps, shift)
    timesteps = sigmas * num_train_timesteps
    return timesteps, np.concatenate([sigmas, [0.0]])


def _lam(sigma: np.ndarray) -> np.ndarray:
    """lambda = log(alpha) - log(sigma), alpha = 1 - sigma (flow matching)."""
    with np.errstate(divide="ignore"):
        return np.log(np.maximum(1.0 - sigma, 1e-300)) - np.log(
            np.maximum(sigma, 1e-300))


@dataclasses.dataclass(frozen=True)
class SolverPlan:
    """Per-step coefficient tables (numpy, leading dim [steps])."""

    kind: str
    steps: int
    order: int
    sigmas: np.ndarray          # [steps+1]
    timesteps: np.ndarray       # [steps]
    pred_x: np.ndarray
    pred_m0: np.ndarray
    pred_bh: np.ndarray
    pred_rho: np.ndarray
    pred_rk: np.ndarray
    corr_x: np.ndarray
    corr_m0: np.ndarray
    corr_bh: np.ndarray
    corr_rho: np.ndarray
    corr_rk: np.ndarray
    corr_rho_last: np.ndarray
    use_corrector: np.ndarray


def _unipc_rhos(rks: List[float], hh: float, order: int, solver_type: str,
                corrector: bool) -> Tuple[np.ndarray, float]:
    """Solve the B(h) linear system (fm_solvers_unipc.py:430-466,575-607)."""
    rks = np.asarray(rks + [1.0])
    h_phi_1 = np.expm1(hh)
    b_h = hh if solver_type == "bh1" else np.expm1(hh)

    R, b = [], []
    h_phi_k = h_phi_1 / hh - 1.0
    fact = 1
    for i in range(1, order + 1):
        R.append(np.power(rks, i - 1))
        b.append(h_phi_k * fact / b_h)
        fact *= i + 1
        h_phi_k = h_phi_k / hh - 1.0 / fact
    R = np.stack(R)
    b = np.asarray(b)

    if corrector:
        if order == 1:
            rhos = np.asarray([0.5])
        else:
            rhos = np.linalg.solve(R, b)
        return rhos[:-1], float(rhos[-1])
    if order == 2:
        rhos = np.asarray([0.5])
    elif order == 1:
        rhos = np.zeros((0,))
    else:
        rhos = np.linalg.solve(R[:-1, :-1], b[:-1])
    return rhos, 0.0


def plan_unipc(steps: int, shift: float, order: int = 2,
               solver_type: str = "bh2", num_train_timesteps: int = 1000,
               lower_order_final: bool = True,
               disable_corrector: Tuple[int, ...] = ()) -> SolverPlan:
    timesteps, sig = retrieve_timesteps(steps, shift, num_train_timesteps)
    lam = _lam(sig)
    K = order

    z = np.zeros(steps)
    zk = np.zeros((steps, max(K - 1, 1)))
    ok = np.ones((steps, max(K - 1, 1)))
    p_x, p_m0, p_bh = z.copy(), z.copy(), z.copy()
    p_rho, p_rk = zk.copy(), ok.copy()
    c_x, c_m0, c_bh = z.copy(), z.copy(), z.copy()
    c_rho, c_rk = zk.copy(), ok.copy()
    c_rl, use_c = z.copy(), z.copy()

    prev_order = 1
    for i in range(steps):
        o = min(order, i + 1)
        if lower_order_final:
            o = min(o, steps - i)

        # corrector at step i (prev_order, sigma i-1 -> i)
        if i > 0 and (i - 1) not in disable_corrector:
            oc = prev_order
            h = lam[i] - lam[i - 1]
            hh = -h
            rks = []
            for j in range(1, oc):
                rks.append(float((lam[i - 1 - j] - lam[i - 1]) / h))
            rho_d1, rho_last = _unipc_rhos(rks, hh, oc, solver_type, True)
            a_t = 1.0 - sig[i]
            c_x[i] = sig[i] / sig[i - 1]
            c_m0[i] = -a_t * np.expm1(hh)
            b_h = hh if solver_type == "bh1" else np.expm1(hh)
            c_bh[i] = -a_t * b_h
            for j, (rk, rho) in enumerate(zip(rks, rho_d1)):
                c_rho[i, j] = rho
                c_rk[i, j] = rk
            c_rl[i] = rho_last
            use_c[i] = 1.0

        # predictor at step i (sigma i -> i+1)
        h = lam[i + 1] - lam[i]
        hh = -h
        rks = []
        for j in range(1, o):
            rks.append(float((lam[i - j] - lam[i]) / h))
        rho_d1, _ = _unipc_rhos(rks, hh, o, solver_type, False)
        a_t = 1.0 - sig[i + 1]
        p_x[i] = sig[i + 1] / sig[i]
        p_m0[i] = -a_t * np.expm1(hh)
        b_h = hh if solver_type == "bh1" else np.expm1(hh)
        p_bh[i] = -a_t * b_h
        for j, (rk, rho) in enumerate(zip(rks, rho_d1)):
            p_rho[i, j] = rho
            p_rk[i, j] = rk
        prev_order = o

    return SolverPlan(
        kind="unipc", steps=steps, order=order, sigmas=sig,
        timesteps=timesteps, pred_x=p_x, pred_m0=p_m0, pred_bh=p_bh,
        pred_rho=p_rho, pred_rk=p_rk, corr_x=c_x, corr_m0=c_m0, corr_bh=c_bh,
        corr_rho=c_rho, corr_rk=c_rk, corr_rho_last=c_rl,
        use_corrector=use_c)


def plan_dpm(steps: int, shift: float, order: int = 2,
             solver_type: str = "midpoint",
             num_train_timesteps: int = 1000,
             lower_order_final: bool = True,
             sigmas: Optional[np.ndarray] = None) -> SolverPlan:
    """DPM-Solver++ multistep, data prediction, order <= 2
    (fm_solvers.py:341-520) on the shared SolverPlan layout."""
    if sigmas is not None:
        sig = np.concatenate([np.asarray(sigmas, np.float64), [0.0]])
        timesteps = sig[:-1] * num_train_timesteps
        steps = len(sig) - 1
    else:
        timesteps, sig = retrieve_timesteps(steps, shift,
                                            num_train_timesteps)
    lam = _lam(sig)
    K = max(order, 2)

    z = np.zeros(steps)
    p_x, p_m0, p_bh = z.copy(), z.copy(), z.copy()
    p_rho = np.zeros((steps, K - 1))
    p_rk = np.ones((steps, K - 1))

    for i in range(steps):
        o = min(order, i + 1)
        if lower_order_final:
            o = min(o, steps - i)
        h = lam[i + 1] - lam[i]
        a_t = 1.0 - sig[i + 1]
        p_x[i] = sig[i + 1] / sig[i]
        p_m0[i] = -a_t * np.expm1(-h)
        if o >= 2:
            # the shared step computes pred_bh*rho*(m1 - m0)/rk (UniPC's D1
            # orientation); DPM's D1 = (m0 - m1)/r0 flips the sign
            h_0 = lam[i] - lam[i - 1]
            r0 = h_0 / h
            if solver_type == "midpoint":
                p_bh[i] = a_t * np.expm1(-h)
                p_rho[i, 0] = 0.5
            else:  # heun
                p_bh[i] = -a_t * (np.expm1(-h) / h + 1.0)
                p_rho[i, 0] = 1.0
            p_rk[i, 0] = r0

    return SolverPlan(
        kind="dpm", steps=steps, order=order, sigmas=sig,
        timesteps=timesteps, pred_x=p_x, pred_m0=p_m0, pred_bh=p_bh,
        pred_rho=p_rho, pred_rk=p_rk, corr_x=z, corr_m0=z, corr_bh=z,
        corr_rho=np.zeros((steps, K - 1)), corr_rk=np.ones((steps, K - 1)),
        corr_rho_last=z, use_corrector=z)


class _PlanSolver:
    """Stepping over a SolverPlan on tensors (fp32 arithmetic)."""

    def __init__(self, plan: SolverPlan):
        self.plan = plan

    @property
    def timesteps(self) -> np.ndarray:
        return self.plan.timesteps

    @property
    def sigmas(self) -> np.ndarray:
        return self.plan.sigmas

    def init_state(self, sample: torch.Tensor) -> dict:
        k = max(self.plan.order - 1, 1)
        return {"hist": sample.new_zeros((k + 1,) + tuple(sample.shape)),
                "last_sample": torch.zeros_like(sample), "step": 0}

    def step(self, state: dict, v: torch.Tensor, sample: torch.Tensor,
             step_index: int) -> Tuple[torch.Tensor, dict]:
        """One solver step: (velocity at `sample`, state) -> next sample."""
        p = self.plan
        i = int(step_index)

        def c(tab):   # the table entry as an fp32 scalar, as the JAX gather
            return float(np.float32(tab[i]))

        x = sample.float()
        v = v.float()
        x0 = x - c(p.sigmas) * v
        hist = state["hist"].float()
        m0_prev = hist[-1]

        if c(p.use_corrector) > 0:
            d1_sum = torch.zeros_like(x)
            for j in range(p.pred_rho.shape[1]):
                d1_sum = d1_sum + c(p.corr_rho[:, j]) * (
                    hist[-2 - j] - m0_prev) / c(p.corr_rk[:, j])
            x = (c(p.corr_x) * state["last_sample"].float()
                 + c(p.corr_m0) * m0_prev
                 + c(p.corr_bh) * (d1_sum
                                   + c(p.corr_rho_last) * (x0 - m0_prev)))

        hist = torch.cat([hist[1:], x0[None]], dim=0)

        d1_sum = torch.zeros_like(x)
        for j in range(p.pred_rho.shape[1]):
            d1_sum = d1_sum + c(p.pred_rho[:, j]) * (
                hist[-2 - j] - x0) / c(p.pred_rk[:, j])
        x_next = (c(p.pred_x) * x + c(p.pred_m0) * x0
                  + c(p.pred_bh) * d1_sum)

        new_state = {"hist": hist.to(sample.dtype),
                     "last_sample": x.to(sample.dtype), "step": i + 1}
        return x_next.to(sample.dtype), new_state


class FlowUniPCSolver(_PlanSolver):
    """Drop-in for FlowUniPCMultistepScheduler (the default Wan sampler)."""

    def __init__(self, steps: int, shift: float, order: int = 2,
                 solver_type: str = "bh2", num_train_timesteps: int = 1000,
                 disable_corrector: Tuple[int, ...] = ()):
        super().__init__(plan_unipc(
            steps, shift, order=order, solver_type=solver_type,
            num_train_timesteps=num_train_timesteps,
            disable_corrector=disable_corrector))


class FlowDPMSolver(_PlanSolver):
    """Drop-in for FlowDPMSolverMultistepScheduler (the dpm++ path)."""

    def __init__(self, steps: int, shift: float, order: int = 2,
                 solver_type: str = "midpoint",
                 num_train_timesteps: int = 1000,
                 sigmas: Optional[np.ndarray] = None):
        super().__init__(plan_dpm(
            steps, shift, order=order, solver_type=solver_type,
            num_train_timesteps=num_train_timesteps, sigmas=sigmas))


@functools.lru_cache(maxsize=64)
def get_solver(kind: str, steps: int, shift: float,
               num_train_timesteps: int = 1000) -> _PlanSolver:
    """Cached solver instances (the plans are pure functions of the args)."""
    if kind not in ("unipc", "dpm++"):
        raise ValueError(
            f"unknown solver {kind!r}; supported: 'unipc', 'dpm++'")
    cls = FlowUniPCSolver if kind == "unipc" else FlowDPMSolver
    return cls(steps=steps, shift=shift,
               num_train_timesteps=num_train_timesteps)
