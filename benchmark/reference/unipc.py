"""The flow-matching UniPC multistep step (bh2, order 2, lower order at
the end), a frozen copy of the arithmetic of FlowUniPCMultistepScheduler
(wan/utils/fm_solvers_unipc.py) laid out as per-step coefficient tables.

The schedule is static, so every coefficient is computed once in float64
numpy; a step is a few multiply-adds over the latent and the history of
x0 predictions, in `dtype` (fp32; the control runs it in bf16).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch


def sigmas(steps: int, shift: float) -> np.ndarray:
    """[steps + 1]: linspace(1, 0) warped by shift*s / (1 + (shift-1) s),
    then the final 0."""
    s = np.linspace(1.0, 0.0, steps + 1)[:steps]
    s = shift * s / (1.0 + (shift - 1.0) * s)
    return np.concatenate([s, [0.0]]).astype(np.float64)


def timesteps(steps: int, shift: float, num_train: int = 1000) -> np.ndarray:
    return sigmas(steps, shift)[:-1] * num_train


def _rhos(rks: List[float], hh: float, order: int,
          corrector: bool) -> Tuple[np.ndarray, float]:
    rks = np.asarray(rks + [1.0])
    h_phi_1 = np.expm1(hh)
    b_h = np.expm1(hh)                       # bh2
    rows, b = [], []
    h_phi_k = h_phi_1 / hh - 1.0
    fact = 1
    for i in range(1, order + 1):
        rows.append(np.power(rks, i - 1))
        b.append(h_phi_k * fact / b_h)
        fact *= i + 1
        h_phi_k = h_phi_k / hh - 1.0 / fact
    r, b = np.stack(rows), np.asarray(b)
    if corrector:
        rhos = np.asarray([0.5]) if order == 1 else np.linalg.solve(r, b)
        return rhos[:-1], float(rhos[-1])
    if order == 2:
        return np.asarray([0.5]), 0.0
    if order == 1:
        return np.zeros((0,)), 0.0
    return np.linalg.solve(r[:-1, :-1], b[:-1]), 0.0


def plan(steps: int, shift: float, order: int = 2) -> Dict[str, np.ndarray]:
    """The per-step predictor / corrector coefficients."""
    sig = sigmas(steps, shift)
    with np.errstate(divide="ignore"):
        lam = np.log(np.maximum(1.0 - sig, 1e-300)) - np.log(
            np.maximum(sig, 1e-300))
    k = max(order - 1, 1)
    t = {n: np.zeros(steps) for n in ("p_x", "p_m0", "p_bh", "c_x", "c_m0",
                                       "c_bh", "c_rl", "use_c")}
    for n in ("p_rho", "c_rho"):
        t[n] = np.zeros((steps, k))
    for n in ("p_rk", "c_rk"):
        t[n] = np.ones((steps, k))
    prev = 1
    for i in range(steps):
        o = min(order, i + 1, steps - i)
        if i > 0:
            h = lam[i] - lam[i - 1]
            hh = -h
            rks = [float((lam[i - 1 - j] - lam[i - 1]) / h)
                   for j in range(1, prev)]
            rho, rho_last = _rhos(rks, hh, prev, True)
            a = 1.0 - sig[i]
            t["c_x"][i] = sig[i] / sig[i - 1]
            t["c_m0"][i] = -a * np.expm1(hh)
            t["c_bh"][i] = -a * np.expm1(hh)
            for j, (rk, r) in enumerate(zip(rks, rho)):
                t["c_rho"][i, j], t["c_rk"][i, j] = r, rk
            t["c_rl"][i] = rho_last
            t["use_c"][i] = 1.0
        h = lam[i + 1] - lam[i]
        hh = -h
        rks = [float((lam[i - j] - lam[i]) / h) for j in range(1, o)]
        rho, _ = _rhos(rks, hh, o, False)
        a = 1.0 - sig[i + 1]
        t["p_x"][i] = sig[i + 1] / sig[i]
        t["p_m0"][i] = -a * np.expm1(hh)
        t["p_bh"][i] = -a * np.expm1(hh)
        for j, (rk, r) in enumerate(zip(rks, rho)):
            t["p_rho"][i, j], t["p_rk"][i, j] = r, rk
        prev = o
    t["sigmas"] = sig
    return t


def step(tab: Dict[str, np.ndarray], i: int, x: torch.Tensor,
         v: torch.Tensor, hist: torch.Tensor, last: torch.Tensor,
         dtype: torch.dtype = torch.float32):
    """One step i from sample x with velocity v; hist [k+1, ...] holds the
    last x0 predictions (oldest first), last the previous corrected
    sample. Returns (x_next, hist', last') in `dtype`."""
    def c(name, j=None):
        a = tab[name][i] if j is None else tab[name][i, j]
        return float(np.float32(a))

    x, v, hist, last = (z.to(dtype) for z in (x, v, hist, last))
    x0 = x - c("sigmas") * v
    m0 = hist[-1]
    k = tab["p_rho"].shape[1]
    if c("use_c") > 0:
        d1 = torch.zeros_like(x)
        for j in range(k):
            d1 = d1 + c("c_rho", j) * (hist[-2 - j] - m0) / c("c_rk", j)
        x = (c("c_x") * last + c("c_m0") * m0
             + c("c_bh") * (d1 + c("c_rl") * (x0 - m0)))
    hist = torch.cat([hist[1:], x0[None]], dim=0)
    d1 = torch.zeros_like(x)
    for j in range(k):
        d1 = d1 + c("p_rho", j) * (hist[-2 - j] - x0) / c("p_rk", j)
    x_next = c("p_x") * x + c("p_m0") * x0 + c("p_bh") * d1
    return x_next, hist, x
