"""The port's flow-matching solvers against the JAX package: the float64
coefficient plans must be equal, and steps driven by identical fake
velocities must agree to fp32 1e-6."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnihuman_tpu.samplers import fm_solvers as jax_fm
from omnihuman_tpu_torch.samplers import fm_solvers as fm

torch.set_num_threads(1)


@pytest.mark.parametrize("steps,shift", [(50, 5.0), (4, 3.0), (1, 5.0)])
def test_sigmas_and_timesteps_match_jax(steps, shift):
    np.testing.assert_array_equal(fm.get_sampling_sigmas(steps, shift),
                                  jax_fm.get_sampling_sigmas(steps, shift))
    for a, b in zip(fm.retrieve_timesteps(steps, shift),
                    jax_fm.retrieve_timesteps(steps, shift)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("planner,kw", [
    ("plan_unipc", dict(steps=50, shift=5.0)),
    ("plan_unipc", dict(steps=5, shift=3.0, order=3)),
    ("plan_unipc", dict(steps=6, shift=5.0, solver_type="bh1",
                        disable_corrector=(2,))),
    ("plan_dpm", dict(steps=50, shift=5.0)),
    ("plan_dpm", dict(steps=5, shift=3.0, solver_type="heun")),
])
def test_plans_match_jax(planner, kw):
    ours = getattr(fm, planner)(**kw)
    theirs = getattr(jax_fm, planner)(**kw)
    for f in dataclasses.fields(theirs):
        a, b = getattr(ours, f.name), getattr(theirs, f.name)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


@pytest.mark.parametrize("kind", ["unipc", "dpm++"])
def test_five_steps_match_jax(kind):
    rng = np.random.default_rng(0)
    shape = (1, 4, 2, 3, 3)
    x0 = rng.normal(size=shape).astype(np.float32)
    vs = [rng.normal(size=shape).astype(np.float32) for _ in range(5)]
    sol_j = jax_fm.get_solver(kind, 5, 5.0)
    sol_t = fm.get_solver(kind, 5, 5.0)
    xj, sj = jnp.asarray(x0), sol_j.init_state(jnp.asarray(x0))
    xt, st = torch.from_numpy(x0), sol_t.init_state(torch.from_numpy(x0))
    for i, v in enumerate(vs):
        xj, sj = sol_j.step(sj, jnp.asarray(v), xj, i)
        xt, st = sol_t.step(st, torch.from_numpy(v), xt, i)
        np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=1e-6,
                                   err_msg=f"step {i}")
    np.testing.assert_allclose(sol_t.timesteps, sol_j.timesteps)
