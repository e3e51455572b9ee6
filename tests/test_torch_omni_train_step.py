"""One OmniHuman training step against JAX's `omni_train_step` (velocity
and sample targets): the slow cases of tests/test_torch_omni_train.py
(whose helpers they use), in a file of their own so that a `--dist
loadfile` run schedules them with the files of few tests, beside the
longest ones, instead of before them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from omnihuman_tpu.omni import trainer as jax_trainer
from omnihuman_tpu_torch.omni.trainer import (
    init_omni_train_state, make_lr_schedule, make_omni_optimizer,
    omni_train_step)
from omnihuman_tpu_torch.utils.convert import omni_train_state_from_jax
# fixtures and helpers of the file these cases came from
from test_torch_omni_train import (
    _assert_params_close, _compile_exact, _jax_draws, _jax_step_fn,
    _port_model, _tbatch, B, LR, omni, PCFG, PFP32, TOTAL)


@pytest.mark.parametrize("target", ["velocity", "sample"])
def test_train_step_matches_jax(omni, target):
    """Loss and grad norm (rtol 1e-5) and the parameters after one step
    (atol 1e-2 * lr); for the velocity target also a second step resumed
    from JAX's state through `omni_train_state_from_jax`."""
    params, batch = omni
    jopt, jstep = _jax_step_fn(target)
    jparams = jax.tree.map(jnp.asarray, params)
    state0 = jax_trainer.OmniTrainState(
        params=jparams, opt_state=jax.jit(jopt.init)(jparams),
        step=jnp.asarray(0, jnp.int32))
    jbatch = jax.tree.map(jnp.asarray, batch)
    keys = jax.random.split(jax.random.key(3), 2)
    exe = _compile_exact(jstep, state0, jbatch, keys[0])
    state1, m1 = exe(state0, jbatch, keys[0])

    model = _port_model(params)
    opt = make_omni_optimizer(make_lr_schedule("cosine", LR, TOTAL))
    pstate = init_omni_train_state(model, opt)
    tb = _tbatch(batch)
    masks, t, noise = _jax_draws(keys[0])
    assert 0 < sum(float(m.sum()) for m in masks.values()) < 3 * B
    pstate, pm = omni_train_step(pstate, tb, masks, t, noise, optimizer=opt,
                                 policy=PFP32, target=target, remat=True)
    np.testing.assert_allclose(float(pm["loss"]), float(m1["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(pm["grad_norm"]),
                               float(m1["grad_norm"]), rtol=1e-5)
    assert pstate.step == 1 and pstate.opt_state["count"] == 1
    _assert_params_close(model, state1.params, 1e-2 * LR)
    if target != "velocity":
        return

    state2, m2 = exe(state1, jbatch, keys[1])
    pstate.load_state_dict(omni_train_state_from_jax(
        jax.tree.map(np.asarray, state1), PCFG))
    assert pstate.step == 1 and pstate.opt_state["count"] == 1
    masks, t, noise = _jax_draws(keys[1])
    pstate, pm = omni_train_step(pstate, tb, masks, t, noise, optimizer=opt,
                                 policy=PFP32, target=target, remat=True)
    np.testing.assert_allclose(float(pm["loss"]), float(m2["loss"]),
                               rtol=1e-5)
    assert pstate.step == 2
    _assert_params_close(model, state2.params, 1e-2 * LR)
