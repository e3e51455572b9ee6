"""The APT taps and the D and G steps against JAX's: the slow cases of
tests/test_torch_apt.py (whose helpers they use), in a file of their own
so that a `--dist loadfile` run schedules them with the files of few
tests, beside the longest ones, instead of before them."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from omnihuman_tpu.apt import apt_trainer as jtr
from omnihuman_tpu.models.wan_dit import wan_model_forward
from omnihuman_tpu_torch.apt import apt_trainer as tr
from omnihuman_tpu_torch.apt.distill import trainable_params
from omnihuman_tpu_torch.utils.convert import (
    apt_discriminator_state_dict_from_jax, wan_dit_state_dict_from_jax)
# fixtures and helpers of the file these cases came from
from test_torch_apt import (
    _assert_close_tree, _compiled, _jax_kw, _jax_step, _port_models, _rope,
    _tensors, B, CFG, LR, SEQ, setup)


def test_collect_layers_taps_match_jax(setup):
    params, _, batch = setup
    t = np.array([700.0, 20.0], np.float32)
    v_want, taps_want = _compiled(functools.partial(
        wan_model_forward, collect_layers=(0, 2), remat=False, **_jax_kw()),
        jax.tree.map(jnp.asarray, params), jnp.asarray(batch["real"]),
        jnp.asarray(t), jnp.asarray(batch["context"]))
    g, _ = _port_models(params, setup[1])
    v, taps = g(torch.from_numpy(batch["real"]), torch.from_numpy(t),
                torch.from_numpy(batch["context"]), collect_layers=(0, 2),
                **_rope())
    assert sorted(taps) == [0, 2] and taps[0].shape == (B, SEQ, CFG.dim)
    np.testing.assert_allclose(v.detach().numpy(), np.asarray(v_want),
                               atol=1e-5)
    for i in (0, 2):
        np.testing.assert_allclose(taps[i].detach().numpy(),
                                   np.asarray(taps_want[i]), atol=1e-5)


def test_d_step_matches_jax_with_the_same_draws(setup):
    params, d_params, batch = setup
    apt_cfg = jtr.SeaweedAPTConfig(lambda_r1=1.0)
    key = jax.random.key(3)

    def draws(k):          # apt_d_step's: split, then t_norm and R1 noise
        k_t, k_r1 = jax.random.split(k)
        return (jax.random.uniform(k_t, (B,)),
                jax.random.normal(k_r1, batch["real"].shape))

    jstate, jm, (t_norm, noise) = _jax_step(functools.partial(
        jtr.apt_d_step, apt_cfg=apt_cfg, video=True,
        d_optimizer=jtr.make_d_optimizer(LR, d_params), **_jax_kw()),
        draws, params, d_params, batch, key)
    t_norm, noise = np.array(t_norm), np.array(noise)

    g, disc = _port_models(params, d_params)
    state = tr.init_apt_state(g, disc, LR, LR)
    state, m = tr.d_step_with_draws(
        state, _tensors(batch), torch.from_numpy(t_norm),
        torch.from_numpy(noise), apt_cfg=tr.SeaweedAPTConfig(lambda_r1=1.0),
        video=True, d_optimizer=tr.make_d_optimizer(LR, disc), **_rope())
    for k in ("d_loss", "r1_loss", "d_total"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5,
                                   err_msg=k)
    want = apt_discriminator_state_dict_from_jax(
        jax.tree.map(np.asarray, jstate.d_params), CFG)
    _assert_close_tree(dict(state.disc.named_parameters()), want, 1e-6, "D")
    # the backbone did not move, and only the probes and head hold state
    for n, p in trainable_params(g).items():
        assert torch.equal(state.disc.backbone.get_parameter(n), p), n
    assert not any(n.startswith("backbone.") for n in state.d_opt["nu"])
    assert set(state.d_opt["nu"]) == set(tr.d_trainable_params(disc))


def test_g_step_matches_jax_with_the_same_draws(setup):
    """The generator's gradient flows through the discriminator's frozen
    backbone (stop_features=False), with per-block remat on both sides."""
    params, d_params, batch = setup
    apt_cfg = jtr.SeaweedAPTConfig()
    key = jax.random.key(4)
    jstate, jm, t_norm = _jax_step(functools.partial(
        jtr.apt_g_step, apt_cfg=apt_cfg, video=False,
        g_optimizer=jtr.make_rmsprop(LR), remat=True, **_jax_kw()),
        lambda k: jax.random.uniform(k, (B,)),     # apt_g_step's draw
        params, d_params, batch, key)
    t_norm = np.array(t_norm)

    g, disc = _port_models(params, d_params)
    before = {n: p.detach().clone() for n, p in trainable_params(g).items()}
    state = tr.init_apt_state(g, disc, LR, LR)
    state, m = tr.g_step_with_draws(
        state, _tensors(batch), torch.from_numpy(t_norm),
        apt_cfg=tr.SeaweedAPTConfig(), video=False,
        g_optimizer=tr.make_rmsprop(LR), remat=True, **_rope())
    np.testing.assert_allclose(float(m["g_loss"]), float(jm["g_loss"]),
                               rtol=1e-5)
    assert state.step == int(jstate.step) == 1
    got = trainable_params(state.g_model)
    _assert_close_tree(got, wan_dit_state_dict_from_jax(
        jax.tree.map(np.asarray, jstate.g_params), CFG), 1e-6, "G")
    _assert_close_tree(state.ema_params, wan_dit_state_dict_from_jax(
        jax.tree.map(np.asarray, jstate.ema_params), CFG), 1e-6, "EMA")
    # the adversarial gradient reached the blocks, not only the head
    assert not torch.equal(got["blocks.0.self_attn.q.weight"],
                           before["blocks.0.self_attn.q.weight"])
    for n, p in state.disc.backbone.named_parameters():
        assert torch.equal(p, before[n]), n
