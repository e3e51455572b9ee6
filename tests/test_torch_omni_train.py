"""The port's OmniHuman trainer against the JAX package, on the CPU at the
JAX tests' small omni config (dim 32, 2 layers, audio_dim 20, 8
keypoints, 8 temporal rows) with fp32 parameters and compute.

  - `make_lr_schedule` against optax at steps 0, 1, mid and the end, for
    the cosine, linear and constant kinds (rtol 1e-6: the same fp32
    formulas);
  - one `omni_train_step` with JAX's draws injected (`split(key, 3)`, then
    `fold_in(k_mask, i)` for mask i, `uniform`, `normal`): the loss and
    the grad norm at rtol 1e-5, for the velocity and the sample target;
    the parameters after that step, and after a second step resumed from
    JAX's state through `omni_train_state_from_jax` (params, AdamW mu, nu
    and count), within atol 1e-2 * lr of JAX's. The JAX step is one
    program compiled with `xla_allow_excess_precision` off (as in
    tests/test_torch_omni.py); JAX runs it without remat, the port with
    per-block remat (the same arithmetic recomputed);
  - the trainer's stage loop and stage-aware resume, as
    tests/test_omni.py:163-235 holds JAX's: a final stage resumes at the
    next stage, clamped to the last, and a checkpoint without metadata
    takes the stage of its global step.

The same weights go to both packages (the JAX init with a random head,
adapter `o`, gate and `pose_proj`: zero-initialised, they would leave
the conditions without gradient signal)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnihuman_tpu.configs.wan import DTypePolicy as JaxPolicy
from omnihuman_tpu.configs.wan import WanModelConfig as JaxWanCfg
from omnihuman_tpu.omni.model import OmniModelConfig as JaxOmniCfg
from omnihuman_tpu.omni.model import init_omni_model
from omnihuman_tpu.omni import trainer as jax_trainer
from omnihuman_tpu_torch.configs.wan import DTypePolicy, WanModelConfig
from omnihuman_tpu_torch.omni.model import OmniModelConfig, build_omni_model
from omnihuman_tpu_torch.omni.trainer import (
    MASKED_CONDITIONS, OmniHumanTrainer, StageConfig, make_lr_schedule,
    make_omni_optimizer, omni_train_step)
from omnihuman_tpu_torch.utils.checkpoint import CheckpointManager
from omnihuman_tpu_torch.utils.convert import omni_state_dict_from_jax

torch.set_num_threads(1)

BASE = dict(dim=32, ffn_dim=64, num_heads=4, num_layers=2, freq_dim=16,
            text_dim=24, text_len=8)
JCFG = JaxOmniCfg(base=JaxWanCfg(**BASE), audio_dim=20, num_keypoints=8,
                  num_frames=8)
PCFG = OmniModelConfig(base=WanModelConfig(**BASE), audio_dim=20,
                       num_keypoints=8, num_frames=8)
JFP32 = JaxPolicy(compute=jnp.float32)
PFP32 = DTypePolicy(compute=torch.float32)
B, C, F, H, W = 2, 16, 2, 8, 8
LR, TOTAL = 1e-3, 10
RATIOS = {"text": 1.0, "reference": 0.5, "audio": 0.5, "pose": 0.5}


def _randomise(params, rng):
    def rnd(a, scale):
        return (rng.normal(size=np.shape(a)) * scale).astype(np.float32)

    base, cond = params["base"], params["cond"]
    base["head"]["w"] = rnd(base["head"]["w"], 0.1)
    ad = base["blocks"]["audio_attn"]
    ad["o"]["w"] = rnd(ad["o"]["w"], 0.2)
    ad["gate"] = (1.0 + rnd(ad["gate"], 0.3)).astype(np.float32)
    cond["pose_proj"]["w"] = rnd(cond["pose_proj"]["w"], 0.2)
    return params


@pytest.fixture(scope="module")
def omni():
    # one jitted init: eager, each of its ops would compile on its own
    params = jax.tree.map(np.asarray, jax.jit(
        lambda k: init_omni_model(k, JCFG))(jax.random.key(0)))
    params = _randomise(params, np.random.default_rng(1))
    rng = np.random.default_rng(0)
    batch = {
        "frames": rng.normal(size=(B, C, F, H, W)).astype(np.float32),
        "context": rng.normal(size=(B, 8, 24)).astype(np.float32),
        "audio": rng.normal(size=(B, 4, 20)).astype(np.float32),
        "pose": (rng.normal(size=(B, 8, F, 2 * H, 2 * W)) * 0.1
                 ).astype(np.float32),
        "reference": rng.normal(size=(B, C, 1, H, W)).astype(np.float32),
    }
    return params, batch


def _port_model(params):
    model = build_omni_model(PCFG, "cpu", torch.float32, seed=None,
                             trainable=True)
    with torch.no_grad():
        model.load_state_dict(omni_state_dict_from_jax(params, PCFG),
                              strict=True)
    return model


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@jax.jit
def _draws(key):
    k_mask, k_t, k_noise = jax.random.split(key, 3)
    masks = {name: (jax.random.uniform(jax.random.fold_in(k_mask, i), (B,))
                    < RATIOS[name]).astype(jnp.float32)
             for i, name in enumerate(MASKED_CONDITIONS)}
    t = jax.random.uniform(k_t, (B,), minval=1e-4, maxval=1.0 - 1e-4)
    return masks, t, jax.random.normal(k_noise, (B, C, F, H, W))


def _jax_draws(key):
    """The draws of JAX `omni_train_step` (trainer.py:151-157 and the
    loss's noise), as tensors."""
    masks, t, noise = _draws(key)
    return ({k: torch.tensor(np.asarray(v)) for k, v in masks.items()},
            torch.tensor(np.asarray(t)), torch.tensor(np.asarray(noise)))


def _jax_step_fn(target):
    opt = jax_trainer.make_omni_optimizer(
        jax_trainer.make_lr_schedule("cosine", LR, TOTAL))

    def step(state, batch, key):
        return jax_trainer.omni_train_step(
            state, batch, RATIOS, key, optimizer=opt, cfg=JCFG, policy=JFP32,
            target=target, remat=False)
    return opt, step


def _compile_exact(fn, *args):
    return jax.jit(fn).lower(*args).compile(
        {"xla_allow_excess_precision": False})


def _assert_params_close(port_model, jax_params, atol):
    want = omni_state_dict_from_jax(jax.tree.map(np.asarray, jax_params),
                                    PCFG)
    got = dict(port_model.named_parameters())
    worst = max((got[n].detach() - w).abs().max().item()
                for n, w in want.items())
    assert worst <= atol, worst


@pytest.mark.parametrize("kind", ["cosine", "linear", "constant"])
def test_lr_schedule_matches_optax(kind):
    total = 37
    ours = make_lr_schedule(kind, 3e-4, total)
    ref = jax.jit(jax_trainer.make_lr_schedule(kind, 3e-4, total))
    for count in (0, 1, total // 2, total - 1, total):
        want = float(ref(jnp.asarray(count, jnp.int32)))
        assert ours(count) == pytest.approx(want, rel=1e-6, abs=0.0), count


# ---------------------------------------------------------------------------
# the stage loop and resume (port only, as tests/test_omni.py holds JAX's)


def _trainer(omni, stages, ckpt_dir, writer=None, interval=100):
    params, _ = omni
    return OmniHumanTrainer(
        _port_model(params), PCFG, stages=stages, learning_rate=1e-4,
        checkpoint_dir=str(ckpt_dir), checkpoint_interval=interval,
        log_interval=1, policy=PFP32, metric_writer=writer)


def _forever(batch):
    def factory(stage_idx):
        while True:
            yield batch
    return factory


S1 = StageConfig("s1", 3, {"text": 1.0, "reference": 1.0, "audio": 0.0,
                           "pose": 0.0})


def test_trainer_stage_loop(tmp_path, omni):
    _, batch = omni
    stages = (S1, StageConfig("s2", 2, {"text": 1.0, "reference": 1.0,
                                        "audio": 0.5, "pose": 0.13}))
    seen = []
    tr = _trainer(omni, stages, tmp_path / "ck",
                  lambda m, s: seen.append((s, m)))
    tr.train(_forever(_tbatch(batch)), seed=0)
    assert tr.state.step == 5
    assert [s for s, _ in seen] == [1, 2, 3, 4, 5]
    assert [m["stage"] for _, m in seen] == [0, 0, 0, 1, 1]
    assert all(np.isfinite(m["loss"]) for _, m in seen)
    # stage-final saves only (interval 100), metadata as JAX writes it
    assert tr.ckpt.all_steps() == [3, 5]
    assert tr.ckpt.restore_metadata(3) == {"stage": 0, "final": True}
    # a final last stage resumes clamped to the last stage
    assert tr.load_checkpoint() == (5, 1)


def test_trainer_stage_aware_resume(tmp_path, omni):
    """Killed mid stage 2: a fresh trainer resumes in stage 2 at its
    offset; resuming after the end takes no step."""
    _, batch = omni
    tb = _tbatch(batch)
    stages = (S1, StageConfig("s2", 4, {"text": 1.0, "reference": 1.0,
                                        "audio": 0.5, "pose": 0.0}))

    def crashing(stage_idx):
        return iter([tb] * (100 if stage_idx == 0 else 2))

    t1 = _trainer(omni, stages, tmp_path / "ck", interval=2)
    with pytest.raises(StopIteration):
        t1.train(crashing, seed=0)
    assert t1.state.step == 5       # 3 (s1) + 2 (s2, saved at step 5)
    assert t1.ckpt.restore_metadata(5) == {"stage": 1, "final": False}

    seen_stages = []
    t2 = _trainer(omni, stages, tmp_path / "ck",
                  lambda m, s: seen_stages.append(m["stage"]), interval=2)
    t2.train(lambda si: iter([tb] * 100), seed=0, resume=True)
    assert t2.state.step == 7       # 3 + 4, not re-run from 0
    assert set(seen_stages) == {1}
    assert t2.load_checkpoint() == (7, 1)
    restored = t2.state.state_dict()
    assert restored["opt_state"]["count"] == 7

    t3 = _trainer(omni, stages, tmp_path / "ck", interval=2)
    t3.train(lambda si: iter([]), seed=0, resume=True)
    assert t3.state.step == 7


@pytest.mark.parametrize("gstep, stage", [(2, 0), (3, 1), (6, 1), (9, 1)])
def test_resume_without_metadata_derives_stage(tmp_path, omni, gstep, stage):
    """A checkpoint without stage metadata resumes in the stage its global
    step falls in (the last one past the schedule)."""
    stages = (S1, StageConfig("s2", 4, {"text": 1.0, "reference": 1.0,
                                        "audio": 0.5, "pose": 0.0}))
    tr = _trainer(omni, stages, tmp_path / "ck")
    tr.state.step = gstep
    CheckpointManager(str(tmp_path / "ck")).save(gstep, tr.state)
    fresh = _trainer(omni, stages, tmp_path / "ck")
    assert fresh.load_checkpoint() == (gstep, stage)
    assert fresh.state.step == gstep
