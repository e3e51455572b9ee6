"""The port's training CLIs on the CPU at tiny-test: `teacher_data` writes
the teacher artifact, `train_distill` trains on it for one epoch with a
checkpoint per step, and the checkpoint restores bit-equal (parameters,
EMA, AdamW moments and counts). Both CLIs start from a reference-format
checkpoint directory (`*.safetensors`) holding the reference init with a
random head, so the teacher's velocities and the student's gradients are
not zero. Those checks are exact or of shape and finiteness.

The teacher's CFG velocity (`apt/generate.py:teacher_cfg_velocity`) is
held against the JAX `generate_batch` at TINY_TEST: JAX's artifact (its
jax.random noise, its contexts) goes through the port's function on the
same weights (the port's init with a random head, carried to JAX by the
JAX converter). Both run the default policy (bf16 matmuls, fp32 params),
so the tolerance is a relative L2 error of 2e-2 on velocities that the
guide scale 7.5 amplifies; the data loader's batches equal JAX's."""

import os
import sys
import types

import numpy as np
import pytest
import torch
from safetensors.torch import save_file

from omnihuman_tpu_torch.apt.distill import (
    init_distill_state, make_optimizer, trainable_params)
from omnihuman_tpu_torch.apt.generate import (
    RANDOM_PROMPTS, create_dataloader, teacher_cfg_velocity)
from omnihuman_tpu_torch.cli import teacher_data, train_distill
from omnihuman_tpu_torch.configs.wan import TINY_TEST
from omnihuman_tpu_torch.models.wan_dit import build_wan_model
from omnihuman_tpu_torch.ops.flash_attention import KERNELS
from omnihuman_tpu_torch.ops.rope import rope_angles_3d
from omnihuman_tpu_torch.utils.checkpoint import CheckpointManager

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def dit_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("dit")
    model = build_wan_model(TINY_TEST.model, "cpu", torch.float32, seed=0)
    with torch.no_grad():
        model.head.head.weight.normal_(
            0.0, 0.1, generator=torch.Generator().manual_seed(1))
    save_file(model.state_dict(), str(d / "diffusion_pytorch_model.safetensors"))
    return str(d)


def _equal_trees(a, b, where=""):
    if isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            _equal_trees(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a.cpu(), b.cpu()), where
    else:
        assert a == b, where


def test_teacher_data_then_train_distill_with_checkpoint(dit_dir, tmp_path,
                                                        monkeypatch):
    # no local umT5 tokenizer files here: go straight to the offline hash
    # tokenizer instead of paying ~10 s for the transformers import
    monkeypatch.setitem(sys.modules, "transformers", None)
    data = teacher_data.main([
        "--task", "tiny-test", "--num_samples", "2", "--size", "480*832",
        "--out_dir", str(tmp_path), "--device", "cpu",
        "--checkpoint_dir", dit_dir])
    path = tmp_path / "dummy_data_480x832.npz"
    assert path.exists()
    assert data["noise"].shape == (2, 16, 1, 60, 104)
    assert data["positive_contexts"].shape == (2, 16, 32)
    assert np.isfinite(data["v_teacher"]).all()
    assert np.abs(data["v_teacher"]).max() > 0

    cfg_file = tmp_path / "distill.yaml"
    cfg_file.write_text("num_epochs: 1\nbatch_size: 1\nsave_interval: 1\n")
    out = str(tmp_path / "ckpt")
    state, history = train_distill.main([
        "--task", "tiny-test", "--data_path", str(path), "--output_dir", out,
        "--config", str(cfg_file), "--device", "cpu",
        "--checkpoint_dir", dit_dir])
    assert [h["step"] for h in history] == [1, 2] and state.step == 2
    assert all(h["loss"] > 0 and np.isfinite(h["grad_norm"])
               and h["grad_norm"] > 0 for h in history)
    assert [kn.launches for kn in KERNELS] == [0, 0, 0]

    mgr = CheckpointManager(out)
    assert mgr.all_steps() == [1, 2] and mgr.latest_step() == 2
    assert mgr.restore_metadata(2) == {"epoch": 0}
    assert mgr.restore_metadata(1) is None
    model = build_wan_model(TINY_TEST.model, "cpu", torch.bfloat16,
                            seed=None, trainable=True)
    fresh = mgr.restore(target=init_distill_state(model, make_optimizer()))
    _equal_trees(fresh.state_dict(), state.state_dict())
    assert fresh.step == 2 and fresh.opt_state["count"] == 2
    assert all(p.requires_grad for p in trainable_params(model).values())


@pytest.mark.parametrize("argv, match", [
    (["--fsdp_size", "2"], "item 19"), (["--sp_size", "4"], "item 19"),
    (["--remat_group", "4"], "divide")])
def test_train_distill_refuses_what_one_gpu_cannot_run(argv, match):
    with pytest.raises(ValueError, match=match):
        train_distill.main(["--task", "tiny-test", "--device", "cpu"] + argv)


def test_checkpoint_manager_keeps_the_newest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    assert mgr.restore() is None and mgr.restore_metadata() is None
    for step in (1, 2, 3):
        mgr.save(step, {"w": torch.full((2,), float(step)), "step": step},
                 metadata={"step": step})
    assert mgr.all_steps() == [2, 3]
    assert sorted(os.listdir(tmp_path)) == ["step_00000002", "step_00000003"]
    assert mgr.restore(2)["step"] == 2
    assert torch.equal(mgr.restore()["w"], torch.full((2,), 3.0))
    assert mgr.restore_metadata() == {"step": 3}


def test_teacher_velocity_and_loader_match_jax():
    import jax.numpy as jnp

    from omnihuman_tpu.apt import generate as jgen
    from omnihuman_tpu.configs.wan import TINY_TEST as JAX_TINY
    from omnihuman_tpu.utils.convert import convert_wan_dit

    model = build_wan_model(TINY_TEST.model, "cpu", torch.float32, seed=0)
    with torch.no_grad():
        model.head.head.weight.normal_(
            0.0, 0.1, generator=torch.Generator().manual_seed(2))

    def encode(prompts):     # no tokenizer: seeded random contexts
        r = np.random.default_rng(len(prompts))
        ctx = r.normal(size=(len(prompts), 16, 32)).astype(np.float32)
        return jnp.asarray(ctx), jnp.full((len(prompts),), 16, jnp.int32)

    # what generate_batch reads of a JAX WanT2V: config, params, encode_text
    pipe = types.SimpleNamespace(
        config=JAX_TINY, encode_text=encode,
        params=convert_wan_dit({k: v.numpy() for k, v in
                                model.state_dict().items()}, JAX_TINY.model))
    # one batch: one compile of the JAX teacher
    data = jgen.generate_batch(pipe, num_samples=3, size=(32, 48), batch=3,
                               save=False)
    assert list(jgen.RANDOM_PROMPTS) == RANDOM_PROMPTS

    sin, cos = rope_angles_3d((1, 2, 3), TINY_TEST.model.head_dim, seq_len=6)
    neg = torch.from_numpy(np.array(data["negative_context"]))
    got = teacher_cfg_velocity(
        model, torch.from_numpy(data["noise"]),
        torch.from_numpy(np.array(data["positive_contexts"])),
        neg[None].expand(3, -1, -1), seq_len=6, rope_sin=sin, rope_cos=cos,
        policy=TINY_TEST.policy, t_value=999.0, cfg_scale=7.5).numpy()
    want = data["v_teacher"]
    assert got.shape == want.shape == (3, 16, 1, 4, 6)
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel < 2e-2, rel

    for shuffle in (True, False):
        a = list(create_dataloader(data, batch_size=2, shuffle=shuffle,
                                   seed=3, skip_epochs=1)())
        b = list(jgen.create_dataloader(data, batch_size=2, shuffle=shuffle,
                                        seed=3, skip_epochs=1)())
        assert len(a) == len(b) == 1
        for k in ("noise", "context", "v_teacher"):
            np.testing.assert_array_equal(a[0][k].numpy(), np.asarray(b[0][k]))
