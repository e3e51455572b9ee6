"""The port's Seaweed-APT training CLIs on the CPU at tiny-test, the twin of
tests/test_train_cli.py: `cli.train_apt` (phases, checkpoint cadence and
metadata, metrics on disk, resume after completion and after a lost video
checkpoint, gradient accumulation) and `cli.train_f_distill` (cadence,
epoch metadata, resume with nothing pending, a mid-epoch resume that ends
where the uninterrupted run does, the discriminator switched off).

Against the JAX CLI: on the same npz and seed, `cli.train_apt` draws the
same batch indices and the same noise from numpy, update by update (the
JAX run's D / G steps are replaced by pass-throughs and its checkpoints by
a stub: only its numpy draws are compared). The D / G steps' own draws
come from another generator in each package, so losses are held only to
be finite. The mid-epoch resume is exact: the restored state is bit-equal
and the CPU step deterministic, so the final parameters agree to atol
1e-7 (they are equal)."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from omnihuman_tpu_torch.cli import train_apt, train_f_distill
from omnihuman_tpu_torch.utils.checkpoint import CheckpointManager

torch.set_num_threads(1)

N, Z, F, H, W = 4, 16, 1, 4, 4   # tiny-test latent geometry
TEXT_LEN, TEXT_DIM = 16, 32


@pytest.fixture(scope="module")
def teacher_npz(tmp_path_factory):
    """A teacher artifact with the keys `cli.teacher_data` stores."""
    d = tmp_path_factory.mktemp("teacher")
    rng = np.random.default_rng(0)
    noise = rng.normal(size=(N, Z, F, H, W)).astype(np.float32)
    v = (rng.normal(size=(N, Z, F, H, W)) * 0.1).astype(np.float32)
    ctx = (rng.normal(size=(N, TEXT_LEN, TEXT_DIM)) * 0.1).astype(np.float32)
    neg = (rng.normal(size=(TEXT_LEN, TEXT_DIM)) * 0.1).astype(np.float32)
    path = str(d / "teacher.npz")
    np.savez(path, dummy_data=noise, noise=noise,
             dummy_prompts=np.asarray(["p"] * N), positive_contexts=ctx,
             negative_context=neg, v_teacher=v)
    return path


@pytest.fixture(scope="module")
def dit_dir(tmp_path_factory):
    """The reference init with a random head as a `*.safetensors`
    checkpoint directory (the zero-initialised head makes every velocity,
    and the f-divergence loss, 0)."""
    from safetensors.torch import save_file

    from omnihuman_tpu_torch.configs.wan import TINY_TEST
    from omnihuman_tpu_torch.models.wan_dit import build_wan_model
    d = tmp_path_factory.mktemp("dit")
    model = build_wan_model(TINY_TEST.model, "cpu", torch.float32, seed=0)
    with torch.no_grad():
        model.head.head.weight.normal_(
            0.0, 0.1, generator=torch.Generator().manual_seed(1))
    save_file(model.state_dict(),
              str(d / "diffusion_pytorch_model.safetensors"))
    return str(d)


def _metrics_records(out_dir):
    recs = []
    for f in os.listdir(out_dir):
        if f.startswith("metrics_") and f.endswith(".jsonl"):
            with open(os.path.join(out_dir, f)) as fh:
                recs += [json.loads(line) for line in fh if line.strip()]
    return recs


def _apt_argv(npz, out):
    return ["--task", "tiny-test", "--data_path", npz, "--output_dir", out,
            "--batch_size", "2", "--image_updates", "3", "--video_updates",
            "2", "--save_interval", "2", "--seed", "0", "--device", "cpu"]


def test_train_apt_cli_phases_checkpoints_resume(teacher_npz, tmp_path):
    out = str(tmp_path / "apt")
    argv = _apt_argv(teacher_npz, out)
    state, history = train_apt.main(argv)

    ckpt = CheckpointManager(out)
    # image cadence @2, image final @3, video final @5 (offset 3 + 2); the
    # video cadence @2 is suppressed: it coincides with the final
    assert ckpt.all_steps() == [2, 3, 5]
    assert ckpt.restore_metadata(2) == {"phase": "image", "update": 2}
    assert ckpt.restore_metadata(3) == {
        "phase": "image", "update": 3, "final": True}
    assert ckpt.restore_metadata(5) == {
        "phase": "video", "update": 2, "final": True}
    recs = _metrics_records(out)
    assert len(recs) == len(history) == 5       # one per update
    assert [r["step"] for r in recs] == [1, 2, 3, 4, 5]
    assert [r["phase"] for r in recs] == [0.0] * 3 + [1.0] * 2
    assert all(np.isfinite(r[k]) for r in recs
               for k in ("g_loss", "d_loss", "r1_loss"))
    assert state.step == 2                      # reset at the handoff
    final = ckpt.restore(5)
    for n, p in final["ema_params"].items():
        torch.testing.assert_close(p, state.ema_params[n], rtol=0, atol=0)

    # resume after completion: early exit, nothing new written
    _, history = train_apt.main(argv + ["--resume"])
    assert history == [] and ckpt.all_steps() == [2, 3, 5]

    # a lost video final: the latest is the image final, so the resume
    # makes the EMA handoff and runs the video phase again
    shutil.rmtree(os.path.join(out, "step_00000005"))
    assert ckpt.latest_step() == 3
    _, history = train_apt.main(argv + ["--resume"])
    assert [h["update"] for h in history] == [1, 2]
    assert ckpt.all_steps() == [2, 3, 5]
    assert ckpt.restore_metadata(5) == {
        "phase": "video", "update": 2, "final": True}


def test_train_apt_cli_refuses_unreadable_metadata(teacher_npz, tmp_path):
    out = tmp_path / "apt"
    CheckpointManager(str(out)).save(4, {"w": torch.zeros(1)})
    os.remove(out / "step_00000004" / "meta.json")
    with pytest.raises(RuntimeError, match="no readable metadata"):
        train_apt.main(_apt_argv(teacher_npz, str(out)) + ["--resume"])


def test_train_apt_cli_grad_accumulation(teacher_npz, tmp_path):
    out = str(tmp_path / "apt")
    train_apt.main(_apt_argv(teacher_npz, out) + ["--grad_accumulation",
                                                  "2"])
    mgr = CheckpointManager(out)
    image = mgr.restore(3)              # 3 micro-batches: 1 update + 1
    assert (image["g_opt"]["gradient_step"], image["g_opt"]["mini_step"]) \
        == (1, 1)
    assert (image["d_opt"]["gradient_step"], image["d_opt"]["mini_step"]) \
        == (1, 1)
    assert set(image["d_opt"]["acc_grads"]) == set(image["d_params"])
    video = mgr.restore(5)              # fresh optimizers, 2 micro-batches
    assert (video["g_opt"]["gradient_step"], video["g_opt"]["mini_step"]) \
        == (1, 0)
    assert all(float(a.abs().max()) == 0.0
               for a in video["g_opt"]["acc_grads"].values())


def _fd_argv(inputs, out, *extra):
    npz, dit_dir = inputs
    return ["--task", "tiny-test", "--data_path", npz, "--checkpoint_dir",
            dit_dir, "--output_dir", out,
            "--batch_size", "2", "--learning_rate", "1e-4",
            "--f_divergence", "jensen-shannon", "--device", "cpu", *extra]


@pytest.fixture
def fd_inputs(teacher_npz, dit_dir):
    return teacher_npz, dit_dir


def test_train_f_distill_cli(fd_inputs, tmp_path):
    out = str(tmp_path / "fd")
    argv = _fd_argv(fd_inputs, out, "--num_epochs", "2",
                    "--save_interval", "2")
    state, history = train_f_distill.main(argv)

    ckpt = CheckpointManager(out)
    # 4 samples / batch 2: 2 steps an epoch, saves @2 and @4, no epoch-end
    # save on top
    assert ckpt.all_steps() == [2, 4]
    assert ckpt.restore_metadata(2) == {"epoch": 0}
    assert ckpt.restore_metadata(4) == {"epoch": 1}
    assert [h["step"] for h in history] == [1, 2, 3, 4] and state.step == 4
    recs = _metrics_records(out)
    assert [r["step"] for r in recs] == [1]    # the first step, then every 5
    for h in history:
        assert np.isfinite(h["loss"]) and h["f_div_loss"] > 0
        assert 0.01 <= h["density_ratio_mean"] <= 100.0

    # resume: no epoch pending, nothing new
    _, history = train_f_distill.main(argv + ["--resume"])
    assert history == [] and ckpt.all_steps() == [2, 4]


def test_train_f_distill_mid_epoch_resume(fd_inputs, tmp_path):
    full = str(tmp_path / "full")
    argv = lambda out: _fd_argv(fd_inputs, out, "--num_epochs", "2",
                                "--save_interval", "1")
    train_f_distill.main(argv(full))
    assert CheckpointManager(full).all_steps() == [1, 2, 3, 4]
    # interrupted after step 1, mid-epoch 0
    cut = tmp_path / "cut"
    cut.mkdir()
    shutil.copytree(os.path.join(full, "step_00000001"),
                    cut / "step_00000001")
    state, history = train_f_distill.main(argv(str(cut)) + ["--resume"])
    assert [h["step"] for h in history] == [2, 3, 4] and state.step == 4
    want = CheckpointManager(full).restore(4)
    got = CheckpointManager(str(cut)).restore(4)
    for key in ("params", "d_params"):
        for n, p in want[key].items():
            torch.testing.assert_close(got[key][n].float(), p.float(),
                                       rtol=0, atol=1e-7)
    assert got["opt_state"]["count"] == want["opt_state"]["count"] == 4


def test_train_f_distill_no_discriminator(fd_inputs, tmp_path):
    out = str(tmp_path / "fd_nod")
    _, history = train_f_distill.main(_fd_argv(
        fd_inputs, out, "--num_epochs", "1", "--save_interval", "10",
        "--use_discriminator", "false"))
    recs = _metrics_records(out)
    assert recs and history
    for r in recs + history:
        assert r["d_loss"] == 0.0 and r["density_ratio_mean"] == 1.0
    assert CheckpointManager(out).restore_metadata() == {
        "epoch": 0, "final": True}
