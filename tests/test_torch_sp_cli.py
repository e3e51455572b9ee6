"""The port's four training CLIs on a (1, 2, 2) mesh of 4 gloo processes
(tests/torch_sp_workers.py, spawned once for the file), as torchrun would
start them with --fsdp_size 2 --sp_size 2 --device cpu, at tiny-test.

  - `train_distill` (2 steps of batch 2, --remat_group 2) against JAX's
    `train_distill` on its (2, 2, 2) mesh of the 8 virtual CPU devices,
    from one teacher `.npz` and one reference checkpoint directory (a
    random head): the per-step losses agree within rtol 2e-2 (both run
    the CLI's bf16 policy; the rounding order differs). JAX's batch is
    split over data 2, the port's whole on each of its sp ranks: the
    global mean is the same. Its last checkpoint, written by rank 0,
    restores in this process to the state the mesh returned, bit for bit;
  - `train_f_distill`, `train_apt` (one image and one video update, from
    the distill run's EMA) and `train_omni` (`run` on synthetic samples,
    two stages of one step) run on the same mesh: finite losses, the
    checkpoints they promise, and every write on rank 0."""

import functools
import json
import os

import jax
import numpy as np
import pytest
import torch
from safetensors.torch import save_file

from omnihuman_tpu.apt import distill as jd
from omnihuman_tpu.cli import train_distill as jax_train_distill
from omnihuman_tpu_torch.apt.distill import (
    init_distill_state, make_optimizer)
from omnihuman_tpu_torch.configs.wan import TINY_TEST
from omnihuman_tpu_torch.models.vae import build_vae
from omnihuman_tpu_torch.models.wan_dit import build_wan_model
from omnihuman_tpu_torch.utils.checkpoint import CheckpointManager
from torch_sp_workers import Ranks

torch.set_num_threads(1)

N, LATENT = 4, (16, 1, 6, 6)       # 9 tokens, padded to 10 on sp 2


def _files(tmp):
    """The reference checkpoint directory (DiT with a random head, the VAE
    JAX's WanT2V requires) and the teacher artifact."""
    d = tmp / "dit"
    d.mkdir()
    model = build_wan_model(TINY_TEST.model, "cpu", torch.float32, seed=0)
    with torch.no_grad():
        model.head.head.weight.normal_(
            0.0, 0.1, generator=torch.Generator().manual_seed(1))
    save_file(model.state_dict(),
              str(d / "diffusion_pytorch_model.safetensors"))
    vae = build_vae(TINY_TEST.vae, "cpu", torch.float32, seed=1)
    torch.save(vae.state_dict(), str(d / "Wan2.1_VAE.pth"))
    rng = np.random.default_rng(0)
    cfg = TINY_TEST.model
    npz = tmp / "teacher.npz"
    np.savez(npz, noise=rng.normal(size=(N,) + LATENT).astype(np.float32),
             positive_contexts=rng.normal(size=(N, cfg.text_len,
                                                cfg.text_dim)
                                          ).astype(np.float32),
             negative_context=rng.normal(size=(cfg.text_len, cfg.text_dim)
                                         ).astype(np.float32),
             v_teacher=rng.normal(size=(N,) + LATENT).astype(np.float32))
    yaml = tmp / "omni.yaml"
    yaml.write_text(f"""
project: omni-test
run_name: mesh
model:
  audio_dim: 24
  num_keypoints: 8
  num_frames: 2
data:
  frame_size: [32, 32]
training:
  output_dir: {tmp / "out" / "omni"}
  batch_size: 2
  learning_rate: 1.0e-3
  checkpoint_interval: 50
  log_interval: 1
stages:
  - name: text_reference
    num_steps: 1
    condition_ratios: {{text: 1.0, reference: 1.0, audio: 0.0, pose: 0.0}}
  - name: text_reference_audio
    num_steps: 1
    condition_ratios: {{text: 1.0, reference: 1.0, audio: 1.0, pose: 0.0}}
""")
    return str(d), str(npz), str(yaml)


def _jax_losses(dit, npz, out):
    """JAX's train_distill on (2, 2, 2): the loss of each step, read from
    the jitted step it builds."""
    losses = []
    real_jit = jax.jit

    def recording_jit(fn, *a, **kw):
        jitted = real_jit(fn, *a, **kw)
        if not (isinstance(fn, functools.partial)
                and fn.func is jd.distill_train_step):
            return jitted

        def step(*args):
            state, m = jitted(*args)
            losses.append(float(m["loss"]))
            return state, m
        return step

    jax.jit = recording_jit
    try:
        jax_train_distill.main([
            "--task", "tiny-test", "--checkpoint_dir", dit, "--data_path",
            npz, "--output_dir", out, "--num_epochs", "1", "--batch_size",
            "2", "--save_interval", "100", "--fsdp_size", "2", "--sp_size",
            "2", "--remat_group", "2"])
    finally:
        jax.jit = real_jit
    return losses


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sp_cli")
    dit, npz, yaml = _files(tmp)
    p = {"dit": dit, "npz": npz, "omni_yaml": yaml, "out": str(tmp / "out"),
         "omni_geometry": (5, 32, 24)}      # pixel frames, size, audio dim
    ranks = Ranks(4, "train_clis", p, tmp)
    want = _jax_losses(dit, npz, str(tmp / "jax_out"))
    return ranks.results(), want, p


def test_train_distill_on_the_mesh_matches_jax_step_for_step(runs):
    ranks, want, _ = runs
    hist = ranks[0]["distill"]["history"]
    assert [h["step"] for h in hist] == [1, 2] and len(want) == 2
    got = [h["loss"] for h in hist]
    np.testing.assert_allclose(got, want, rtol=2e-2)
    assert all(np.isfinite(h["grad_norm"]) and h["grad_norm"] > 0
               for h in hist)
    for r in ranks[1:]:            # every rank logs the global loss
        assert [h["loss"] for h in r["distill"]["history"]] == got


def test_mesh_checkpoint_resumes_in_one_process(runs):
    ranks, _, p = runs
    mgr = CheckpointManager(os.path.join(p["out"], "distill"))
    assert mgr.all_steps() == [1, 2]
    model = build_wan_model(TINY_TEST.model, "cpu", torch.bfloat16,
                            seed=None, trainable=True)
    fresh = mgr.restore(target=init_distill_state(model, make_optimizer()))
    want = ranks[0]["distill"]["state"]
    assert fresh.step == want["step"] == 2
    got = fresh.state_dict()
    for part in ("params", "ema_params"):
        for n, w in want[part].items():
            assert torch.equal(got[part][n].detach(), w), (part, n)
    for k in ("mu", "nu"):
        for n, w in want["opt_state"][k].items():
            assert torch.equal(got["opt_state"][k][n], w), (k, n)


def test_the_other_training_clis_run_on_the_mesh(runs):
    ranks, _, p = runs
    fd, apt = ranks[0]["f_distill"], ranks[0]["apt"]
    assert [h["step"] for h in fd] == [1, 2]
    assert all(np.isfinite(h["loss"]) and np.isfinite(h["d_loss"])
               for h in fd)
    assert len(apt) == 2 and all(np.isfinite(h["g_loss"])
                                 and np.isfinite(h["d_loss"]) for h in apt)
    assert CheckpointManager(os.path.join(p["out"], "apt")).all_steps() == [
        1, 2]
    assert ranks[0]["omni_step"] == 2
    recs = [json.loads(x) for x in open(
        os.path.join(p["out"], "omni", "metrics_mesh.jsonl"))]
    assert [r["step"] for r in recs] == [1, 2]
    assert all(np.isfinite(r["loss"]) for r in recs)


def test_only_rank_0_writes(runs):
    ranks, _, _ = runs
    assert {d for d, _ in ranks[0]["writes"]} == {
        "distill", "f_distill", "apt", "omni"}
    assert all(r["writes"] == [] for r in ranks[1:])
