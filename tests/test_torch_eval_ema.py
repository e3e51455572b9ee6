"""The port's EMA evaluation (apt/eval_ema.py, cli/eval_ema.py) against the
JAX package at TINY_TEST on the CPU.

`psnr` / `ssim` take the same float32 arrays as JAX's and compute in
float64 numpy with the same formulas: rtol 1e-12. `evaluate_ema` runs on
a port pipeline and on a JAX stand-in with the same DiT and VAE weights
(carried by the JAX converters), the same npz, fp32 parameters and
compute: the one-step latents atol 1e-5 (velocities of order 1), each
metric rtol 1e-4 (PSNR and SSIM of decoded images that agree to ~1e-5,
against the same teacher images), and both write their images. The CLI
test runs `cli.train_distill` for two steps and checks that
`cli.eval_ema --ema_checkpoint` evaluates with that EMA as the DiT."""

import dataclasses
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.torch import save_file

from omnihuman_tpu.apt import eval_ema as jee
from omnihuman_tpu.configs.wan import DTypePolicy as JaxPolicy
from omnihuman_tpu.configs.wan import TINY_TEST as JAX_TINY
from omnihuman_tpu.models.wan_dit import wan_model_forward
from omnihuman_tpu.ops.rope import rope_angles_3d as jax_rope
from omnihuman_tpu.utils.convert import convert_vae, convert_wan_dit
from omnihuman_tpu_torch.apt import eval_ema as ee
from omnihuman_tpu_torch.configs.wan import TINY_TEST, DTypePolicy
from omnihuman_tpu_torch.models.vae import build_vae
from omnihuman_tpu_torch.models.wan_dit import build_wan_model
from omnihuman_tpu_torch.ops.rope import rope_angles_3d
from omnihuman_tpu_torch.pipelines.text2video import WanT2V
from omnihuman_tpu_torch.pipelines.wan_inference import one_step_latents
from omnihuman_tpu_torch.utils.convert import load_wan_dit_checkpoint

torch.set_num_threads(1)

N, LATENT = 2, (16, 1, 4, 6)        # 2 samples, 4 x 6 latents: 32 x 48
GRID, SEQ = (1, 2, 3), 6


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A tiny-test checkpoint directory (random head, VAE file) and a
    teacher npz."""
    d = tmp_path_factory.mktemp("eval")
    model = build_wan_model(TINY_TEST.model, "cpu", torch.float32, seed=0)
    with torch.no_grad():
        model.head.head.weight.normal_(
            0.0, 0.1, generator=torch.Generator().manual_seed(1))
    (d / "wan").mkdir()
    save_file(model.state_dict(),
              str(d / "wan" / "diffusion_pytorch_model.safetensors"))
    vae = build_vae(TINY_TEST.vae, "cpu", torch.float32, seed=3)
    torch.save(vae.state_dict(), str(d / "wan" / "Wan2.1_VAE.pth"))
    rng = np.random.default_rng(0)
    noise = rng.normal(size=(N,) + LATENT).astype(np.float32)
    path = str(d / "teacher.npz")
    np.savez(path, dummy_data=noise, noise=noise,
             dummy_prompts=np.asarray(["p"] * N),
             positive_contexts=(rng.normal(size=(N, 16, 32)) * 0.5
                                ).astype(np.float32),
             negative_context=(rng.normal(size=(16, 32)) * 0.5
                               ).astype(np.float32),
             v_teacher=rng.normal(size=(N,) + LATENT).astype(np.float32))
    return str(d / "wan"), path


def test_psnr_ssim_match_jax():
    rng = np.random.default_rng(5)
    a = rng.uniform(-1, 1, size=(3, 32, 48)).astype(np.float32)
    b = np.clip(a + rng.normal(size=a.shape) * 0.1, -1, 1).astype(np.float32)
    for x, y in ((a, b), (b, a), (a, a * 0.5)):
        np.testing.assert_allclose(ee.psnr(x, y), jee.psnr(x, y), rtol=1e-12)
        np.testing.assert_allclose(ee.ssim(x, y), jee.ssim(x, y), rtol=1e-12)
    assert ee.psnr(a, a) == jee.psnr(a, a) == float("inf")
    assert ee.ssim(a, a) == pytest.approx(1.0, rel=1e-12)


def test_evaluate_ema_matches_jax(files, tmp_path):
    wan_dir, npz = files
    cfg = dataclasses.replace(TINY_TEST,
                              policy=DTypePolicy(compute=torch.float32))
    pipe = WanT2V(cfg, device="cpu", param_dtype=torch.float32,
                  checkpoint_dir=wan_dir)
    jcfg = dataclasses.replace(JAX_TINY,
                               policy=JaxPolicy(compute=jnp.float32))
    # what evaluate_ema reads of a JAX WanT2V: config, params, vae_params
    jpipe = types.SimpleNamespace(
        config=jcfg,
        params=convert_wan_dit({k: v.numpy() for k, v in
                                pipe.model.state_dict().items()}, jcfg.model),
        vae_params=convert_vae({k: v.numpy() for k, v in
                                pipe.vae.state_dict().items()}, jcfg.vae))

    want = jee.evaluate_ema(jpipe, npz, num_samples=N,
                            out_dir=str(tmp_path / "jax"))
    got = ee.evaluate_ema(pipe, npz, num_samples=N,
                          out_dir=str(tmp_path / "port"))
    assert set(got) == set(want) and got["num_samples"] == N
    for k in ("psnr_vs_teacher", "ssim_vs_teacher",
              "latent_mse_vs_teacher_x0"):
        assert np.isfinite(got[k]), k
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    assert sorted(os.listdir(tmp_path / "port")) == sorted(
        os.listdir(tmp_path / "jax")) == ["eval_image_0.png",
                                           "eval_image_1.png"]

    data = np.load(npz)
    z, ctx = data["noise"], data["positive_contexts"]

    def jax_one_step(params, z, ctx):
        sin, cos = jax_rope(GRID, cfg.model.head_dim, seq_len=SEQ)
        t = jnp.full((N,), 1000.0, jnp.float32)
        return z - wan_model_forward(params, z, t, ctx, cfg=jcfg.model,
                                     seq_len=SEQ, rope_sin=sin, rope_cos=cos,
                                     policy=jcfg.policy)
    want_lat = jax.jit(jax_one_step)(jpipe.params, z, ctx)
    sin, cos = rope_angles_3d(GRID, cfg.model.head_dim, seq_len=SEQ)
    got_lat = one_step_latents(pipe.model, torch.from_numpy(z),
                               torch.from_numpy(ctx), seq_len=SEQ,
                               rope_sin=sin, rope_cos=cos, policy=cfg.policy,
                               t_final=1000.0)
    assert float(np.abs(np.asarray(want_lat) - z).max()) > 0
    np.testing.assert_allclose(got_lat.numpy(), np.asarray(want_lat),
                               atol=1e-5)


def test_eval_ema_cli_takes_the_distill_ema(files, tmp_path, monkeypatch):
    from omnihuman_tpu_torch.cli import eval_ema, train_distill
    from omnihuman_tpu_torch.utils.checkpoint import CheckpointManager
    wan_dir, npz = files
    out = str(tmp_path / "distill")
    train_distill.main(["--task", "tiny-test", "--data_path", npz,
                        "--output_dir", out, "--num_epochs", "1",
                        "--batch_size", "1", "--learning_rate", "1e-2",
                        "--ema_decay", "0.5", "--device", "cpu",
                        "--checkpoint_dir", wan_dir])
    ema = CheckpointManager(out).restore()["ema_params"]

    seen = []
    run = ee.evaluate_ema
    monkeypatch.setattr(ee, "evaluate_ema",
                        lambda pipe, *a, **k: seen.append(pipe)
                        or run(pipe, *a, **k))
    metrics = eval_ema.main(["--task", "tiny-test", "--checkpoint_dir",
                             wan_dir, "--ema_checkpoint", out,
                             "--data_path", npz, "--num_samples", "2",
                             "--out_dir", str(tmp_path / "img"),
                             "--device", "cpu"])
    params = dict(seen[0].model.named_parameters())
    assert set(params) == set(ema)
    assert all(torch.equal(params[n], ema[n]) for n in ema)
    base = build_wan_model(TINY_TEST.model, "cpu", torch.bfloat16, seed=None)
    load_wan_dit_checkpoint(base, wan_dir)
    assert any(not torch.equal(p, ema[n])
               for n, p in base.named_parameters())
    assert np.isfinite(metrics["psnr_vs_teacher"])
    assert np.isfinite(metrics["ssim_vs_teacher"])
    assert sorted(os.listdir(tmp_path / "img")) == ["eval_image_0.png",
                                                     "eval_image_1.png"]
