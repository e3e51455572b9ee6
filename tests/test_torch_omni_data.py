"""The port's OmniHuman data plane and omni CLIs on the CPU.

  - the tracker: the same calls on the JAX and the port tracker give the
    same event log (less its timestamps), exclusion list, failure detail
    and summary, and the offline utilities agree;
  - `OmniHumanDataset` on tiny cv2-written `.mp4`s (one with a sidecar
    wav, one unreadable) in two copies of one directory: scan, audio
    status, annotations, seeded windows, frames, audio features, keypoint
    heatmaps (through a keypoint processor and its `.npy` cache), the
    empty-sample fallback and `batches()` are bit-equal to JAX's. Skips
    where cv2 cannot write video, as JAX's dataset tests do;
  - `load_wan_checkpoint_dir` on a TINY_TEST directory written into
    tmp_path (DiT safetensors, `Wan2.1_VAE.pth`): one DiT forward through
    both packages at 1e-5 (fp32), the VAE bit-equal to its file and to
    JAX's converted copy;
  - `cli.train_omni.main`: 2 stages x 1 step on the CPU at tiny-test,
    then `--resume` with the last stage at 2 steps runs exactly one step
    and a second `--resume` none; `cli.omni_inference.main --checkpoint`
    reads that output (the video differs from the random-weight one),
    and `--ckpt_dir` reads the TINY_TEST directory.
"""

import json
import os
import shutil
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.torch import save_file

from omnihuman_tpu.configs.wan import TINY_TEST as JAX_TINY
from omnihuman_tpu.configs.wan import DTypePolicy as JaxPolicy
from omnihuman_tpu.models.wan_dit import wan_model_forward
from omnihuman_tpu.omni import dataset as jax_ds
from omnihuman_tpu.omni import tracker as jax_tr
from omnihuman_tpu.ops.rope import rope_angles_3d as jax_rope_angles
from omnihuman_tpu.utils.convert import (
    load_wan_checkpoint_dir as jax_load_dir)
from omnihuman_tpu_torch.configs.wan import TINY_TEST, DTypePolicy
from omnihuman_tpu_torch.models.vae import build_vae
from omnihuman_tpu_torch.models.wan_dit import build_wan_model
from omnihuman_tpu_torch.omni import dataset as port_ds
from omnihuman_tpu_torch.omni import tracker as port_tr
from omnihuman_tpu_torch.ops.rope import rope_angles_3d
from omnihuman_tpu_torch.utils.checkpoint import CheckpointManager
from omnihuman_tpu_torch.utils.convert import (
    load_wan_checkpoint_dir, vae_state_dict_from_jax)

torch.set_num_threads(1)


def _write_wav(path, sr=16000, seconds=1.0, freq=440.0):
    t = np.linspace(0, seconds, int(sr * seconds), endpoint=False)
    x = (np.sin(2 * np.pi * freq * t) * 0.5 * 32767).astype(np.int16)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(x.tobytes())


# ---------------------------------------------------------------------------
# tracker


def _records(path):
    recs = [json.loads(line) for line in open(path)]
    for r in recs:
        r.pop("ts")
    return recs


def _track_all(mod, out_dir):
    mod.ProblematicVideoTracker.reset()
    tr = mod.ProblematicVideoTracker(out_dir)
    tr.track("/data/a.mp4", mod.VideoEvent.NO_AUDIO, {"why": "none"})
    tr.track("/data/a.mp4", mod.VideoEvent.VIDEO_TOO_SHORT, {"frames": 3})
    tr.track("/data/b.mp4", mod.VideoEvent.PROCESSING_ERROR, {"e": "boom"})
    tr.save_summary()
    assert mod.ProblematicVideoTracker() is tr
    counts = {e.value: c for e, c in tr.event_counts.items()}
    videos = tr.get_problematic_videos()
    mod.ProblematicVideoTracker.reset()
    return counts, videos


def test_tracker_matches_jax(tmp_path):
    jd, pd = tmp_path / "jax", tmp_path / "port"
    assert _track_all(jax_tr, jd) == _track_all(port_tr, pd)
    for name in ("invalid_videos.txt", "processing_summary.txt"):
        assert (jd / name).read_text() == (pd / name).read_text()
    assert _records(jd / "events.jsonl") == _records(pd / "events.jsonl")

    def detail(d):
        out = json.loads((d / "failures.json").read_text())
        return {k: [{f: e[f] for f in ("event", "video", "details")}
                    for e in v] for k, v in out.items()}
    assert detail(jd) == detail(pd)
    assert (jax_tr.parse_event_log(str(jd / "events.jsonl"))
            == port_tr.parse_event_log(str(pd / "events.jsonl")))

    for mod, d in ((jax_tr, jd), (port_tr, pd)):
        vid = d / "x.mp4"
        vid.write_bytes(b"fake")
        log = d / "legacy.log"
        log.write_text(f"2026-01-01 00:00:00\tno_audio\t{vid}\t{{}}\n")
        moved = mod.cleanup_failed_videos(str(log), action="move",
                                          quarantine_dir=str(d / "q"))
        assert moved == [str(vid)] and (d / "q" / "x.mp4").exists()


# ---------------------------------------------------------------------------
# dataset


@pytest.fixture(scope="module")
def video_dir(tmp_path_factory):
    import cv2
    d = tmp_path_factory.mktemp("videos")
    rng = np.random.default_rng(0)
    for name in ("dancing_person", "talking_head"):
        path = d / f"{name}.mp4"
        vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"),
                             16, (64, 64))
        ok = vw.isOpened()
        for _ in range(20):
            vw.write(rng.integers(0, 255, (64, 64, 3)).astype(np.uint8))
        vw.release()
        if not ok or not path.exists():
            pytest.skip("cv2 VideoWriter unavailable in this environment")
    _write_wav(d / "talking_head.wav")
    (d / "sub").mkdir()
    (d / "sub" / "broken_clip.mp4").write_bytes(b"not a video")
    return d


class _Keypoints:
    """A deterministic keypoint processor: points from the frame's mean."""

    def extract_keypoints(self, img):
        m = float(img.mean()) / 255.0
        k = np.arange(6, dtype=np.float32) / 6.0
        return np.stack([(k + m) % 1.0, (1.0 - k * m) % 1.0,
                         np.full(6, 0.9, np.float32)], axis=1)


def _dataset(mod, src, dst, tracker_dir, **kw):
    shutil.copytree(src, dst)
    mod_tr = jax_tr if mod is jax_ds else port_tr
    mod_tr.ProblematicVideoTracker.reset()
    tr = mod_tr.ProblematicVideoTracker(tracker_dir)
    return mod.OmniHumanDataset(
        str(dst), num_frames=8, frame_size=(32, 48), num_keypoints=6,
        heatmap_size=(8, 12), audio_dim=64, tracker=tr, seed=5,
        keypoint_processor=_Keypoints(),
        condition_ratios={"text": 1.0, "reference": 1.0, "audio": 0.5,
                          "pose": 0.5}, **kw)


def _same(a, b, where):
    if isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            _same(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and np.array_equal(a, b), where
    elif isinstance(a, str) and os.sep in a:
        assert os.path.basename(a) == os.path.basename(b), where
    else:
        assert a == b, where


def test_dataset_matches_jax(video_dir, tmp_path):
    jds = _dataset(jax_ds, video_dir, tmp_path / "j", tmp_path / "jt")
    pds = _dataset(port_ds, video_dir, tmp_path / "p", tmp_path / "pt")
    try:
        assert len(jds) == len(pds) == 3
        assert jds.annotations == pds.annotations
        ann = {a["video_name"]: a for a in pds.annotations}
        assert ann["talking_head.mp4"]["has_audio"] is True
        assert ann["dancing_person.mp4"]["has_audio"] is False
        for name in ("annotations.json", ".omni_cache/audio_status.json"):
            want = json.loads((tmp_path / "j" / name).read_text())
            got = json.loads((tmp_path / "p" / name).read_text())
            if isinstance(want, dict):   # keyed by each copy's own path
                want = {os.path.basename(k): v for k, v in want.items()}
                got = {os.path.basename(k): v for k, v in got.items()}
            assert want == got, name
        # two passes: the windows come from each dataset's seeded rng
        samples = []
        for _ in range(2):
            for i in range(len(pds)):
                got, want = pds[i], jds[i]
                _same(want, got, f"sample {i}")
                samples.append(got)
        conds = [set(s["conditions"]) for s in samples]
        assert {"text", "reference", "audio", "pose"} in conds
        assert any(s["metadata"].get("empty") for s in samples)
        assert any(s["metadata"].get("start", 0) > 0 for s in samples)
        jb, pb = jds.batches(2), pds.batches(2)
        for _ in range(2):
            want, got = next(jb), next(pb)
            assert np.array_equal(want["frames"], got["frames"])
            _same(want["samples"], got["samples"], "batch")
        jt = [(r["event"], os.path.basename(r["video"])) for r in
              _records(tmp_path / "jt" / "events.jsonl")]
        pt = [(r["event"], os.path.basename(r["video"])) for r in
              _records(tmp_path / "pt" / "events.jsonl")]
        assert jt == pt and ("processing_error", "broken_clip.mp4") in pt
    finally:
        jax_tr.ProblematicVideoTracker.reset()
        port_tr.ProblematicVideoTracker.reset()


# ---------------------------------------------------------------------------
# checkpoint directories


@pytest.fixture(scope="module")
def wan_dir(tmp_path_factory):
    """A TINY_TEST checkpoint directory in the reference layout: the DiT
    (random head) as safetensors, the VAE as Wan2.1_VAE.pth."""
    d = tmp_path_factory.mktemp("wan")
    model = build_wan_model(TINY_TEST.model, "cpu", torch.float32, seed=0)
    with torch.no_grad():
        model.head.head.weight.normal_(
            0.0, 0.1, generator=torch.Generator().manual_seed(1))
    save_file(model.state_dict(),
              str(d / "diffusion_pytorch_model.safetensors"))
    vae = build_vae(TINY_TEST.vae, "cpu", torch.float32, seed=3)
    torch.save(vae.state_dict(), str(d / "Wan2.1_VAE.pth"))
    return d


def test_load_wan_checkpoint_dir_matches_jax(wan_dir):
    jparams, jvae = jax_load_dir(str(wan_dir), JAX_TINY.model, JAX_TINY.vae)
    sd, vae = load_wan_checkpoint_dir(str(wan_dir), TINY_TEST.model,
                                      TINY_TEST.vae)
    saved = torch.load(str(wan_dir / "Wan2.1_VAE.pth"), weights_only=True)
    for name, want in (("file", saved), ("JAX", vae_state_dict_from_jax(
            jax.tree.map(np.asarray, jvae), TINY_TEST.vae))):
        got = vae.state_dict()
        assert set(got) == set(want), name
        assert all(torch.equal(got[k], want[k]) for k in got), name

    model = build_wan_model(TINY_TEST.model, "cpu", torch.float32, seed=None)
    model.load_state_dict(sd, strict=True)
    rng = np.random.default_rng(0)
    cfg = TINY_TEST.model
    x = rng.normal(size=(1, cfg.in_dim, 3, 4, 6)).astype(np.float32)
    t = np.array([431.5], np.float32)
    ctx = rng.normal(size=(1, 16, cfg.text_dim)).astype(np.float32)
    grid, seq = (3, 2, 3), 24

    def jfwd(params, x, t, ctx):
        sin, cos = jax_rope_angles(grid, cfg.head_dim, seq_len=seq)
        return wan_model_forward(params, x, t, ctx, cfg=JAX_TINY.model,
                                 seq_len=seq, rope_sin=sin, rope_cos=cos,
                                 policy=JaxPolicy(compute=jnp.float32),
                                 remat=False)
    want = jax.jit(jfwd)(jparams, x, t, ctx)
    sin, cos = rope_angles_3d(grid, cfg.head_dim, seq_len=seq)
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(t),
                    torch.from_numpy(ctx), seq_len=seq, rope_sin=sin,
                    rope_cos=cos, policy=DTypePolicy(compute=torch.float32))
    assert float(np.abs(np.asarray(want)).max()) > 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_load_wan_checkpoint_dir_without_vae_file(wan_dir, tmp_path):
    """No Wan2.1_VAE.pth: a random VAE from the seed (JAX's fallback); a
    DiT of another width is refused by name and shape."""
    d = tmp_path / "no_vae"
    d.mkdir()
    shutil.copy(wan_dir / "diffusion_pytorch_model.safetensors", d)
    _, vae = load_wan_checkpoint_dir(str(d), TINY_TEST.model, TINY_TEST.vae,
                                     vae_seed=7)
    ref = build_vae(TINY_TEST.vae, "cpu", torch.float32, seed=7)
    assert all(torch.equal(a, b) for a, b in zip(
        vae.state_dict().values(), ref.state_dict().values()))
    import dataclasses
    wide = dataclasses.replace(TINY_TEST.model, dim=128)
    with pytest.raises(ValueError, match="!="):
        load_wan_checkpoint_dir(str(d), wide)


# ---------------------------------------------------------------------------
# the CLIs


def _train_yaml(path, data_dir, out_dir, last_steps):
    # audio_dim / num_keypoints as the inference CLI builds the omni model
    path.write_text(f"""
project: omni-test
run_name: cli
model:
  audio_dim: 1024
  num_keypoints: 308
  num_frames: 2
data:
  data_dir: {data_dir}
  frame_size: [32, 32]
  fps: 16
training:
  output_dir: {out_dir}
  batch_size: 1
  learning_rate: 1.0e-3
  checkpoint_interval: 50
  log_interval: 1
stages:
  - name: text_reference
    num_steps: 1
    condition_ratios: {{text: 1.0, reference: 1.0, audio: 0.0, pose: 0.0}}
  - name: all_conditions
    num_steps: {last_steps}
    condition_ratios: {{text: 1.0, reference: 1.0, audio: 1.0, pose: 0.0}}
""")
    return str(path)


def test_train_cli_stages_resume_and_inference(video_dir, wan_dir, tmp_path):
    from PIL import Image

    from omnihuman_tpu_torch.cli import omni_inference, train_omni
    data = tmp_path / "data"
    shutil.copytree(video_dir, data)
    out = tmp_path / "out"
    argv = ["--task", "tiny-test", "--device", "cpu"]
    port_tr.ProblematicVideoTracker.reset()
    try:
        s1 = train_omni.main(["--config", _train_yaml(
            tmp_path / "a.yaml", data, out, 1)] + argv)
        mgr = CheckpointManager(str(out))
        assert s1.trainer.state.step == 2 and mgr.all_steps() == [1, 2]
        assert mgr.restore_metadata(2) == {"stage": 1, "final": True}
        assert (out / "config_snapshot.yaml").exists()
        assert (out / "bad_videos" / "processing_summary.txt").exists()
        recs = [json.loads(x) for x in open(out / "metrics_cli.jsonl")]
        assert [r["step"] for r in recs] == [1, 2]

        cfg_b = _train_yaml(tmp_path / "b.yaml", data, out, 2)
        s2 = train_omni.main(["--config", cfg_b, "--resume"] + argv)
        assert s2.trainer.state.step == 3 and mgr.all_steps() == [1, 2, 3]
        assert [x["step"] for x in s2.trainer.saves] == [3]
        s3 = train_omni.main(["--config", cfg_b, "--resume"] + argv)
        assert s3.trainer.state.step == 3 and s3.trainer.saves == []
    finally:
        port_tr.ProblematicVideoTracker.reset()

    img = np.random.default_rng(2).integers(0, 255, (32, 32, 3),
                                            dtype=np.uint8)
    Image.fromarray(img).save(tmp_path / "ref.png")
    _write_wav(tmp_path / "a.wav", seconds=0.5)
    base = ["--task", "tiny-test", "--reference_image",
            str(tmp_path / "ref.png"), "--audio", str(tmp_path / "a.wav"),
            "--size", "32*32", "--num_frames", "2",
            "--num_inference_steps", "1", "--device", "cpu"]
    path = omni_inference.main(base + ["--checkpoint", str(out), "--output",
                                       str(tmp_path / "trained.mp4")])
    assert os.path.getsize(path) > 0

    waveform, sr = port_ds.read_wav(str(tmp_path / "a.wav"))
    pipes, videos = {}, {}
    for name, extra in (("random", []), ("trained", ["--checkpoint",
                                                     str(out)]),
                        ("wan", ["--ckpt_dir", str(wan_dir)])):
        args = omni_inference.build_parser().parse_args(base + extra)
        args.output = None
        pipes[name] = omni_inference.build_pipeline(args)
        videos[name] = omni_inference.run(args, img, waveform, sr,
                                          pipe=pipes[name])["video"]
        assert torch.isfinite(videos[name]).all()
    assert not torch.equal(videos["random"], videos["trained"])
    trained = dict(pipes["trained"].model.named_parameters())
    saved = CheckpointManager(str(out)).restore()["params"]
    assert set(saved) == set(trained)
    assert all(torch.equal(trained[n], saved[n].to(trained[n].dtype))
               for n in saved)
    wan_sd = load_wan_checkpoint_dir(str(wan_dir), TINY_TEST.model)[0]
    wan_base = dict(pipes["wan"].model.base.named_parameters())
    assert all(torch.equal(wan_base[k], v.to(wan_base[k].dtype))
               for k, v in wan_sd.items())
    saved_vae = torch.load(str(wan_dir / "Wan2.1_VAE.pth"),
                           weights_only=True)
    got_vae = pipes["wan"].vae.state_dict()
    assert all(torch.equal(got_vae[k], v.to(got_vae[k].dtype))
               for k, v in saved_vae.items())


def test_metrics_logger_calls_no_unconfigured_wandb(tmp_path, monkeypatch):
    """Without WANDB_MODE / WANDB_API_KEY the metrics go to JSONL and an
    installed wandb is never initialised (its init may reach for the
    network, and the exception it keeps would pin the caller's objects)."""
    import sys
    import types

    from omnihuman_tpu_torch.utils.logging import MetricsLogger
    calls = []
    fake = types.SimpleNamespace(init=lambda **kw: calls.append(kw))
    monkeypatch.setitem(sys.modules, "wandb", fake)
    monkeypatch.delenv("WANDB_MODE", raising=False)
    monkeypatch.delenv("WANDB_API_KEY", raising=False)
    ml = MetricsLogger(run_name="r", out_dir=str(tmp_path))
    ml.log({"loss": torch.tensor(0.5), "stage": 1, "name": "x"}, step=3)
    ml.finish()
    assert calls == []
    rec = json.loads((tmp_path / "metrics_r.jsonl").read_text())
    assert (rec["step"], rec["loss"], rec["stage"]) == (3, 0.5, 1.0)
    assert "name" not in rec
