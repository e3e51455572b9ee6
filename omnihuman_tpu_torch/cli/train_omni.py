"""OmniHuman 3-stage training CLI of the port (port of
omnihuman_tpu/cli/train_omni.py).

    python -m omnihuman_tpu_torch.cli.train_omni \\
        --config configs/omni_config.yaml --task t2v-1.3B \\
        --data_dir data/videos --output_dir checkpoints/omni [--resume]

The YAML gives the model's condition widths, the data geometry, the
optimizer and the stages; `--task` takes the backbone, VAE and umT5 from
the registry (else the YAML's model section with a small random umT5).
Weights come from `--ckpt_dir` (a Wan checkpoint directory: DiT
`*.safetensors`, `Wan2.1_VAE.pth`, the umT5 `.pth`; the adapters and
condition encoders stay random) or are random from fixed seeds. The omni
parameters and AdamW moments are fp32; the VAE is bf16, as in the port's
pipelines, so on the card its encode runs the K3 kernel. Each batch:
umT5 encodes the captions, the VAE encodes the frames and the reference
frame (streaming), the audio features are stacked (one per PIXEL frame,
as in JAX) and the pose heatmaps cut to the latent frame rate in bf16.
Runs on the GPU unless `--device cpu` is given; --fsdp_size / --sp_size
above 1 train on a (data, fsdp, sp) mesh under torchrun, as
`cli.train_distill` does (omni/trainer.py: FSDP2 on the omni model, the
ring on the packed tokens, each data rank's slice of the global batch;
every rank encodes the global batch with its own whole VAE and umT5, and
the pose heatmaps stay whole); rank 0 writes the files.

`main` reads videos through `OmniHumanDataset` (OpenCV) and reports bad
ones to the `ProblematicVideoTracker`; `run(args, data_iter_factory)`
takes any iterator of dataset-style samples, so a caller without OpenCV
drives the same code.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import Any, Callable, Dict, Iterator, List, Sequence, Tuple

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    from omnihuman_tpu_torch.parallel.train_mesh import add_mesh_args
    p = argparse.ArgumentParser("omnihuman-tpu-torch train-omni")
    p.add_argument("--config", default="configs/omni_config.yaml")
    p.add_argument("--data_dir", default=None)
    p.add_argument("--output_dir", default=None)
    p.add_argument("--task", default=None,
                   help="registry config (e.g. t2v-1.3B) for the backbone, "
                        "VAE and umT5; default: the YAML's model section")
    p.add_argument("--ckpt_dir", default=None,
                   help="Wan checkpoint dir (DiT *.safetensors, "
                        "Wan2.1_VAE.pth, umT5 .pth); default: random init")
    p.add_argument("--resume", action="store_true",
                   help="continue from the latest (step, stage) checkpoint")
    p.add_argument("--device", default=None,
                   help="torch device (default: the GPU; 'cpu' on request)")
    add_mesh_args(p)
    return p


@dataclasses.dataclass
class OmniTrainSetup:
    """What `run` trains with: the YAML, the configs, the trainer and the
    encoders that turn samples into batches."""

    cfg: Any
    ocfg: Any
    stages: Tuple
    policy: Any
    device: torch.device
    trainer: Any
    text_encoder: Any
    vae: Any
    metrics: Any
    data_dir: str
    out_dir: str
    frame_size: Tuple[int, int]
    heatmap_size: Tuple[int, int]
    pixel_frames: int


def load_setup(args) -> OmniTrainSetup:
    """Configs, weights, encoders and the trainer the flags ask for."""
    from omnihuman_tpu_torch.configs import WAN_CONFIGS
    from omnihuman_tpu_torch.configs.wan import (
        DTypePolicy, T5Config, VAEConfig, WanModelConfig)
    from omnihuman_tpu_torch.models.t5 import T5TextEncoder
    from omnihuman_tpu_torch.models.vae import build_vae
    from omnihuman_tpu_torch.omni.model import (
        OmniModelConfig, build_omni_model, load_base_dit)
    from omnihuman_tpu_torch.omni.trainer import OmniHumanTrainer, StageConfig
    from omnihuman_tpu_torch.parallel.mesh import is_writer
    from omnihuman_tpu_torch.parallel.train_mesh import (
        TrainMeshPlan, resolve_remat)
    from omnihuman_tpu_torch.utils.config_io import load_yaml, save_snapshot
    from omnihuman_tpu_torch.utils.logging import MetricsLogger, logger

    plan = TrainMeshPlan.from_sizes(
        args.fsdp_size, args.sp_size, args.device,
        module="omnihuman_tpu_torch.cli.train_omni")
    cfg = load_yaml(args.config)
    plan.check_batch(cfg.get_path("training.batch_size", 1))
    logger.info(f"training plan: {plan.describe()}")
    data_dir = args.data_dir or cfg.get_path("data.data_dir", "data/videos")
    out_dir = args.output_dir or cfg.get_path("training.output_dir",
                                              "checkpoints/omni")
    if is_writer():
        save_snapshot(cfg, out_dir)
    device = plan.device

    mc = cfg.get_path("model", {})
    if args.task:
        if args.task not in WAN_CONFIGS:
            sys.exit(f"unknown task {args.task!r}; choose from "
                     f"{sorted(WAN_CONFIGS)}")
        reg = WAN_CONFIGS[args.task]
        base, t5_cfg, vae_cfg = reg.model, reg.t5, reg.vae
        text_len, tok_name, policy = reg.text_len, reg.t5_tokenizer, reg.policy
    else:
        base = WanModelConfig(
            dim=mc.get("dim", 1536), ffn_dim=mc.get("ffn_dim", 8960),
            num_heads=mc.get("num_heads", 12),
            num_layers=mc.get("num_layers", 30),
            text_dim=mc.get("text_dim", 4096))
        text_len, tok_name = base.text_len, "google/umt5-xxl"
        # a random encoder sized to the model's text width (a umT5 file in
        # --ckpt_dir replaces it)
        t5_cfg = T5Config(vocab_size=256384, dim=base.text_dim,
                          dim_attn=base.text_dim, dim_ffn=base.text_dim * 2,
                          num_heads=8, num_layers=2)
        vae_cfg = VAEConfig()
        policy = DTypePolicy()
    ocfg = OmniModelConfig(
        base=base, audio_dim=mc.get("audio_dim", 1024),
        num_keypoints=mc.get("num_keypoints", 308),
        num_frames=mc.get("num_frames", 13))
    stages = tuple(StageConfig(s["name"], int(s["num_steps"]),
                               dict(s["condition_ratios"]))
                   for s in cfg.get("stages", []))
    if not stages:
        sys.exit(f"{args.config} has no stages")

    # weights: a Wan checkpoint directory or random init
    dit_sd = None
    if args.ckpt_dir:
        from omnihuman_tpu_torch.utils.convert import load_wan_checkpoint_dir
        dit_sd, vae = load_wan_checkpoint_dir(
            args.ckpt_dir, base, vae_cfg, device=device, dtype=torch.bfloat16)
    else:
        vae = build_vae(vae_cfg, device, torch.bfloat16, seed=1)
    model = build_omni_model(ocfg, device, policy.params, seed=0,
                             trainable=True)
    if dit_sd is not None:
        load_base_dit(model, dit_sd)
        logger.info("omni backbone <- Wan DiT of the checkpoint directory")
    del dit_sd
    text_encoder = T5TextEncoder(t5_cfg, text_len, tokenizer_name=tok_name,
                                 ckpt_dir=args.ckpt_dir, device=device)

    metrics = MetricsLogger(project=cfg.get("project", "omnihuman-tpu"),
                            run_name=cfg.get("run_name"), out_dir=out_dir)
    trainer = OmniHumanTrainer(
        model, ocfg, stages=stages,
        remat=resolve_remat(args.remat_group, base.num_layers),
        learning_rate=cfg.get_path("training.learning_rate", 1e-4),
        scheduler_type=cfg.get_path("training.scheduler_type", "cosine"),
        weight_decay=cfg.get_path("training.weight_decay", 0.01),
        max_grad_norm=cfg.get_path("training.max_grad_norm", 1.0),
        checkpoint_dir=out_dir,
        checkpoint_interval=cfg.get_path("training.checkpoint_interval",
                                         1000),
        log_interval=cfg.get_path("training.log_interval", 100),
        policy=policy, metric_writer=lambda m, s: metrics.log(m, step=s),
        plan=plan)

    frame_size = tuple(cfg.get_path("data.frame_size", (256, 256)))
    # heatmaps at pixel / 4 = 2x the latent grid: the pose guider reduces
    # 4x to one cell per (1, 2, 2) patch
    heatmap_size = tuple(cfg.get_path(
        "data.heatmap_size", (frame_size[0] // 4, frame_size[1] // 4)))
    return OmniTrainSetup(
        cfg=cfg, ocfg=ocfg, stages=stages, policy=policy, device=device,
        trainer=trainer, text_encoder=text_encoder, vae=vae, metrics=metrics,
        data_dir=data_dir, out_dir=out_dir, frame_size=frame_size,
        heatmap_size=heatmap_size, pixel_frames=ocfg.num_frames * 4 - 3)


def assemble_batch(samples: Sequence[Dict], setup: OmniTrainSetup) -> Dict:
    """Dataset samples -> one device batch for the trainer: "frames" (VAE
    latents of the clips), "context" (umT5 of the captions, [B, text_len,
    text_dim] fp32, no lengths: the JAX loss attends to every text
    position), "reference" (latent of the first frame), and "audio"
    ([B, T_pixel, audio_dim]) / "pose" ([B, K, F, h, w] bf16, every 4th
    pixel frame) when every sample carries them."""
    from omnihuman_tpu_torch.models.vae import vae_encode
    dev = setup.device

    def encode(px: np.ndarray) -> torch.Tensor:
        with torch.no_grad():
            return vae_encode(setup.vae, torch.from_numpy(px).to(dev),
                              streaming=True)

    conds = [s["conditions"] for s in samples]
    out = {
        "frames": encode(np.stack([s["frames"] for s in samples])),
        "context": setup.text_encoder([c["text"] for c in conds]),
        "reference": encode(np.stack([c["reference"] for c in conds])),
    }
    if all("audio" in c for c in conds):
        out["audio"] = torch.from_numpy(
            np.stack([c["audio"] for c in conds])).to(dev)
    if all("pose" in c for c in conds):
        f = setup.ocfg.num_frames
        # [K, T_pixel, h, w] -> the latent frame rate (the VAE's 4x in
        # time); bf16: at 308 keypoints the fp32 tensor is large
        out["pose"] = torch.from_numpy(np.stack(
            [c["pose"][:, ::4][:, :f] for c in conds])).to(
                dev, torch.bfloat16)
    return out


def run(args, data_iter_factory: Callable[[int], Iterator[List[Dict]]],
        setup: OmniTrainSetup = None) -> OmniTrainSetup:
    """Train every stage on `data_iter_factory(stage)`, an iterator of
    sample lists (one list a batch, samples as `OmniHumanDataset` gives
    them); resume with `args.resume`. Builds the setup from `args` unless
    one is given; returns it, with the trained state in `.trainer` (its
    metrics sink closed: a setup serves one run)."""
    setup = setup or load_setup(args)

    def batches(stage_idx: int) -> Iterator[Dict]:
        for samples in data_iter_factory(stage_idx):
            yield assemble_batch(samples, setup)

    setup.trainer.train(batches, resume=args.resume)
    setup.trainer.ckpt.wait()
    setup.metrics.finish()
    return setup


def main(argv=None) -> OmniTrainSetup:
    from omnihuman_tpu_torch.omni.dataset import OmniHumanDataset
    from omnihuman_tpu_torch.omni.tracker import ProblematicVideoTracker
    from omnihuman_tpu_torch.parallel.mesh import is_writer
    from omnihuman_tpu_torch.utils.logging import logger

    args = build_parser().parse_args(argv)
    setup = load_setup(args)
    cfg = setup.cfg
    # rank 0 records the bad videos (every rank reads the same ones)
    tracker = (ProblematicVideoTracker(f"{setup.out_dir}/bad_videos")
               if is_writer() else None)

    def factory(stage_idx: int) -> Iterator[List[Dict]]:
        ds = OmniHumanDataset(
            setup.data_dir,
            condition_ratios=setup.stages[stage_idx].condition_ratios,
            num_frames=setup.pixel_frames, frame_size=setup.frame_size,
            num_keypoints=setup.ocfg.num_keypoints,
            heatmap_size=setup.heatmap_size, audio_dim=setup.ocfg.audio_dim,
            fps=cfg.get_path("data.fps", 16.0), tracker=tracker)
        bs = cfg.get_path("training.batch_size", 1)
        if len(ds) < bs:    # batches() would loop without yielding
            sys.exit(f"{setup.data_dir}: {len(ds)} usable videos for stage "
                     f"{stage_idx}, fewer than batch_size {bs}")
        return (b["samples"] for b in ds.batches(bs))

    run(args, factory, setup)
    if tracker is not None:
        tracker.save_summary()
    logger.info("training complete")
    return setup


if __name__ == "__main__":
    main()
