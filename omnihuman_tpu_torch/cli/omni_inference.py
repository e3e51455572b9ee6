"""OmniHuman inference CLI of the port (port of
omnihuman_tpu/cli/omni_inference.py).

    python -m omnihuman_tpu_torch.cli.omni_inference --task t2v-1.3B \\
        --reference_image person.png --audio speech.wav --size 832*480 \\
        --num_frames 13 --total_frames 24 --num_inference_steps 25 \\
        --output talk.mp4

umT5 encodes the prompt and the negative prompt (trimmed to a 128-token
bucket), the VAE encodes the reference image, audio features come from
the wav (log-mel, or Wav2Vec2 with --audio_backbone wav2vec), the omni
DiT samples window after window with CFG annealing, and the VAE decodes.
Runs on the GPU unless `--device cpu` is given; weights are random, made
from a fixed init seed (0); --seed seeds the noise.

`main(argv)` parses the flags and reads the files (PIL for the image,
stdlib `wave` for the audio); `run(args, reference_image, waveform,
sample_rate, pose=...)` takes arrays, so a caller without PIL (or with
its own pose heatmaps) drives the same code. The flags of the JAX CLI
whose paths are not ported yet exit naming the ROADMAP item that brings
them.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

# flags of omnihuman_tpu.cli.omni_inference that later work brings
LATER_FLAGS = {
    "--pose_video": "pose heatmaps from a driving video through Sapiens "
                    "and cv2 (ROADMAP queue A, item 16)",
    "--checkpoint": "the omni train state (ROADMAP queue A, item 15's "
                    "training half)",
    "--ckpt_dir": "checkpoint directories (ROADMAP queue A, item 8b)",
}


def build_parser() -> argparse.ArgumentParser:
    from omnihuman_tpu_torch.parallel.train_mesh import add_mesh_args
    p = argparse.ArgumentParser("omnihuman-tpu-torch omni-inference")
    p.add_argument("--task", default="t2v-1.3B",
                   help="registry config (t2v-1.3B, t2v-14B, tiny-test, ...)")
    p.add_argument("--reference_image", default=None)
    p.add_argument("--audio", default=None, help="wav file")
    p.add_argument("--audio_backbone", default="logmel",
                   choices=["logmel", "wav2vec"],
                   help="audio feature extractor (wav2vec = the port's "
                        "Wav2Vec2, omni/wav2vec.py)")
    p.add_argument("--wav2vec_checkpoint", default=None,
                   help="local HF Wav2Vec2 torch checkpoint (.bin / .pt / "
                        "dir / .npz); random base topology if omitted")
    p.add_argument("--pose_video", default=None,
                   help="driving video for pose heatmaps (not ported yet)")
    p.add_argument("--prompt", default="a person talking")
    p.add_argument("--neg_prompt", default=None,
                   help="negative prompt (default: the registry's)")
    p.add_argument("--ckpt_dir", default=None, help="not ported yet")
    p.add_argument("--checkpoint", default=None, help="not ported yet")
    p.add_argument("--size", default="256*256",
                   help="pixel W*H of the output")
    p.add_argument("--num_frames", type=int, default=13,
                   help="latent frames per window (pixel frames = 4f-3)")
    p.add_argument("--total_frames", type=int, default=None,
                   help="total latent frames; > --num_frames chains "
                        "windows through motion tokens")
    p.add_argument("--motion_frames", type=int, default=2,
                   help="previous-window latent frames packed as motion "
                        "tokens for each follow-on window")
    p.add_argument("--num_inference_steps", type=int, default=25)
    p.add_argument("--cfg_scale", type=float, default=7.5)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--precision", default="fast",
                   choices=("fast", "reference", "int8"),
                   help="'fast' (serving default) = bf16 residual stream; "
                        "'reference' = fp32 residual; 'int8' = fast + W8A8 "
                        "int8 DiT block GEMMs (ops/quant.py; the audio "
                        "adapters stay in bf16)")
    p.add_argument("--output", default="omnihuman_output.mp4")
    p.add_argument("--device", default=None,
                   help="torch device (default: the GPU; 'cpu' on request)")
    add_mesh_args(p)   # --fsdp_size / --sp_size / --remat_group
    return p


def parse_size(size: str):
    """'W*H' (or 'WxH') -> (w, h) in pixels."""
    w, h = (int(v) for v in size.replace("x", "*").split("*"))
    return w, h


def check_flags(args) -> None:
    """Exit on the flags whose paths are not ported yet."""
    for flag, why in LATER_FLAGS.items():
        if getattr(args, flag[2:]) is not None:
            sys.exit(f"{flag} is not ported yet: it comes with {why}")
    for flag in ("--fsdp_size", "--sp_size"):
        if getattr(args, flag[2:]) > 1:
            sys.exit(f"{flag} > 1 is not ported yet: it comes with "
                     "sequence parallelism and FSDP (ROADMAP queue A, "
                     "item 19)")


def build_pipeline(args):
    """The OmniHuman pipeline the flags ask for (random weights, init
    seed 0)."""
    from omnihuman_tpu_torch.configs import WAN_CONFIGS
    from omnihuman_tpu_torch.pipelines.omni import OmniHuman
    return OmniHuman(WAN_CONFIGS[args.task], num_frames=args.num_frames,
                     precision=args.precision, device=args.device)


def run(args, reference_image: np.ndarray, waveform=None,
        sample_rate: int = 16000, pose=None, pipe=None) -> dict:
    """Generate from arrays: `reference_image` [H, W, 3] uint8 at the
    output size, `waveform` (mono float32 at `sample_rate`) or None,
    `pose` heatmaps [K, F_total, 2 lat_h, 2 lat_w] or None. `pipe` is an
    `OmniHuman` built by `build_pipeline(args)` (one is built when None).
    Returns {"video": [3, F, H, W] tensor, "path": file written or None
    when args.output is None, "timings": stage seconds}."""
    from omnihuman_tpu_torch.omni.dataset import AudioFeatureExtractor
    from omnihuman_tpu_torch.utils.media import cache_video

    check_flags(args)
    w_px, h_px = parse_size(args.size)
    img = np.asarray(reference_image)
    if img.shape != (h_px, w_px, 3):
        raise ValueError(f"reference image {img.shape} != {(h_px, w_px, 3)}"
                         f" for --size {args.size}")
    if pipe is None:
        pipe = build_pipeline(args)
    if pipe.precision != args.precision:
        raise ValueError(f"pipeline precision {pipe.precision!r} != "
                         f"--precision {args.precision}")
    ocfg = pipe.omni_config
    f_total = args.total_frames or args.num_frames

    audio, audio_s = None, 0.0
    if waveform is not None:
        t0 = time.perf_counter()
        if args.audio_backbone == "wav2vec":
            from omnihuman_tpu_torch.omni.wav2vec import Wav2Vec2AudioFeatures
            ext = Wav2Vec2AudioFeatures(
                checkpoint_path=args.wav2vec_checkpoint,
                dim=ocfg.audio_dim, device=pipe.device)
            if args.wav2vec_checkpoint is None:
                print("wav2vec backbone running with RANDOM weights (no "
                      "--wav2vec_checkpoint)", file=sys.stderr)
        else:
            ext = AudioFeatureExtractor(dim=ocfg.audio_dim)
        # f_total LATENT frames at fps 16: the JAX CLI's timing, copied on
        # purpose (ROADMAP queue C)
        audio = ext(np.asarray(waveform, np.float32), sample_rate, f_total)
        audio_s = time.perf_counter() - t0

    ref = img.astype(np.float32).transpose(2, 0, 1) / 127.5 - 1.0
    video = pipe.generate(
        args.prompt, ref, audio=audio, pose=pose,
        num_frames=args.num_frames, total_frames=args.total_frames,
        motion_frames=args.motion_frames,
        sampling_steps=args.num_inference_steps, cfg_scale=args.cfg_scale,
        seed=args.seed, n_prompt=args.neg_prompt or "")
    timings = dict(pipe.timings, audio_features_s=audio_s)
    path = None
    if args.output is not None:
        path = cache_video(video, args.output, fps=16)
    return {"video": video, "path": path, "timings": timings}


def main(argv=None):
    args = build_parser().parse_args(argv)
    check_flags(args)
    if args.reference_image is None:
        sys.exit("--reference_image is required")
    from PIL import Image

    from omnihuman_tpu_torch.configs import WAN_CONFIGS
    from omnihuman_tpu_torch.omni.dataset import read_wav

    if args.task not in WAN_CONFIGS:
        sys.exit(f"unknown task {args.task!r}; choose from "
                 f"{sorted(WAN_CONFIGS)}")
    w_px, h_px = parse_size(args.size)
    img = Image.open(args.reference_image).convert("RGB").resize((w_px, h_px))
    waveform, sr = (read_wav(args.audio) if args.audio else (None, 16000))
    out = run(args, np.asarray(img), waveform, sr)
    print(f"saved {out['path']}  stage timings: {out['timings']}")
    return out["path"]


if __name__ == "__main__":
    main()
