"""Batch evaluation CLI: FID / FVD / HKC / HKV over two directories of
clips (port of omnihuman_tpu/cli/evaluate.py).

    python -m omnihuman_tpu_torch.cli.evaluate --real_dir a/ --fake_dir b/ \\
        [--i3d_weights rgb_imagenet.pt] [--inception_weights pt_inception.pth] \\
        [--keypoints] [--device cpu]

Clips are matched by sorted filename. `.npy` / `.npz` arrays shaped
[C, T, H, W] or [T, H, W, C] (in [-1, 1], or 0-255) are read without
cv2 and conformed to --num_frames (the last frame repeated) and --size
(a bilinear resize, cv2.resize's INTER_LINEAR); video files are decoded
with cv2, which is imported only for them. Without weights the metrics
run on the random-init feature proxies, and the JSON is tagged with its
feature space. `--keypoints` runs the Sapiens keypoint processor for
HKC / HKV over a random-init Sapiens-1b backbone (the JAX CLI asks for a
`KeypointProcessor` class its keypoints module does not define, and
raises ImportError there); `main(argv, keypoint_processor=...)` takes a
processor the caller already holds instead.
"""

from __future__ import annotations

import argparse
import os
from pathlib import Path

import numpy as np

VIDEO_EXTS = (".mp4", ".avi", ".mov", ".mkv", ".gif", ".webm")
# the Sapiens preset --keypoints builds (random-init weights)
KEYPOINT_PRESET = "1b"


def _load_array(path: Path) -> np.ndarray:
    """[C, T, H, W] float32 in [-1, 1] from a .npy / .npz file."""
    if path.suffix == ".npz":
        with np.load(path) as z:
            x = z[list(z.keys())[0]]
    else:
        x = np.load(path)
    x = np.asarray(x, np.float32)
    if x.ndim != 4:
        raise ValueError(f"{path}: expected 4D array, got {x.shape}")
    if x.shape[0] not in (1, 3) and x.shape[-1] in (1, 3):
        x = x.transpose(3, 0, 1, 2)          # [T,H,W,C] -> [C,T,H,W]
    if x.max() > 2.0:                        # uint8-range content
        x = x / 127.5 - 1.0
    return x


def _resize_frames(x: np.ndarray, size) -> np.ndarray:
    """[C, T, h, w] -> [C, T, *size] float32, bilinear with half-pixel
    centres and edge clamping (cv2.resize INTER_LINEAR on float maps)."""
    import torch
    import torch.nn.functional as F
    c, t = x.shape[:2]
    y = F.interpolate(torch.from_numpy(np.ascontiguousarray(x)).reshape(
        c * t, 1, *x.shape[2:]), size=tuple(size), mode="bilinear",
        align_corners=False)
    return y.reshape(c, t, *size).numpy()


def _load_video(path: Path, num_frames: int, size) -> np.ndarray:
    """[C, T, H, W] float32 in [-1, 1] via cv2 (JAX omni/dataset.py:279-298
    frame loading: resize, repeat-pad short clips)."""
    import cv2
    cap = cv2.VideoCapture(str(path))
    frames = []
    while len(frames) < num_frames:
        ok, frame = cap.read()
        if not ok:
            break
        frame = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
        frames.append(cv2.resize(frame, size[::-1]))
    cap.release()
    if not frames:
        raise RuntimeError(f"no frames decoded from {path}")
    while len(frames) < num_frames:
        frames.append(frames[-1])
    x = np.stack(frames).astype(np.float32) / 127.5 - 1.0   # [T,H,W,C]
    return x.transpose(3, 0, 1, 2)


def load_clips(directory: str, num_frames: int, size) -> np.ndarray:
    """All clips in a directory -> [N, C, T, H, W] float32 in [-1, 1]."""
    d = Path(directory)
    paths = sorted(p for p in d.iterdir()
                   if p.suffix.lower() in VIDEO_EXTS + (".npy", ".npz"))
    if not paths:
        raise FileNotFoundError(f"no clips in {directory} "
                                f"(looked for {VIDEO_EXTS} + .npy/.npz)")
    clips = []
    for p in paths:
        if p.suffix.lower() in (".npy", ".npz"):
            x = _load_array(p)
            c, t, h, w = x.shape
            if t < num_frames:
                x = np.concatenate(
                    [x, np.repeat(x[:, -1:], num_frames - t, axis=1)], 1)
            x = x[:, :num_frames]
            if (h, w) != tuple(size):
                x = _resize_frames(x, size)
        else:
            x = _load_video(p, num_frames, size)
        clips.append(np.clip(x, -1.0, 1.0))
    return np.stack(clips)


def build_keypoint_processor(device=None):
    """SapiensKeypointProcessor over a random-init Sapiens backbone of
    KEYPOINT_PRESET, its input and heatmap sizes the preset's."""
    from omnihuman_tpu_torch.omni.keypoints import SapiensKeypointProcessor
    from omnihuman_tpu_torch.omni.sapiens import SapiensBackbone
    bb = SapiensBackbone(preset=KEYPOINT_PRESET, device=device)
    (h, w), (hh, hw) = bb.cfg.img_size, bb.cfg.heatmap_size
    return SapiensKeypointProcessor(backbone=bb, input_size=(w, h),
                                    heatmap_size=(hw, hh), device=device)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        "omni-evaluate",
        description="FID/FVD(/HKC/HKV) between two directories of clips")
    p.add_argument("--real_dir", required=True)
    p.add_argument("--fake_dir", required=True)
    p.add_argument("--num_frames", type=int, default=16)
    p.add_argument("--size", default="64*64", help="eval H*W")
    p.add_argument("--output_dir", default="eval_results")
    p.add_argument("--name", default="cli")
    p.add_argument("--inception_weights", default=None,
                   help="pt_inception / torchvision InceptionV3 state dict "
                        "for standard FID features")
    p.add_argument("--i3d_weights", default=None,
                   help="pytorch-i3d rgb checkpoint: real temporal FVD "
                        "features (omni/i3d.py) instead of the per-frame "
                        "stand-in")
    p.add_argument("--keypoints", action="store_true",
                   help="run the Sapiens keypoint processor for HKC/HKV "
                        "(slow; random-init Sapiens-1b weights)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the GPU; 'cpu' on request)")
    return p


def main(argv=None, keypoint_processor=None):
    """Evaluate; returns the path of the metrics JSON written.
    `keypoint_processor` replaces the one --keypoints would build."""
    args = build_parser().parse_args(argv)

    from omnihuman_tpu_torch.omni.evaluate import OmniHumanEvaluator
    from omnihuman_tpu_torch.utils.logging import logger

    h, w = (int(v) for v in args.size.replace("x", "*").split("*"))
    real = load_clips(args.real_dir, args.num_frames, (h, w))
    fake = load_clips(args.fake_dir, args.num_frames, (h, w))
    n = min(len(real), len(fake))
    if len(real) != len(fake):
        logger.warning(f"unequal clip counts ({len(real)} real, "
                       f"{len(fake)} fake): evaluating the first {n} pairs")
    real, fake = real[:n], fake[:n]

    kp = None
    if args.keypoints:
        kp = keypoint_processor or build_keypoint_processor(args.device)

    ev = OmniHumanEvaluator(
        inception_weights=args.inception_weights,
        i3d_weights=args.i3d_weights,
        keypoint_processor=kp,
        output_dir=args.output_dir, device=args.device)
    metrics = ev.evaluate_batch(real, fake)
    logger.info(f"metrics: {metrics}")
    ev._export(metrics, f"{args.name}_metrics")
    out = os.path.join(args.output_dir, f"{args.name}_metrics.json")
    print(out)
    return out


if __name__ == "__main__":
    main()
