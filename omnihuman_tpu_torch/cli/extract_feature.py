"""Batch keypoint-heatmap extraction over an image directory (port of
omnihuman_tpu/cli/extract_feature.py, reference
Omnihuman/extract_feature.py:74-207).

    python -m omnihuman_tpu_torch.cli.extract_feature --image_dir imgs/ \\
        --output_dir feats/ [--checkpoint sapiens.pth] [--device cpu]

Each image goes through the Sapiens keypoint processor (detection, crop,
heatmaps, UDP decode; zeros where extraction fails), its keypoints
become Gaussian heatmaps through the native library, and a `WorkerPool`
writes them as `<stem>.npy` [K, H, W] while the next image is processed;
the rate is logged. `run(images, output_dir, processor)` takes (name,
[H, W, 3] uint8 RGB) pairs, so a caller without cv2 drives the same code;
`main` reads the files with cv2, as the JAX CLI does, and exits with a
message where cv2 is absent. The pool's children start by spawn: the
parent may hold a CUDA context and threads.
"""

from __future__ import annotations

import argparse
import multiprocessing
import os
import sys
import time
from typing import Iterable, Tuple

IMAGE_EXTS = (".jpg", ".jpeg", ".png")


def _save_npy(path, arr):
    import numpy as np
    np.save(path, arr)
    return path


def run(images: Iterable[Tuple[str, object]], output_dir: str, processor,
        heatmap_size=(64, 64), num_workers: int = 2) -> int:
    """Heatmaps [K, *heatmap_size] of each (name, image) written to
    `output_dir/<stem>.npy` through a WorkerPool; returns the count
    written (a child's exception is raised here)."""
    import numpy as np

    from omnihuman_tpu_torch import native
    from omnihuman_tpu_torch.omni.worker_pool import WorkerPool
    from omnihuman_tpu_torch.utils.logging import logger

    os.makedirs(output_dir, exist_ok=True)
    t0 = time.time()
    written = 0
    ctx = multiprocessing.get_context("spawn")
    with WorkerPool(processes=num_workers, context=ctx) as pool:
        pending = []
        for name, img in images:
            kps = processor.extract_keypoints(img)
            if kps is None:
                kps = np.zeros((processor.num_keypoints, 3), np.float32)
            hm = native.gaussian_heatmaps(kps[None], tuple(heatmap_size))
            out = os.path.join(output_dir,
                               os.path.splitext(name)[0] + ".npy")
            pending.append(pool.apply_async(_save_npy, (out, hm[0])))
        for r in pending:
            r.get(timeout=60)
            written += 1
    dt = time.time() - t0
    logger.info(f"extracted {written} feature files in {dt:.1f}s "
                f"({written / max(dt, 1e-9):.1f} img/s)")
    return written


def _read_images(image_dir: str, names):
    import cv2
    for name in names:
        img = cv2.imread(os.path.join(image_dir, name))
        yield name, cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def main(argv=None):
    p = argparse.ArgumentParser("omnihuman-tpu-torch extract-feature")
    p.add_argument("--image_dir", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--checkpoint", default=None,
                   help="Sapiens TorchScript .pt2 or state dict (optional; "
                        "without it every image gets zero heatmaps)")
    p.add_argument("--batch_size", type=int, default=8,
                   help="accepted for the JAX CLI's command line; images go "
                        "one at a time, as there")
    p.add_argument("--num_workers", type=int, default=2)
    p.add_argument("--heatmap_size", type=int, nargs=2, default=(64, 64))
    p.add_argument("--device", default=None,
                   help="torch device (default: the GPU; 'cpu' on request)")
    args = p.parse_args(argv)

    from omnihuman_tpu_torch.omni.keypoints import SapiensKeypointProcessor
    from omnihuman_tpu_torch.utils.logging import logger

    try:
        import cv2  # noqa: F401
    except ImportError:
        sys.exit("cli.extract_feature reads images with cv2, which is not "
                 "installed: pass decoded arrays to "
                 "omnihuman_tpu_torch.cli.extract_feature.run instead")
    proc = SapiensKeypointProcessor(checkpoint_path=args.checkpoint,
                                    device=args.device)
    names = sorted(f for f in os.listdir(args.image_dir)
                   if f.lower().endswith(IMAGE_EXTS))
    if not names:
        logger.warning(f"no images in {args.image_dir}")
        return 0
    return run(_read_images(args.image_dir, names), args.output_dir, proc,
               tuple(args.heatmap_size), args.num_workers)


if __name__ == "__main__":
    main()
