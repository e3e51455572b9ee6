"""Host-side media IO (copies of `cache_video` and `cache_image` from
omnihuman_tpu/utils/media.py, reference wan/utils/utils.py:23-91). Arrays
are [C, F, H, W] (or [B, C, F, H, W], written as a grid) and [C, H, W]
(or [B, C, H, W]) in a [-1, 1]-style value range."""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def _to_uint8(x: np.ndarray, value_range=(-1.0, 1.0)) -> np.ndarray:
    lo, hi = value_range
    x = (np.asarray(x, np.float32) - lo) / (hi - lo)
    return (np.clip(x, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def make_grid(frames: np.ndarray, nrow: int = 8, pad: int = 1) -> np.ndarray:
    """[N, H, W, C] -> one [H', W', C] grid (torchvision.make_grid-ish)."""
    n, h, w, c = frames.shape
    ncol = min(nrow, n)
    nr = (n + ncol - 1) // ncol
    grid = np.zeros((nr * (h + pad) + pad, ncol * (w + pad) + pad, c),
                    frames.dtype)
    for i in range(n):
        r, cl = divmod(i, ncol)
        grid[pad + r * (h + pad): pad + r * (h + pad) + h,
             pad + cl * (w + pad): pad + cl * (w + pad) + w] = frames[i]
    return grid


def cache_video(tensor, save_file: Optional[str] = None, fps: int = 16,
                suffix: str = ".mp4", nrow: int = 8,
                value_range=(-1.0, 1.0), retry: int = 5) -> Optional[str]:
    """[C, F, H, W] (or [B, C, F, H, W] -> grid) -> mp4, or a GIF where no
    mp4 encoder is installed, or the uint8 frames as .npy where imageio
    itself is absent. Accepts numpy arrays and torch tensors; returns the
    path written."""
    import tempfile
    if hasattr(tensor, "detach"):
        tensor = tensor.detach().float().cpu().numpy()
    x = np.asarray(tensor)
    if x.ndim == 4:
        x = x[None]
    x = x.transpose(2, 0, 3, 4, 1)  # [F, B, H, W, C]
    frames = np.stack([make_grid(_to_uint8(f, value_range), nrow=nrow)
                       for f in x])

    if save_file is None:
        save_file = tempfile.NamedTemporaryFile(
            suffix=suffix, delete=False).name
    parent = os.path.dirname(save_file)
    if parent:
        os.makedirs(parent, exist_ok=True)

    try:
        import imageio
    except ImportError:   # no video writer installed: keep the frames
        npy_file = os.path.splitext(save_file)[0] + ".npy"
        np.save(npy_file, frames)          # [F, H', W', 3] uint8
        return npy_file
    err = None
    for _ in range(retry):
        try:
            writer = imageio.get_writer(save_file, fps=fps, codec="libx264",
                                        quality=8)
            for f in frames:
                writer.append_data(f)
            writer.close()
            return save_file
        except Exception as e:  # pragma: no cover - io flake retry
            err = e
            if "backend" in str(e).lower():
                break  # no mp4 encoder in this environment: fall back
    try:
        gif_file = os.path.splitext(save_file)[0] + ".gif"
        imageio.mimwrite(gif_file, list(frames), duration=1000.0 / fps,
                         loop=0)
        return gif_file
    except Exception:
        raise RuntimeError(
            f"cache_video failed after {retry} tries: {err}")


def cache_image(tensor, save_file: str, nrow: int = 8,
                value_range=(-1.0, 1.0)) -> str:
    """[C, H, W] or [B, C, H, W] -> one png grid, or the uint8 grid as
    .npy where imageio is absent. Accepts numpy arrays and torch tensors;
    returns the path written."""
    if hasattr(tensor, "detach"):
        tensor = tensor.detach().float().cpu().numpy()
    x = np.asarray(tensor)
    if x.ndim == 3:
        x = x[None]
    grid = make_grid(_to_uint8(x.transpose(0, 2, 3, 1), value_range),
                     nrow=nrow)
    parent = os.path.dirname(save_file)
    if parent:
        os.makedirs(parent, exist_ok=True)
    try:
        import imageio
    except ImportError:   # no image writer installed: keep the pixels
        npy_file = os.path.splitext(save_file)[0] + ".npy"
        np.save(npy_file, grid)            # [H', W', 3] uint8
        return npy_file
    imageio.imwrite(save_file, grid)
    return save_file
