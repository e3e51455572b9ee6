"""ctypes bindings for the native data-plane library (port of
omnihuman_tpu/native.py).

`cpp/omnidata.cpp` (at the repository's root, shared with the JAX
package and free of any framework) holds the host-side hot loops:
Gaussian heatmap synthesis over 308 keypoints x frames, uint8 -> float
frame conversion and PCM decode, threaded with std::thread. This module
binds the same `cpp/libomnidata.so`, builds it with `make -C cpp` where it
is missing, and falls back to the NumPy versions (the port's
`omni/dataset.py:generate_heatmaps` for the heatmaps) where it cannot be
built or loaded.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional, Tuple

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _lib_path() -> str:
    return os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "cpp", "libomnidata.so")


def load_library(build_if_missing: bool = True) -> Optional[ctypes.CDLL]:
    """The bound library, or None where it is absent and cannot be built;
    tried once a process."""
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    path = _lib_path()
    if not os.path.exists(path) and build_if_missing:
        try:
            subprocess.run(["make", "-C", os.path.dirname(path)],
                           check=True, capture_output=True, timeout=120)
        except (OSError, subprocess.SubprocessError):
            return None
    if not os.path.exists(path):
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    i16p = np.ctypeslib.ndpointer(np.int16, flags="C_CONTIGUOUS")
    lib.gaussian_heatmaps.argtypes = [
        f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, f32p]
    lib.gaussian_heatmaps.restype = None
    lib.frames_to_float.argtypes = [
        u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, f32p]
    lib.frames_to_float.restype = None
    lib.pcm16_to_float_mono.argtypes = [
        i16p, ctypes.c_longlong, ctypes.c_int, f32p]
    lib.pcm16_to_float_mono.restype = None
    lib.omnidata_version.argtypes = []
    lib.omnidata_version.restype = ctypes.c_int
    _LIB = lib
    return _LIB


def available() -> bool:
    return load_library() is not None


def gaussian_heatmaps(keypoints: np.ndarray, heatmap_size: Tuple[int, int],
                      sigma: float = 2.0,
                      conf_threshold: float = 0.1) -> np.ndarray:
    """[T, K, 3] normalized keypoints (x, y, conf) -> [T, K, H, W] float32
    heatmaps."""
    kp = np.ascontiguousarray(keypoints, np.float32)
    if kp.ndim != 3 or kp.shape[2] != 3:
        raise ValueError(f"keypoints must be [T, K, 3], got {kp.shape}")
    t, k, _ = kp.shape
    h, w = heatmap_size
    lib = load_library()
    if lib is not None:
        out = np.empty((t, k, h, w), np.float32)
        lib.gaussian_heatmaps(kp, t, k, h, w, float(sigma),
                              float(conf_threshold), out)
        return out
    from omnihuman_tpu_torch.omni.dataset import generate_heatmaps
    return np.stack([generate_heatmaps(kp[i], (h, w), sigma, conf_threshold)
                     for i in range(t)])


def frames_to_float(frames: np.ndarray) -> np.ndarray:
    """[T, H, W, C] uint8 -> [C, T, H, W] float32 in [-1, 1]."""
    fr = np.ascontiguousarray(frames, np.uint8)
    if fr.ndim != 4:
        raise ValueError(f"frames must be [T, H, W, C], got {fr.shape}")
    t, h, w, c = fr.shape
    lib = load_library()
    if lib is not None:
        out = np.empty((c, t, h, w), np.float32)
        lib.frames_to_float(fr, t, h, w, c, out)
        return out
    return (fr.astype(np.float32) / 127.5 - 1.0).transpose(3, 0, 1, 2)


def pcm16_to_float_mono(pcm: np.ndarray, channels: int = 1) -> np.ndarray:
    """[N] int16 interleaved -> [N / channels] float32 mono in [-1, 1]."""
    x = np.ascontiguousarray(pcm, np.int16)
    frames = x.size // channels
    lib = load_library()
    if lib is not None:
        out = np.empty((frames,), np.float32)
        lib.pcm16_to_float_mono(x, x.size, channels, out)
        return out
    y = x.astype(np.float32) / 32768.0
    if channels > 1:
        y = y.reshape(-1, channels).mean(-1)
    return y
