"""Pose decoding utilities (port of omnihuman_tpu/omni/pose_utils.py).

UDP heatmap decoding with DARK refinement, UDP warp matrices, the
top-down affine crop, bbox NMS, and the two image operations the JAX
module and its keypoint processor take from OpenCV, written here in
torch so that they run on the processor's device without cv2:

  - `gaussian_blur`: cv2.GaussianBlur(k=11, sigma=0) after a zero
    border, i.e. cv2's 11-tap kernel at sigma 0.3 * ((k - 1) / 2 - 1) +
    0.8 = 2.0 as a separable conv with zero padding;
  - `warp_affine`: cv2.warpAffine(INTER_LINEAR, constant 0 border) as an
    inverse bilinear map in float (cv2's uint8 path works in fixed point,
    a level or two apart);
  - `resize_image`: cv2.resize(INTER_LINEAR) (half-pixel centres, edge
    clamp, no antialiasing), a level or so from cv2's 11-bit weights;
  - `connected_components`: cv2.connectedComponentsWithStats at
    8-connectivity through scipy.ndimage.label, numbered in cv2's order,
    with the same [x, y, w, h, area] stats.

Arrays may be numpy arrays or torch tensors; a tensor stays on its
device. The argmax and the 5x5 neighbourhoods DARK needs are gathered on
that device, the 2x2 Taylor step runs in numpy float32 on the host.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def as_tensor(x, device=None) -> torch.Tensor:
    """A tensor view of an array (numpy arrays are copied to `device`, CPU
    by default); a tensor moves only where `device` is given."""
    if torch.is_tensor(x):
        return x if device is None else x.to(device)
    return torch.from_numpy(np.ascontiguousarray(x)).to(device or "cpu")


def get_heatmap_maximum(heatmaps) -> Tuple[np.ndarray, np.ndarray]:
    """[K, H, W] -> (locs [K, 2] xy, vals [K]); locs -1 where the max <= 0."""
    hm = as_tensor(heatmaps).float()
    k, h, w = hm.shape
    flat = hm.reshape(k, -1)
    idx = flat.argmax(dim=1)
    vals = flat.gather(1, idx[:, None])[:, 0].cpu().numpy()
    idx = idx.cpu().numpy()
    locs = np.stack([idx % w, idx // w], axis=-1).astype(np.float32)
    locs[vals <= 0] = -1
    return locs, vals


def gaussian_kernel_1d(kernel: int) -> np.ndarray:
    """cv2.getGaussianKernel(kernel, 0, CV_32F): sigma from the size,
    taps cast to float32 and normalised by their float64 sum."""
    sigma = 0.3 * ((kernel - 1) * 0.5 - 1) + 0.8
    x = np.arange(kernel, dtype=np.float64) - (kernel - 1) * 0.5
    taps = np.exp(-0.5 / (sigma * sigma) * x * x).astype(np.float32)
    return (taps * (1.0 / taps.astype(np.float64).sum())).astype(np.float32)


def gaussian_blur(heatmaps, kernel: int = 11) -> torch.Tensor:
    """Per-channel Gaussian blur on zero padding, each map rescaled to
    keep its maximum (pose_utils.py modulation step). [K, H, W] ->
    [K, H, W] float32 on the input's device."""
    hm = as_tensor(heatmaps).float()
    taps = torch.from_numpy(gaussian_kernel_1d(kernel)).to(hm.device)
    r = (kernel - 1) // 2
    x = hm[:, None]
    x = F.conv2d(x, taps.view(1, 1, 1, kernel), padding=(0, r))
    x = F.conv2d(x, taps.view(1, 1, kernel, 1), padding=(r, 0))[:, 0]
    km = hm.amax(dim=(1, 2), keepdim=True)
    bm = x.amax(dim=(1, 2), keepdim=True)
    return torch.where(bm > 0, x * (km / torch.where(bm > 0, bm, 1.0)), x)


def refine_keypoints_dark_udp(keypoints: np.ndarray, heatmaps,
                              blur_kernel_size: int = 11) -> np.ndarray:
    """DARK-UDP refinement: a Taylor step on the blurred log-heatmap around
    each argmax, from its first and second derivatives (pose_utils.py:90-150).
    Keypoints within 2 pixels of an edge, or with a singular Hessian, stay."""
    hm = as_tensor(heatmaps).float()
    k, h, w = hm.shape
    logm = gaussian_blur(hm, blur_kernel_size).clamp(1e-3, 50.0).log()
    out = np.array(keypoints, np.float32, copy=True)
    x = out[:, 0].astype(np.int64)
    y = out[:, 1].astype(np.int64)
    ok = (1 < x) & (x < w - 2) & (1 < y) & (y < h - 2)
    if not ok.any():                  # also every map smaller than 5x5
        return out
    d = np.arange(-2, 3)
    rows = np.clip(y, 2, h - 3)[:, None] + d
    cols = np.clip(x, 2, w - 3)[:, None] + d
    idx = torch.from_numpy((rows[:, :, None] * w + cols[:, None, :]
                            ).reshape(k, 25)).to(hm.device)
    p = logm.reshape(k, -1).gather(1, idx).reshape(k, 5, 5).cpu().numpy()
    dx = 0.5 * (p[:, 2, 3] - p[:, 2, 1])
    dy = 0.5 * (p[:, 3, 2] - p[:, 1, 2])
    dxx = 0.25 * (p[:, 2, 4] - 2 * p[:, 2, 2] + p[:, 2, 0])
    dxy = 0.25 * (p[:, 3, 3] - p[:, 1, 3] - p[:, 3, 1] + p[:, 1, 1])
    dyy = 0.25 * (p[:, 4, 2] - 2 * p[:, 2, 2] + p[:, 0, 2])
    det = dxx * dyy - dxy * dxy
    ok &= np.abs(det) > 1e-12
    det = np.where(ok, det, np.float32(1))
    off = -np.stack([dyy / det * dx + (-dxy / det) * dy,
                     (-dxy / det) * dx + dxx / det * dy], axis=-1)
    out[ok, :2] += np.clip(off, -1.0, 1.0)[ok]
    return out


def udp_decode(heatmaps, input_size: Tuple[int, int],
               heatmap_size: Optional[Tuple[int, int]] = None,
               blur_kernel_size: int = 11
               ) -> Tuple[np.ndarray, np.ndarray]:
    """[K, H, W] -> (keypoints [K, 2] in input pixels, scores [K])
    (pose_utils.py:153-180)."""
    k, h, w = heatmaps.shape
    locs, vals = get_heatmap_maximum(heatmaps)
    locs = refine_keypoints_dark_udp(locs, heatmaps, blur_kernel_size)
    iw, ih = input_size
    scale = np.array([iw / max(w - 1, 1), ih / max(h - 1, 1)], np.float32)
    return locs * scale, vals


def get_udp_warp_matrix(center: np.ndarray, scale: np.ndarray, rot: float,
                        output_size: Tuple[int, int]) -> np.ndarray:
    """Unbiased affine warp (pose_utils.py:182-226)."""
    ow, oh = output_size
    rot_rad = math.radians(rot)
    cs, sn = math.cos(rot_rad), math.sin(rot_rad)
    sx = (ow - 1) / scale[0]
    sy = (oh - 1) / scale[1]
    m = np.zeros((2, 3), np.float32)
    m[0, 0] = cs * sx
    m[0, 1] = -sn * sx
    m[0, 2] = sx * (-cs * center[0] + sn * center[1] + 0.5 * scale[0])
    m[1, 0] = sn * sy
    m[1, 1] = cs * sy
    m[1, 2] = sy * (-sn * center[0] - cs * center[1] + 0.5 * scale[1])
    return m


def _invert_affine(m: np.ndarray) -> np.ndarray:
    """cv2.invertAffineTransform in float64."""
    m = np.asarray(m, np.float64)
    det = m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]
    det = 1.0 / det if det != 0 else 0.0
    a11, a22 = m[1, 1] * det, m[0, 0] * det
    a12, a21 = -m[0, 1] * det, -m[1, 0] * det
    return np.array([[a11, a12, -a11 * m[0, 2] - a12 * m[1, 2]],
                     [a21, a22, -a21 * m[0, 2] - a22 * m[1, 2]]])


def warp_affine(img, m: np.ndarray,
                output_size: Tuple[int, int]) -> torch.Tensor:
    """cv2.warpAffine(img, m, output_size, INTER_LINEAR) with a constant 0
    border: [H, W, C] uint8 -> [oh, ow, C] uint8 on the image's device.
    Each output pixel samples the source bilinearly at the inverse map
    of its position (cv2.invertAffineTransform's, in float64), taps
    outside the image read as 0, rounded to the nearest level."""
    src = as_tensor(img)
    dev = src.device
    hs, ws = src.shape[:2]
    ow, oh = output_size
    inv = torch.from_numpy(_invert_affine(m)).to(dev)
    xs = torch.arange(ow, dtype=torch.float64, device=dev)[None, :]
    ys = torch.arange(oh, dtype=torch.float64, device=dev)[:, None]
    sx = inv[0, 0] * xs + inv[0, 1] * ys + inv[0, 2]        # [oh, ow]
    sy = inv[1, 0] * xs + inv[1, 1] * ys + inv[1, 2]
    x0, y0 = sx.floor(), sy.floor()
    fx = (sx - x0).float()[..., None]
    fy = (sy - y0).float()[..., None]
    x0, y0 = x0.long(), y0.long()
    flat = src.reshape(hs * ws, -1).float()

    def tap(yy, xx):
        inside = (xx >= 0) & (xx < ws) & (yy >= 0) & (yy < hs)
        v = flat[(yy.clamp(0, hs - 1) * ws + xx.clamp(0, ws - 1))]
        return v * inside[..., None]

    out = ((1 - fy) * ((1 - fx) * tap(y0, x0) + fx * tap(y0, x0 + 1))
           + fy * ((1 - fx) * tap(y0 + 1, x0) + fx * tap(y0 + 1, x0 + 1)))
    return out.round().clamp(0, 255).to(torch.uint8)


def resize_image(img, size: Tuple[int, int]) -> torch.Tensor:
    """cv2.resize(img, size) with INTER_LINEAR: [H, W, C] uint8 ->
    [size[1], size[0], C] uint8 (size is (w, h), as cv2's dsize)."""
    x = as_tensor(img)
    w, h = size
    y = F.interpolate(x.permute(2, 0, 1)[None].float(), size=(h, w),
                      mode="bilinear", align_corners=False)
    return y[0].permute(1, 2, 0).round().clamp(0, 255).to(torch.uint8)


def connected_components(mask: np.ndarray
                         ) -> Tuple[int, np.ndarray, np.ndarray]:
    """cv2.connectedComponentsWithStats(mask) at 8-connectivity: (number of
    labels with the background's 0, labels [H, W] int32, stats [n, 5]
    int32 of [x, y, w, h, area] per label). scipy.ndimage.label finds the
    components; they are numbered as cv2's block-based scan numbers them,
    by the first 2x2 block (in raster order of blocks) that holds one of
    their pixels (a 2x2 block never holds two components)."""
    from scipy import ndimage
    mask = np.asarray(mask) != 0
    labels, n = ndimage.label(mask, structure=np.ones((3, 3), bool))
    h, w = mask.shape
    ys, xs = np.nonzero(labels)
    first = np.full(n + 1, np.iinfo(np.int64).max)
    np.minimum.at(first, labels[ys, xs], (ys // 2) * ((w + 1) // 2) + xs // 2)
    order = np.zeros(n + 1, np.int32)
    order[1 + np.argsort(first[1:], kind="stable")] = np.arange(
        1, n + 1, dtype=np.int32)
    labels = order[labels]
    stats = np.zeros((n + 1, 5), np.int32)
    stats[:, 4] = np.bincount(labels.ravel(), minlength=n + 1)
    boxes = ndimage.find_objects(labels)
    background = np.argwhere(labels == 0)
    spans = [(tuple(background.min(0)), tuple(background.max(0) + 1))
             if len(background) else None]
    spans += [((b[0].start, b[1].start), (b[0].stop, b[1].stop))
              for b in boxes]
    for i, span in enumerate(spans):
        if span is not None:
            (y0, x0), (y1, x1) = span
            stats[i, :4] = (x0, y0, x1 - x0, y1 - y0)
    return n + 1, labels, stats


def top_down_affine_transform(img, bbox: np.ndarray,
                              output_size: Tuple[int, int] = (768, 1024),
                              padding: float = 1.25):
    """Crop a person bbox to the pose-model input (pose_utils.py:229-270):
    (crop [oh, ow, 3] uint8 tensor on the image's device, center, scale)."""
    x1, y1, x2, y2 = bbox[:4]
    center = np.array([(x1 + x2) / 2, (y1 + y2) / 2], np.float32)
    w, h = (x2 - x1) * padding, (y2 - y1) * padding
    ow, oh = output_size
    aspect = ow / oh
    if w / max(h, 1e-6) > aspect:
        h = w / aspect
    else:
        w = h * aspect
    scale = np.array([w, h], np.float32)
    m = get_udp_warp_matrix(center, scale, 0.0, output_size)
    return warp_affine(img, m, output_size), center, scale


def nms(dets: np.ndarray, thr: float) -> List[int]:
    """Greedy IoU NMS over [N, 5] (x1, y1, x2, y2, score)
    (pose_utils.py:273-312)."""
    if len(dets) == 0:
        return []
    x1, y1, x2, y2, scores = dets.T[:5]
    areas = (x2 - x1 + 1) * (y2 - y1 + 1)
    order = scores.argsort()[::-1]
    keep = []
    while order.size > 0:
        i = order[0]
        keep.append(int(i))
        xx1 = np.maximum(x1[i], x1[order[1:]])
        yy1 = np.maximum(y1[i], y1[order[1:]])
        xx2 = np.minimum(x2[i], x2[order[1:]])
        yy2 = np.minimum(y2[i], y2[order[1:]])
        iw = np.maximum(0.0, xx2 - xx1 + 1)
        ih = np.maximum(0.0, yy2 - yy1 + 1)
        inter = iw * ih
        iou = inter / (areas[i] + areas[order[1:]] - inter)
        order = order[1:][iou <= thr]
    return keep
