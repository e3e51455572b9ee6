"""Sapiens-308 keypoint processor and person-detector glue (port of
omnihuman_tpu/omni/keypoints.py).

Reference Omnihuman/keypoint_processor.py:16-235 and
detector_utils.py:25-158: person detection, a top-down crop to 768x1024,
heatmaps from the Sapiens pose backbone, UDP / DARK decoding, keypoints
normalized to the frame. The backbone is pluggable (any callable crop ->
[K, h, w]): a TorchScript export (`TorchScriptPoseBackbone`, `torch.jit
.load` onto the device), the port's `SapiensBackbone`, or a test double.
Without one, `extract_keypoints` returns None, the reference's failure
path. Detection is self-hosted by default (`HeatmapPersonDetector`: the
backbone's own full-frame response, thresholded and labelled), with the
full frame as the fallback.

Nothing here needs cv2: frames are arrays, the resize, crop and blur run
in torch on the processor's device (`omni/pose_utils.py`), the labelling
on the host through scipy. A backbone receives the crop as a [H, W, 3]
uint8 tensor on that device; a detector receives the frame as given.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from omnihuman_tpu_torch.omni.pose_utils import (
    as_tensor, connected_components, nms, resize_image,
    top_down_affine_transform, udp_decode)
from omnihuman_tpu_torch.utils.logging import logger


def full_frame_detector(image) -> np.ndarray:
    """Fallback detector: the whole frame is one 'person' box."""
    h, w = image.shape[:2]
    return np.array([[0, 0, w - 1, h - 1, 1.0]], np.float32)


class HeatmapPersonDetector:
    """Person boxes from the pose backbone's own heatmaps (JAX
    HeatmapPersonDetector, in place of the reference's mmdet RTMDet,
    detector_utils.py:49-123): the backbone on the resized full frame,
    the max over keypoints thresholded, 8-connected components, one
    padded box per component (score = mean response inside it). Falls
    back to the full frame when nothing clears the threshold.

    image [H, W, 3] uint8 (numpy or tensor) -> [N, 5] (x1, y1, x2, y2, s).
    The resize and the backbone run on `device` (the GPU unless the
    caller asks for the CPU)."""

    def __init__(self, backbone: Callable,
                 input_size: Tuple[int, int] = (768, 1024),
                 threshold: float = 0.3,
                 min_area_frac: float = 1e-3,
                 pad_frac: float = 0.10, device=None):
        from omnihuman_tpu_torch.pipelines.text2video import resolve_device
        self.backbone = backbone
        self.input_size = input_size          # (w, h) backbone input
        self.threshold = threshold
        self.min_area_frac = min_area_frac
        self.pad_frac = pad_frac
        self.device = resolve_device(device)

    def __call__(self, image) -> np.ndarray:
        img = as_tensor(image, self.device)
        h0, w0 = img.shape[:2]
        frame = resize_image(img, self.input_size)
        hm = torch.as_tensor(self.backbone(frame)).float()   # [K, hh, ww]
        resp = hm.amax(dim=0).cpu().numpy()
        hh, ww = resp.shape
        peak = float(resp.max())
        if not np.isfinite(peak) or peak < self.threshold:
            return full_frame_detector(img)
        mask = (resp >= self.threshold).astype(np.uint8)
        n, labels, stats = connected_components(mask)
        sx, sy = w0 / ww, h0 / hh                 # heatmap px -> frame px
        boxes = []
        min_area = self.min_area_frac * hh * ww
        for i in range(1, n):                     # 0 is background
            x, y, bw, bh, area = stats[i]
            if area < min_area:
                continue
            score = float(np.clip(resp[labels == i].mean(), 0.0, 1.0))
            px, py = self.pad_frac * bw, self.pad_frac * bh
            boxes.append([
                max(0.0, (x - px) * sx), max(0.0, (y - py) * sy),
                min(w0 - 1.0, (x + bw + px) * sx),
                min(h0 - 1.0, (y + bh + py) * sy), score])
        if not boxes:
            return full_frame_detector(img)
        return np.asarray(boxes, np.float32)


class TorchScriptPoseBackbone:
    """A TorchScript Sapiens export (the reference's `.pt2`) on `device`:
    crop [H, W, 3] uint8 -> [K, h, w] float32 tensor, normalized as the
    reference transform does (keypoint_processor.py:43-49)."""

    def __init__(self, model_path: str, device=None):
        from omnihuman_tpu_torch.omni.sapiens import SAPIENS_MEAN, SAPIENS_STD
        from omnihuman_tpu_torch.pipelines.text2video import resolve_device
        self.device = resolve_device(device)
        self.model = torch.jit.load(model_path, map_location=self.device)
        self.model.eval()
        self._mean = torch.tensor(SAPIENS_MEAN, device=self.device)
        self._std = torch.tensor(SAPIENS_STD, device=self.device)

    @torch.inference_mode()
    def __call__(self, crop) -> torch.Tensor:
        x = torch.as_tensor(crop, device=self.device).float()
        x = ((x - self._mean) / self._std).permute(2, 0, 1)[None]
        return self.model(x)[0].float()


class SapiensKeypointProcessor:
    """308-keypoint extraction pipeline (JAX SapiensKeypointProcessor).

    checkpoint_path routing: ``*.pt2`` -> `TorchScriptPoseBackbone`;
    anything else -> `SapiensBackbone` (a state dict, sized from the
    file). A load failure leaves no backbone (a warning, and every
    extraction returns None). `backbone` takes any callable crop ->
    [K, h, w]. self_detect: with a backbone and no detector, propose
    person boxes from the backbone's own full-frame heatmaps.

    device: where the backbone, the resize, the crop and the blur run
    (the GPU unless the caller asks for the CPU)."""

    def __init__(
        self,
        checkpoint_path: Optional[str] = None,
        detector: Optional[Callable] = None,
        num_keypoints: int = 308,
        input_size: Tuple[int, int] = (768, 1024),
        heatmap_size: Tuple[int, int] = (192, 256),
        nms_threshold: float = 0.3,
        det_score_threshold: float = 0.3,
        backbone: Optional[Callable] = None,
        self_detect: bool = True,
        device=None,
    ):
        from omnihuman_tpu_torch.pipelines.text2video import resolve_device
        self.num_keypoints = num_keypoints
        self.input_size = input_size
        self.heatmap_size = heatmap_size
        self.nms_threshold = nms_threshold
        self.det_score_threshold = det_score_threshold
        self.device = resolve_device(device)
        self.backbone = backbone
        if backbone is None and checkpoint_path:
            try:
                if checkpoint_path.endswith(".pt2"):
                    self.backbone = TorchScriptPoseBackbone(
                        checkpoint_path, device=self.device)
                else:
                    from omnihuman_tpu_torch.omni.sapiens import (
                        SapiensBackbone)
                    self.backbone = SapiensBackbone(checkpoint_path,
                                                    device=self.device)
                logger.info(f"Loaded Sapiens backbone: {checkpoint_path}")
            except (OSError, RuntimeError, KeyError, ValueError) as e:
                logger.warning(f"Sapiens load failed ({e}); "
                               "keypoint extraction disabled")
        if detector is not None:
            self.detector = detector
        elif self_detect and self.backbone is not None:
            self.detector = HeatmapPersonDetector(
                self.backbone, input_size=input_size, device=self.device)
        else:
            self.detector = full_frame_detector

    def detect_person(self, image) -> Optional[np.ndarray]:
        """Best person bbox after the score filter and NMS
        (detector_utils.py:49-158)."""
        dets = np.asarray(self.detector(image), np.float32)
        if dets.ndim != 2 or len(dets) == 0:
            return None
        dets = dets[dets[:, 4] >= self.det_score_threshold]
        if len(dets) == 0:
            return None
        keep: List[int] = nms(dets, self.nms_threshold)
        return dets[keep[0]] if keep else None

    def extract_keypoints(self, image) -> Optional[np.ndarray]:
        """[H, W, 3] uint8 frame (numpy or tensor) -> [K, 3] (x, y, conf)
        normalized to the frame, or None on failure
        (keypoint_processor.py:85-153)."""
        if self.backbone is None:
            return None
        try:
            bbox = self.detect_person(image)
            if bbox is None:
                return None
            img = as_tensor(image, self.device)
            crop, center, scale = top_down_affine_transform(
                img, bbox, self.input_size)
            heatmaps = torch.as_tensor(self.backbone(crop))   # [K, h, w]
            kp_in, scores = udp_decode(heatmaps, self.input_size)
            # crop coordinates back to the frame
            kp = kp_in / np.array(self.input_size, np.float32)  # 0..1 crop
            kp = kp * scale[None, :] + (center[None, :]
                                        - 0.5 * scale[None, :])
            h, w = img.shape[:2]
            kp_norm = kp / np.array([w, h], np.float32)
            out = np.concatenate(
                [kp_norm, scores[:, None]], axis=-1).astype(np.float32)
            if out.shape[0] != self.num_keypoints:
                pad = np.zeros((self.num_keypoints, 3), np.float32)
                pad[:out.shape[0]] = out[:self.num_keypoints]
                out = pad
            return out
        except Exception as e:   # the reference's None-on-failure contract
            logger.error(f"keypoint extraction failed: {e}")
            return None

    def generate_heatmaps(self, keypoints: np.ndarray,
                          heatmap_size: Optional[Tuple[int, int]] = None,
                          sigma: float = 2.0) -> np.ndarray:
        """[K, 3] -> [K, H, W] (keypoint_processor.py:157-192)."""
        from omnihuman_tpu_torch.omni.dataset import generate_heatmaps
        hs = heatmap_size or (self.heatmap_size[1], self.heatmap_size[0])
        return generate_heatmaps(keypoints, hs, sigma=sigma)
