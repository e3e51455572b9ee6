"""Vision input helpers of the Qwen-VL prompt expander (port of
omnihuman_tpu/utils/qwen_vl_utils.py).

`smart_resize` (factor-aligned sizes within a pixel budget), `fetch_image`
(PIL images, local paths, file:// and data:image base64; http(s) raises:
no network), `smart_nframes`, `fetch_video` (a list of image frames, or a
local video file) and `process_vision_info` (the message-tree walker).

No array path imports cv2 (the GPU host may lack it): `fetch_video`
resizes its frames in torch (`omni/pose_utils.resize_image`, cv2's
INTER_LINEAR), and only the decode of a video file imports cv2, lazily,
as `cli/omni_inference.py` reads `--pose_video`.
"""

from __future__ import annotations

import base64
import io
import math
from typing import Any, Dict, List, Tuple, Union

import numpy as np

IMAGE_FACTOR = 28
MIN_PIXELS = 4 * 28 * 28
MAX_PIXELS = 16384 * 28 * 28
MAX_RATIO = 200

VIDEO_MIN_PIXELS = 128 * 28 * 28
VIDEO_MAX_PIXELS = 768 * 28 * 28
FRAME_FACTOR = 2
FPS = 2.0
FPS_MIN_FRAMES = 4
FPS_MAX_FRAMES = 768


def round_by_factor(number: float, factor: int) -> int:
    return round(number / factor) * factor


def ceil_by_factor(number: float, factor: int) -> int:
    return math.ceil(number / factor) * factor


def floor_by_factor(number: float, factor: int) -> int:
    return math.floor(number / factor) * factor


def smart_resize(height: int, width: int, factor: int = IMAGE_FACTOR,
                 min_pixels: int = MIN_PIXELS,
                 max_pixels: int = MAX_PIXELS) -> Tuple[int, int]:
    """Factor-aligned (h, w) within the pixel budget, aspect kept
    (reference qwen_vl_utils.py:53-81)."""
    if max(height, width) / min(height, width) > MAX_RATIO:
        raise ValueError(
            f"absolute aspect ratio must be smaller than {MAX_RATIO}")
    h_bar = max(factor, round_by_factor(height, factor))
    w_bar = max(factor, round_by_factor(width, factor))
    if h_bar * w_bar > max_pixels:
        beta = math.sqrt((height * width) / max_pixels)
        h_bar = floor_by_factor(height / beta, factor)
        w_bar = floor_by_factor(width / beta, factor)
    elif h_bar * w_bar < min_pixels:
        beta = math.sqrt(min_pixels / (height * width))
        h_bar = ceil_by_factor(height * beta, factor)
        w_bar = ceil_by_factor(width * beta, factor)
    return h_bar, w_bar


def fetch_image(ele: Union[str, Dict[str, Any]],
                size_factor: int = IMAGE_FACTOR):
    """Load and smart-resize an image element (qwen_vl_utils.py:84-135):
    a PIL image, a local path, file:// or data:image base64; http(s)
    raises."""
    from PIL import Image
    image = ele.get("image", ele.get("image_url")) if isinstance(
        ele, dict) else ele
    if isinstance(image, Image.Image):
        img = image
    elif isinstance(image, str):
        if image.startswith(("http://", "https://")):
            raise RuntimeError("remote image fetch requires network egress")
        if image.startswith("file://"):
            img = Image.open(image[7:])
        elif image.startswith("data:image"):
            _, b64 = image.split("base64,", 1)
            img = Image.open(io.BytesIO(base64.b64decode(b64)))
        else:
            img = Image.open(image)
    else:
        raise ValueError(f"unsupported image source: {type(image)}")
    img = img.convert("RGB")

    if isinstance(ele, dict) and "resized_height" in ele:
        h, w = (round_by_factor(ele["resized_height"], size_factor),
                round_by_factor(ele["resized_width"], size_factor))
    else:
        opts = ele if isinstance(ele, dict) else {}
        h, w = smart_resize(img.height, img.width, size_factor,
                            opts.get("min_pixels", MIN_PIXELS),
                            opts.get("max_pixels", MAX_PIXELS))
    return img.resize((w, h))


def smart_nframes(ele: Dict[str, Any], total_frames: int,
                  video_fps: float) -> int:
    """Frame count selection (qwen_vl_utils.py:226-270)."""
    if "nframes" in ele:
        return round_by_factor(ele["nframes"], FRAME_FACTOR)
    fps = ele.get("fps", FPS)
    min_frames = ceil_by_factor(ele.get("min_frames", FPS_MIN_FRAMES),
                                FRAME_FACTOR)
    max_frames = floor_by_factor(
        ele.get("max_frames", min(FPS_MAX_FRAMES, total_frames)),
        FRAME_FACTOR)
    nframes = total_frames / video_fps * fps
    nframes = min(max(nframes, min_frames), max_frames)
    nframes = floor_by_factor(nframes, FRAME_FACTOR)
    if not FRAME_FACTOR <= nframes <= total_frames:
        raise ValueError(f"invalid nframes {nframes}")
    return int(nframes)


def _decode_frames(ele: Dict[str, Any]) -> np.ndarray:
    """The `smart_nframes` frames of a local video file, evenly spaced,
    RGB uint8 [T, H, W, 3] (cv2, imported here only)."""
    import cv2
    video = ele["video"]
    cap = cv2.VideoCapture(str(video))
    try:
        total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        vfps = cap.get(cv2.CAP_PROP_FPS) or FPS
        n = smart_nframes(ele, total, vfps)
        frames = []
        for i in np.linspace(0, total - 1, n).round().astype(int):
            cap.set(cv2.CAP_PROP_POS_FRAMES, int(i))
            ok, frame = cap.read()
            if not ok:
                break
            frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
    finally:
        cap.release()
    if not frames:
        raise RuntimeError(f"no frames decoded from {video}")
    return np.stack(frames)


def fetch_video(ele: Dict[str, Any], image_factor: int = IMAGE_FACTOR):
    """[T, H, W, 3] uint8: a list of image frames (each through
    `fetch_image`), or a local video's `smart_nframes` frames resized to
    the video pixel budget (bilinear, in torch)."""
    video = ele["video"]
    if isinstance(video, (list, tuple)):   # list of image frames
        return np.stack([np.asarray(fetch_image({"image": v},
                                                image_factor))
                         for v in video])
    from omnihuman_tpu_torch.omni.pose_utils import resize_image
    x = _decode_frames(ele)
    h, w = smart_resize(x.shape[1], x.shape[2], image_factor,
                        VIDEO_MIN_PIXELS, VIDEO_MAX_PIXELS)
    return np.stack([resize_image(f, (w, h)).numpy() for f in x])


def extract_vision_info(conversations) -> List[Dict]:
    """The image / video elements of a message tree
    (qwen_vl_utils.py:318-340)."""
    vision_infos = []
    if isinstance(conversations[0], dict):
        conversations = [conversations]
    for conv in conversations:
        for message in conv:
            content = message.get("content")
            if isinstance(content, list):
                for ele in content:
                    if isinstance(ele, dict) and (
                            "image" in ele or "image_url" in ele
                            or "video" in ele
                            or ele.get("type") in ("image", "image_url",
                                                   "video")):
                        vision_infos.append(ele)
    return vision_infos


def process_vision_info(conversations):
    """(image_inputs, video_inputs), each None when empty
    (qwen_vl_utils.py:343-362)."""
    image_inputs, video_inputs = [], []
    for info in extract_vision_info(conversations):
        if "image" in info or "image_url" in info:
            image_inputs.append(fetch_image(info))
        elif "video" in info:
            video_inputs.append(fetch_video(info))
        else:
            raise ValueError("image, image_url or video required")
    return image_inputs or None, video_inputs or None
