"""Image preprocessing on the host (port of haff_tpu/data/transforms.py):
SAM resize-longest-side + pad, CLIP resize + centre crop, mask canvases.

numpy, PIL and cv2 only, the same calls as the JAX package's host path,
so the arrays are equal. The pixel statistics are the port's own copies
(nn/sam.py, below). `device_sam_preprocess` / `device_clip_preprocess`
are the streaming path's counterparts on tensors on the model's device
(resize, pad and normalize next to the model instead of on the host).
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from ..nn.sam import PIXEL_MEAN, PIXEL_STD

# OpenAI CLIP pixel statistics (0-1 scale).
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def get_preprocess_shape(h: int, w: int, long_side: int) -> Tuple[int, int]:
    """Output (h, w) with the longest side == long_side (reference
    transforms.py: int(side * scale + 0.5))."""
    scale = long_side * 1.0 / max(h, w)
    return int(h * scale + 0.5), int(w * scale + 0.5)


def resize_longest_side(image: np.ndarray, long_side: int) -> np.ndarray:
    """PIL bilinear (antialiased), as the reference resizes through
    torchvision's to_pil_image + resize."""
    from PIL import Image

    h, w = image.shape[:2]
    nh, nw = get_preprocess_shape(h, w, long_side)
    return np.asarray(Image.fromarray(image).resize((nw, nh), Image.BILINEAR))


def sam_preprocess(image: np.ndarray, image_size: int = 1024):
    """uint8 RGB (H, W, 3) -> (image_size, image_size, 3) float32,
    normalized and zero-padded bottom and right; returns
    (canvas, (resize_h, resize_w)).

    HAFF_NATIVE_PREPROCESS=1 takes the fused C++ path (data/native.py),
    whose cv2.INTER_LINEAR-style resampling has no antialias: downscaled
    pixels differ slightly from this PIL path."""
    if (os.environ.get("HAFF_NATIVE_PREPROCESS") == "1"
            and image.dtype == np.uint8):
        from . import native

        if native.available():
            return native.sam_preprocess_native(image, image_size,
                                                PIXEL_MEAN, PIXEL_STD)
    resized = resize_longest_side(image, image_size).astype(np.float32)
    resized = (resized - PIXEL_MEAN) / PIXEL_STD
    h, w = resized.shape[:2]
    canvas = np.zeros((image_size, image_size, 3), np.float32)
    canvas[:h, :w] = resized
    return canvas, (h, w)


def clip_preprocess(image: np.ndarray, image_size: int = 224) -> np.ndarray:
    """uint8 RGB -> (image_size, image_size, 3) float32 with HF
    CLIPImageProcessor semantics: PIL-bicubic resize of the short side to
    image_size (the long side int-truncated), centre crop, scale 1/255,
    normalize with the CLIP statistics.

    HAFF_NATIVE_PREPROCESS=1 takes the fused C++ path, which reproduces
    PIL's resampler to 1 LSB of its fixed-point rounding."""
    if (os.environ.get("HAFF_NATIVE_PREPROCESS") == "1"
            and image.dtype == np.uint8):
        from . import native

        if native.available():
            return native.clip_preprocess_native(image, image_size,
                                                 CLIP_MEAN, CLIP_STD)
    from PIL import Image

    h, w = image.shape[:2]
    if h <= w:
        nh, nw = image_size, int(image_size * w / h)
    else:
        nh, nw = int(image_size * h / w), image_size
    resized = np.asarray(Image.fromarray(image).resize((nw, nh),
                                                       Image.BICUBIC))
    top = (nh - image_size) // 2
    left = (nw - image_size) // 2
    crop = resized[top:top + image_size, left:left + image_size]
    x = crop.astype(np.float32) / 255.0
    return (x - np.array(CLIP_MEAN, np.float32)) / np.array(CLIP_STD,
                                                            np.float32)


def mask_to_canvas(mask: np.ndarray, resize_hw: Tuple[int, int],
                   image_size: int = 1024) -> np.ndarray:
    """Binary ground-truth mask at the original resolution -> the SAM
    padded canvas (nearest resize keeps it binary)."""
    import cv2

    h, w = resize_hw
    resized = cv2.resize(mask.astype(np.uint8), (w, h),
                         interpolation=cv2.INTER_NEAREST)
    canvas = np.zeros((image_size, image_size), np.float32)
    canvas[:h, :w] = resized
    return canvas


def valid_region(resize_hw: Tuple[int, int], image_size: int = 1024):
    """1 inside the resized frame on the padded canvas, 0 in the padding."""
    h, w = resize_hw
    m = np.zeros((image_size, image_size), np.float32)
    m[:h, :w] = 1.0
    return m


# --------------------------- device-side (streaming) ---------------------

def _resize_bilinear(x, size: Tuple[int, int]):
    """(B, C, H, W) float32 -> (B, C, *size) with jax.image.resize's
    "bilinear": half-pixel centres, a triangle kernel widened to the
    output's pixel size (antialiased) along an axis that shrinks and not
    along one that keeps or grows its size. F.interpolate's antialias
    flag covers both axes at once, so an axis pair that disagrees takes
    two passes."""
    import torch.nn.functional as F

    h, w = x.shape[-2:]
    interp = lambda t, hw, aa: F.interpolate(  # noqa: E731
        t, size=hw, mode="bilinear", align_corners=False, antialias=aa)
    if (size[0] < h) != (size[1] < w):
        return interp(interp(x, (size[0], w), size[0] < h), size, size[1] < w)
    return interp(x, size, size[0] < h)


def _nchw_float(frames):
    import torch

    return torch.as_tensor(frames).permute(0, 3, 1, 2).float()


def _normalize_nhwc(x, mean, std):
    """(B, C, H, W) -> per-channel (x - mean) / std as (B, H, W, C)."""
    import torch

    stats = torch.as_tensor(np.array((mean, std), np.float32),
                            device=x.device)
    x = (x - stats[0, :, None, None]) / stats[1, :, None, None]
    return x.permute(0, 2, 3, 1).contiguous()


def device_sam_preprocess(frames, image_size: int = 1024,
                          resize_hw: Tuple[int, int] = None):
    """SAM preprocessing where `frames` lie (B, H, W, 3) uint8 or float on
    the 0-255 scale -> the (B, image_size, image_size, 3) float32 canvas,
    normalized and zero-padded bottom and right, and the resize shape."""
    import torch.nn.functional as F

    h, w = frames.shape[1:3]
    nh, nw = resize_hw or get_preprocess_shape(h, w, image_size)
    x = _normalize_nhwc(_resize_bilinear(_nchw_float(frames), (nh, nw)),
                        PIXEL_MEAN, PIXEL_STD)
    return F.pad(x, (0, 0, 0, image_size - nw, 0, image_size - nh)), (nh, nw)


def device_clip_preprocess(frames, image_size: int = 224):
    """CLIP preprocessing where `frames` lie: bilinear short-side resize
    (rounded, as the JAX device path), centre crop, scale 1/255, CLIP
    normalization. (B, H, W, 3) -> (B, image_size, image_size, 3)."""
    h, w = frames.shape[1:3]
    scale = image_size / min(h, w)
    nh, nw = round(h * scale), round(w * scale)
    x = _resize_bilinear(_nchw_float(frames), (nh, nw))
    top = (nh - image_size) // 2
    left = (nw - image_size) // 2
    x = x[:, :, top:top + image_size, left:left + image_size] / 255.0
    return _normalize_nhwc(x, CLIP_MEAN, CLIP_STD)
