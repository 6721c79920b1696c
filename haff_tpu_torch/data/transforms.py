"""Image preprocessing on the host (port of haff_tpu/data/transforms.py):
SAM resize-longest-side + pad, CLIP resize + centre crop, mask canvases.

numpy, PIL and cv2 only, the same calls as the JAX package's host path,
so the arrays are equal. The pixel statistics are the port's own copies
(nn/sam.py, below). The device-side (streaming) variants are not ported
yet.
"""

from __future__ import annotations

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
    (canvas, (resize_h, resize_w))."""
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
    normalize with the CLIP statistics."""
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
