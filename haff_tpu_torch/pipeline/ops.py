"""2HANDS pipeline mask and image operations on tensors (port of
haff_tpu/pipeline/ops.py).

Capability parity with the reference's per-file cv2 loops (reference:
2HANDS/scripts/affordance_extraction_preparation.py,
data_augmentation/*, data_setup/*): dilate + recolor, affordance
extraction (hand AND completed object), square padding, horizontal-flip
augmentation (left <-> right swap + taxonomy flip), crop around a box,
color jitter, area filtering.

The batched ops take and return tensors on whatever device they live on
(the pipeline puts them on the card); `crop_around_bbox`, `mask_area_ok`
and `narration_ok` are host-side, as in JAX.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def dilate_masks(masks: torch.Tensor, factor: int = 10) -> torch.Tensor:
    """Binary dilation with a (factor x factor) ones kernel (reference
    affordance_extraction_preparation.py dilate_masks). masks (B, H, W) in
    {0, 1} -> float32 (B, H, W). A max-pool over zero padding."""
    # cv2's even-kernel anchor sits at factor // 2: a pixel dilates
    # factor // 2 BEFORE and factor - 1 - factor // 2 AFTER it; a window
    # covering [i - pad_lo, i + pad_hi] needs pad_lo = the AFTER count.
    pad_lo = factor - 1 - factor // 2
    pad_hi = factor // 2
    x = F.pad(masks.float()[:, None], (pad_lo, pad_hi, pad_lo, pad_hi))
    # JAX's reduce_window starts from 0.0, so its result is max(0, window).
    return F.max_pool2d(x, factor, stride=1)[:, 0].clamp_min(0.0)


def recolor_white(masks: torch.Tensor) -> torch.Tensor:
    """Any nonzero -> 1 (reference recolor_masks_white, scaled to {0,1})."""
    return (masks != 0).float()


def extract_affordance(hand_masks: torch.Tensor,
                       object_masks: torch.Tensor) -> torch.Tensor:
    """Affordance = hand AND completed object (reference
    affordance_extraction_preparation.py:256-304 bitwise_and)."""
    return ((hand_masks != 0) & (object_masks != 0)).float()


def pad_to_square(images: torch.Tensor) -> torch.Tensor:
    """Pad top/left to square (reference pad_image: the SHORT side is
    padded at its leading edge). images (B, H, W, ...)."""
    b, h, w = images.shape[:3]
    s = max(h, w)
    out = images.new_zeros((b, s, s) + tuple(images.shape[3:]))
    out[:, s - h:, s - w:] = images
    return out


def horizontal_flip_sample(image, mask_left, mask_right, taxonomy):
    """Flip augmentation: mirror the image and SWAP left <-> right masks;
    the taxonomy flips left-only <-> right-only (reference
    horizontal_flip.py:7-80; bimanual classes 2/3 unchanged). image
    (H, W, 3) or (B, H, W, 3); masks (..., H, W); taxonomy (..., 4)."""
    image_f = image.flip(1 if image.ndim == 3 else 2)
    new_left = mask_right.flip(-1)
    new_right = mask_left.flip(-1)
    tax = taxonomy[..., [1, 0, 2, 3]]
    return image_f, new_left, new_right, tax


def crop_around_bbox(image, bbox: Tuple[int, int, int, int],
                     offset: int = 50) -> np.ndarray:
    """Object-bbox crop with a pixel offset, clamped to the frame
    (reference process_cropped_sequences.py:14-230). Host-side (the
    output shape depends on the box)."""
    x0, y0, x1, y1 = bbox
    h, w = image.shape[:2]
    x0 = max(0, x0 - offset)
    y0 = max(0, y0 - offset)
    x1 = min(w, x1 + offset)
    y1 = min(h, y1 + offset)
    return np.asarray(image)[y0:y1, x0:x1]


def jitter_factors(batch: int, generator: torch.Generator,
                   brightness: float = 0.2, contrast: float = 0.2,
                   saturation: float = 0.2, device=None):
    """The color jitter's random factors, each (B, 1, 1, 1) float32, drawn
    uniformly in [1 - a, 1 + a) from `generator` (brightness, contrast,
    saturation)."""
    def draw(a):
        u = torch.rand((batch, 1, 1, 1), generator=generator,
                       device=device or generator.device)
        return 1.0 + (u * (2 * a) - a)

    return draw(brightness), draw(contrast), draw(saturation)


def apply_color_jitter(images: torch.Tensor, fb, fc, fs) -> torch.Tensor:
    """Brightness, contrast and saturation jitter with given factors
    (reference apply_jitter.py:27-73, torchvision ColorJitter's
    arithmetic). images (B, H, W, 3) 0-255 -> float32 clipped to
    [0, 255]."""
    x = images.float() * fb
    mean = x.mean(dim=(1, 2, 3), keepdim=True)
    x = (x - mean) * fc + mean
    gray = x.mean(dim=-1, keepdim=True)
    x = (x - gray) * fs + gray
    return x.clamp(0.0, 255.0)


def color_jitter(images: torch.Tensor, generator: torch.Generator,
                 brightness: float = 0.2, contrast: float = 0.2,
                 saturation: float = 0.2) -> torch.Tensor:
    """Batched jitter with factors drawn from `generator` (on the images'
    device): `jitter_factors` then `apply_color_jitter`."""
    factors = jitter_factors(images.shape[0], generator, brightness,
                             contrast, saturation, images.device)
    return apply_color_jitter(images, *factors)


def bgr_to_rgb(images: torch.Tensor) -> torch.Tensor:
    """Color-order correction (reference perform_color_correction.py)."""
    return images.flip(-1)


def mask_area_ok(mask, min_area: int = 20, max_area: int = 30000) -> bool:
    """Area gate used when packing the dataset (reference
    create_dataset.py:104-114 check_threshold)."""
    area = int(np.count_nonzero(np.asarray(mask)))
    return min_area < area < max_area


# Verb classes excluded from the affordance dataset (the reference's
# invalid_verb_classes list, data_setup/filter_dataset.py:58).
EXCLUDED_VERBS = frozenset(
    "eat look search feel transition wait smell finish unfreeze".split())


def narration_ok(narration: str, verb: Optional[str] = None) -> bool:
    if not narration or narration in ("null", "None"):
        return False
    v = (verb or narration.split()[0]).lower()
    return v not in EXCLUDED_VERBS
