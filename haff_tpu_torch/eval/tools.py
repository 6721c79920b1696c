"""Qualitative output tools (port of haff_tpu/eval/tools.py
`overlay_results`; the benchmark-assembly tools are not ported yet)."""

from __future__ import annotations

from typing import Optional

import numpy as np


def overlay_results(image: np.ndarray, mask_left: Optional[np.ndarray],
                    mask_right: Optional[np.ndarray],
                    alpha: float = 0.5) -> np.ndarray:
    """Qualitative overlay: red = left hand, blue = right hand. RGB uint8
    in and out."""
    out = np.asarray(image, np.float32).copy()
    if mask_left is not None:
        m = np.asarray(mask_left, bool)
        out[m] = out[m] * (1 - alpha) + np.array([255.0, 0, 0]) * alpha
    if mask_right is not None:
        m = np.asarray(mask_right, bool)
        out[m] = out[m] * (1 - alpha) + np.array([0, 0, 255.0]) * alpha
    return out.astype(np.uint8)
