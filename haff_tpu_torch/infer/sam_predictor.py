"""SamPredictor: the set_image / predict API over the dual-decoder SAM
(port of haff_tpu/infer/sam_predictor.py).

Point, box and mask prompts against one cached image embedding;
`predict` takes `hand` ("left" / "right"), and the left decoder also
returns the taxonomy. The embedding is computed once per `set_image` and
stays on the model's device between calls; nothing here keeps an autograd
graph. Masks come back on the host at the frame's original resolution."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..data.transforms import sam_preprocess
from ..nn.sam import Sam, postprocess_masks_padded


class SamPredictor:
    def __init__(self, sam: Sam, image_size: int = 1024, device="cuda"):
        """`sam` is moved to `device` (the card unless the caller asks for
        the CPU) and put in eval mode."""
        self.model = sam.to(device).eval()
        self.device = torch.device(device)
        self.image_size = image_size
        self._embedding = None
        self._input_hw = None
        self._orig_hw = None

    @torch.no_grad()
    def set_image(self, image: np.ndarray) -> None:
        """image: (H, W, 3) uint8 RGB."""
        canvas, resize_hw = sam_preprocess(image, self.image_size)
        self._input_hw = resize_hw
        self._orig_hw = image.shape[:2]
        self._embedding = self.model.encode_image(
            torch.as_tensor(canvas, device=self.device)[None])

    def _require_image(self):
        if self._embedding is None:
            raise RuntimeError("SamPredictor: call set_image first")

    def _transform_coords(self, coords: np.ndarray) -> np.ndarray:
        """Original-pixel coords -> resized-canvas coords (reference
        transforms.py apply_coords)."""
        oh, ow = self._orig_hw
        rh, rw = self._input_hw
        out = np.asarray(coords, np.float32).copy()
        out[..., 0] *= rw / ow
        out[..., 1] *= rh / oh
        return out

    @torch.no_grad()
    def _decode(self, points, labels, boxes, multimask: bool):
        """One prompted dual decode; the cached embedding is broadcast to
        the prompt batch. Returns ((masks, iou, taxonomy), (masks, iou))."""
        m = self.model
        dev = self.device
        as_t = lambda x: None if x is None else torch.as_tensor(x, device=dev)  # noqa: E731
        points, labels, boxes = as_t(points), as_t(labels), as_t(boxes)
        sparse, dense = m.prompt_encoder(
            points=None if points is None else (points, labels), boxes=boxes)
        emb = self._embedding.expand(sparse.shape[0], -1, -1, -1)
        image_pe = m.prompt_encoder.get_dense_pe()[None]
        out_l = m.mask_decoder_left(emb, image_pe, sparse, dense,
                                    multimask_output=multimask)
        out_r = m.mask_decoder_right(emb, image_pe, sparse, dense,
                                     multimask_output=multimask)
        return out_l, out_r

    def predict(self, point_coords: Optional[np.ndarray] = None,
                point_labels: Optional[np.ndarray] = None,
                box: Optional[np.ndarray] = None,
                multimask_output: bool = True,
                return_logits: bool = False,
                hand: str = "left"
                ) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
        """Returns (masks (n, H, W) at the original resolution, binary or,
        with `return_logits`, raw logits; iou_predictions (n,);
        taxonomy (4,) or None for the right hand)."""
        self._require_image()
        points = labels = boxes = None
        if point_coords is not None:
            points = self._transform_coords(point_coords)[None]  # (1, N, 2)
            labels = np.asarray(point_labels, np.int64)[None]
        if box is not None:
            boxes = self._transform_coords(
                np.asarray(box).reshape(2, 2)).reshape(1, 4)
        out_l, out_r = self._decode(points, labels, boxes,
                                    bool(multimask_output))
        masks, iou, tax = self._finish(out_l, out_r, hand, return_logits)
        return masks[0], iou[0], None if tax is None else tax[0]

    def _finish(self, out_l, out_r, hand: str, return_logits: bool):
        """Shared decode tail: hand select, canvas upsample, crop and
        resize to the original frame (on the model's device), optional
        binarize, copy to the host. Returns (masks (N, n_out, H, W),
        iou (N, n_out), taxonomy (N, 4) or None) as numpy."""
        if hand == "left":
            masks, iou, taxonomy = out_l
        else:
            (masks, iou), taxonomy = out_r, None
        ih, iw = self._input_hw
        canvas = postprocess_masks_padded(masks.float(), self.image_size)
        orig = F.interpolate(canvas[:, :, :ih, :iw], size=tuple(self._orig_hw),
                             mode="bilinear", align_corners=False)
        out_masks = orig if return_logits else orig > 0
        return (out_masks.cpu().numpy(), iou.float().cpu().numpy(),
                None if taxonomy is None else taxonomy.float().cpu().numpy())

    def predict_batch(self, point_coords: np.ndarray,
                      point_labels: Optional[np.ndarray] = None,
                      multimask_output: bool = True,
                      return_logits: bool = False,
                      hand: str = "left"
                      ) -> Tuple[np.ndarray, np.ndarray,
                                 Optional[np.ndarray]]:
        """N point prompts in one decode against the cached embedding
        (the reference mask generator's points_per_batch batching).

        point_coords: (N, P, 2) original-pixel coords (or (N, 2));
        point_labels (N, P) int, default all foreground. Returns (masks
        (N, n_out, H, W), iou (N, n_out), taxonomy (N, 4) or None)."""
        self._require_image()
        pts = np.asarray(point_coords, np.float32)
        if pts.ndim == 2:
            pts = pts[:, None, :]
        n, p, _ = pts.shape
        if point_labels is None:
            point_labels = np.ones((n, p), np.int64)
        out_l, out_r = self._decode(
            self._transform_coords(pts), np.asarray(point_labels, np.int64),
            None, bool(multimask_output))
        return self._finish(out_l, out_r, hand, return_logits)
