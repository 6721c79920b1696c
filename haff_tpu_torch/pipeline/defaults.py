"""Default in-repo implementations of the 2HANDS pipeline's external
stages 2 and 4 (port of haff_tpu/pipeline/defaults.py).

The reference keeps these as git submodules (reference
2HANDS/.gitmodules:1-12, pipeline.bash:22-37):

  stage 2  hand/object mask propagation (XMem_Batch)
  stage 4  hand inpainting              (agent_inpainting)

These defaults keep `pipeline/orchestrate.py` runnable end to end from raw
frames; `PipelineStages` keeps both stages pluggable. In JAX they are XLA
programs; here they are plain torch on the tensors' device (the card in
the pipeline):

* `propagate_masks`: per frame step, each pixel of frame t+1 searches a
  (2 * radius + 1)^2 neighbourhood of frame t for its best match under a
  window-summed squared feature distance; the mask follows the winning
  per-pixel shift, and a color gate zeroes pixels whose best match is
  still dissimilar. The shifts are scored a row of them at a time (a
  (2 * radius + 1, H, W) cost slab), not one by one as JAX's fori_loop
  does; the first shift of the lowest cost wins, as JAX's strict `<`
  keeps it.
* `temporal_inpaint`: a forward and backward "last visible value" pass
  over time, then a masked 3 x 3 diffusion for pixels masked in every
  frame.

Float sums in another order than XLA's can flip a shift whose cost ties
another's to rounding, and a gate test that sits on its threshold.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


def _pixel_features(frames: torch.Tensor) -> torch.Tensor:
    """(N, H, W, 3) uint8/float -> (N, H, W, 5) per-pixel features: RGB
    and the |dy|, |dx| gradient magnitudes."""
    x = frames.float() / 255.0
    gy = torch.diff(x, dim=1, append=x[:, -1:]).abs().mean(-1, keepdim=True)
    gx = torch.diff(x, dim=2, append=x[:, :, -1:]).abs().mean(-1, keepdim=True)
    return torch.cat([x, gy, gx], dim=-1)


def _box_sum(x: torch.Tensor, window: int) -> torch.Tensor:
    """Window sum over the last two axes with SAME zero padding (odd
    window): (..., H, W) -> (..., H, W); a column sum, then a row sum."""
    lead = x.shape[:-2]
    y = x.reshape((-1, 1) + x.shape[-2:])
    for k in ((window, 1), (1, window)):
        y = F.avg_pool2d(y, k, stride=1, padding=(k[0] // 2, k[1] // 2),
                         count_include_pad=True, divisor_override=1)
    return y.reshape(lead + y.shape[-2:])


@torch.no_grad()
def propagate_masks(frames: torch.Tensor, seed_masks: torch.Tensor,
                    radius: int = 6, window: int = 9,
                    color_gate: float = 0.25) -> torch.Tensor:
    """Propagate seed masks from frame 0 through a clip.

    frames (N, H, W, 3) uint8; seed_masks (M, H, W) masks on frame 0 (on
    the frames' device). Returns (N, M, H, W) float32 {0, 1}."""
    n, H, W, _ = frames.shape
    m = seed_masks.shape[0]
    dev = frames.device
    feats = _pixel_features(frames).permute(0, 3, 1, 2)    # (N, 5, H, W)
    masks = seed_masks.float()
    side = 2 * radius + 1
    # Per-pixel tap count of the SAME-padded window (25 / 81 at a 9 x 9
    # corner): the gate divides by it.
    box_count = _box_sum(torch.ones((H, W), device=dev), window)
    Wp = W + 2 * radius
    base = (torch.arange(H, device=dev)[:, None] * Wp
            + torch.arange(W, device=dev)[None, :]).reshape(-1)
    out = [masks]
    for t in range(n - 1):
        # 'edge' padding, as jnp.pad(mode="edge").
        fp_pad = F.pad(feats[t:t + 1], (radius,) * 4, mode="replicate")[0]
        mp_pad = F.pad(masks[None], (radius,) * 4, mode="replicate")[0]
        f_next = feats[t + 1]
        best_cost = torch.full((H, W), float("inf"), device=dev)
        best_shift = torch.zeros((H, W), dtype=torch.long, device=dev)
        for dy in range(side):
            # The row of shifts dy as a view (5, H, side, W) of the padded
            # features: candidate dx reads columns dx .. dx + W.
            cand = fp_pad[:, dy:dy + H].unfold(2, W, 1)
            cost = _box_sum(((cand - f_next[:, :, None]) ** 2).sum(0)
                            .transpose(0, 1), window)       # (side, H, W)
            c_min, c_arg = cost.min(0)   # first minimum on a tie
            take = c_min < best_cost
            best_cost = torch.where(take, c_min, best_cost)
            best_shift = torch.where(take, dy * Wp + c_arg, best_shift)
        idx = (base + best_shift.reshape(-1))[None].expand(m, -1)
        nxt = torch.gather(mp_pad.reshape(m, -1), 1, idx).reshape(m, H, W)
        gate = (best_cost / box_count < color_gate).float()
        masks = nxt * gate[None]
        out.append(masks)
    return (torch.stack(out) > 0.5).float()


@torch.no_grad()
def temporal_inpaint(frames: torch.Tensor, masks: torch.Tensor,
                     diffusion_iters: int = 16) -> torch.Tensor:
    """Remove masked (hand) regions from a clip.

    frames (N, H, W, 3) uint8; masks (N, H, W) binary hand masks. Returns
    (N, H, W, 3) uint8 with the masked region filled from the nearest
    frame in time where the pixel is visible (forward first, then
    backward); pixels masked in EVERY frame take iterated neighbourhood
    diffusion."""
    x = frames.float()
    visible = (masks == 0).float()[..., None]               # (N, H, W, 1)

    def fill(order):
        last_val = torch.zeros_like(x[0])
        last_vis = torch.zeros_like(visible[0])
        vals, viss = [None] * len(order), [None] * len(order)
        for i in order:
            last_val = torch.where(visible[i] > 0, x[i], last_val)
            last_vis = torch.maximum(visible[i], last_vis)
            vals[i], viss[i] = last_val, last_vis
        return torch.stack(vals), torch.stack(viss)

    n = x.shape[0]
    fwd_val, fwd_vis = fill(range(n))
    bwd_val, bwd_vis = fill(range(n - 1, -1, -1))
    filled = torch.where(visible > 0, x,
                         torch.where(fwd_vis > 0, fwd_val, bwd_val))
    ever = torch.maximum(fwd_vis, bwd_vis) > 0               # (N, H, W, 1)
    for _ in range(diffusion_iters):
        blur = _box_sum(filled.permute(0, 3, 1, 2), 3).permute(0, 2, 3, 1) / 9.0
        filled = torch.where(ever, filled, blur)
    return filled.clamp(0, 255).to(torch.uint8)


def default_propagate(frames: np.ndarray, seed_left: np.ndarray,
                      seed_right: np.ndarray, seed_obj: np.ndarray,
                      device="cuda"
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host wrapper matching PipelineStages.propagate_masks: seeds on
    frame 0 -> per-frame (left, right, object) masks (N, H, W), computed
    on `device`."""
    seeds = torch.as_tensor(np.stack([
        np.asarray(s, np.float32) for s in (seed_left, seed_right, seed_obj)]),
        device=device)
    out = propagate_masks(torch.as_tensor(np.asarray(frames), device=device),
                          seeds).cpu().numpy()
    return out[:, 0], out[:, 1], out[:, 2]


def default_inpaint(frames: np.ndarray, hand_masks: np.ndarray,
                    device="cuda") -> np.ndarray:
    """Host wrapper matching PipelineStages.inpaint_hands, on `device`."""
    return temporal_inpaint(
        torch.as_tensor(np.asarray(frames), device=device),
        torch.as_tensor(np.asarray(hand_masks), device=device)).cpu().numpy()
