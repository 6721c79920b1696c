"""Loss stack (port of haff_tpu/model/losses.py; reference 2Haff/model/
LISA.py:16-59 dice / sigmoid-CE, 346-430 gating and normalisation).

Every loss takes an optional per-pixel validity mask, so padded-canvas
training matches the reference's original-resolution loss: padding
pixels are masked out of every mean and sum. All arithmetic in float32.

The JAX losses normalise over the global batch (GSPMD sums across the
batch shards). Here `total`, where given, completes a local denominator
to the global one (`core.mesh.batch_total` under a sharded batch), so a
rank's loss is its share of the global loss and the shares sum to it.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def dice_loss(inputs, targets, num_masks, valid: Optional[torch.Tensor] = None,
              scale: float = 1000.0, eps: float = 1e-6):
    """inputs/targets (N, H, W) logits / binary: sigmoid, /scale,
    1 - (2 inter + eps) / (sum + eps), summed over masks / (num_masks +
    1e-8)."""
    probs = torch.sigmoid(inputs.float())
    t = targets.float()
    if valid is not None:
        probs = probs * valid
        t = t * valid
    probs = probs.reshape(probs.shape[0], -1)
    t = t.reshape(t.shape[0], -1)
    numerator = 2.0 * torch.sum(probs / scale * t, dim=-1)
    denominator = (torch.sum(probs / scale, dim=-1)
                   + torch.sum(t / scale, dim=-1))
    loss = 1.0 - (numerator + eps) / (denominator + eps)
    return torch.sum(loss) / (num_masks + 1e-8)


def sigmoid_ce_loss(inputs, targets, num_masks,
                    valid: Optional[torch.Tensor] = None):
    """Per-pixel BCE with logits, per-mask mean over valid pixels, summed
    over masks / (num_masks + 1e-8)."""
    x = inputs.float()
    t = targets.float()
    per_pixel = x.clamp(min=0) - x * t + torch.log1p(torch.exp(-x.abs()))
    n = x.shape[0]
    if valid is not None:
        v = valid.float()
        per_mask = ((per_pixel * v).reshape(n, -1).sum(-1)
                    / v.reshape(n, -1).sum(-1).clamp(min=1.0))
    else:
        per_mask = per_pixel.reshape(n, -1).mean(-1)
    return torch.sum(per_mask) / (num_masks + 1e-8)


def _identity(x):
    return x


def language_model_loss(logits, labels, ignore_index: int = -100,
                        total=_identity):
    """Shifted next-token CE, mean over the non-ignored targets (reference
    llava_llama.py:103-118): sum(nll) / sum(valid), the count completed
    by `total`."""
    shift_logits = logits[:, :-1, :].float()
    shift_labels = labels[:, 1:].long()
    valid = shift_labels != ignore_index
    safe = torch.where(valid, shift_labels, torch.zeros_like(shift_labels))
    logp = F.log_softmax(shift_logits, dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    return nll.sum() / total(valid.sum()).clamp(min=1)


def taxonomy_ce_loss(pred_taxonomy_probs, gt_taxonomy, sample_weight=None,
                     logit_ce: bool = False, total=_identity):
    """Soft-target CE on the taxonomy head's probabilities. Default: the
    reference's double softmax (log_softmax over probabilities,
    LISA.py taxonomy_ce_loss). logit_ce: -sum(t * log(probs)), the CE on
    the head's pre-softmax logits. `sample_weight` averages over real rows
    only."""
    p = pred_taxonomy_probs.float()
    if logit_ce:
        logp = torch.log(p.clamp(min=1e-30))
    else:
        logp = F.log_softmax(p, dim=-1)
    per_sample = -torch.sum(gt_taxonomy.float() * logp, dim=-1)
    if sample_weight is None:
        return per_sample.mean()
    w = sample_weight.float()
    return torch.sum(per_sample * w) / total(w.sum()).clamp(min=1.0)


def bimanual_mask_losses(pred_left, pred_right, gt_left, gt_right,
                         gt_taxonomy, valid=None, sample_weight=None,
                         bce_weight: float = 2.0, dice_weight: float = 0.5,
                         total=_identity):
    """Taxonomy-gated mask losses (reference LISA.py:359-422): the left
    prediction is scaled by tax[0] + tax[2] + tax[3], the right by
    tax[1] + tax[2] + tax[3]. pred_* (B, H, W) logits; gt_* (B, H, W);
    gt_taxonomy (B, 4); valid (B, H, W); sample_weight (B,) 0/1.
    Returns (bce, dice)."""
    w_left = gt_taxonomy[:, 0] + gt_taxonomy[:, 2] + gt_taxonomy[:, 3]
    w_right = gt_taxonomy[:, 1] + gt_taxonomy[:, 2] + gt_taxonomy[:, 3]
    pl = pred_left * w_left[:, None, None]
    pr = pred_right * w_right[:, None, None]
    if sample_weight is None:
        sample_weight = torch.ones(pred_left.shape[0], dtype=torch.float32,
                                   device=pred_left.device)
    num_masks = total(sample_weight.sum())
    if valid is not None:
        valid = valid * sample_weight[:, None, None]
    else:
        valid = sample_weight[:, None, None].expand(pred_left.shape).float()
    bce = (sigmoid_ce_loss(pl, gt_left, num_masks, valid)
           + sigmoid_ce_loss(pr, gt_right, num_masks, valid)) * bce_weight
    dice = (dice_loss(pl, gt_left, num_masks, valid)
            + dice_loss(pr, gt_right, num_masks, valid)) * dice_weight
    return bce, dice
