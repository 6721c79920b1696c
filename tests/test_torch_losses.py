"""The port's loss stack (haff_tpu_torch/model/losses.py) against
haff_tpu/model/losses.py on the same seeded numpy inputs: dice and
sigmoid-CE with and without a validity mask, the shifted LM CE with
ignored targets, the taxonomy CE both ways (double softmax and logit_ce)
with and without sample weights, and the taxonomy-gated bimanual losses.

float32 on both sides; tolerance 1e-5 abs + rel (reductions of at most a
few thousand terms).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from haff_tpu.model import losses as JL
from haff_tpu_torch.model import losses as TL

TOL = dict(rtol=1e-5, atol=1e-5)
RNG = np.random.default_rng(0)
B, H, W = 3, 16, 12
LOGITS = (2.0 * RNG.standard_normal((B, H, W))).astype(np.float32)
LOGITS_R = (2.0 * RNG.standard_normal((B, H, W))).astype(np.float32)
TARGETS = (RNG.random((B, H, W)) > 0.7).astype(np.float32)
TARGETS_R = (RNG.random((B, H, W)) > 0.6).astype(np.float32)
VALID = np.ones((B, H, W), np.float32)
VALID[:, 11:, :] = 0.0
VALID[2, :, 7:] = 0.0
TAX = np.array([[1, 0, 0, 0], [0, 0, 1, 0], [0, 0.5, 0, 0.5]], np.float32)
PROBS = np.asarray(torch.softmax(torch.from_numpy(
    3.0 * RNG.standard_normal((B, 4)).astype(np.float32)), -1))
WEIGHT = np.array([1.0, 0.0, 1.0], np.float32)


def _close(got, ref):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(ref),
                               **TOL)


@pytest.mark.parametrize("loss", ["dice_loss", "sigmoid_ce_loss"])
@pytest.mark.parametrize("valid", [False, True])
def test_mask_losses(loss, valid):
    v = VALID if valid else None
    ref = getattr(JL, loss)(jnp.asarray(LOGITS), jnp.asarray(TARGETS), 2.0,
                            None if v is None else jnp.asarray(v))
    got = getattr(TL, loss)(torch.from_numpy(LOGITS),
                            torch.from_numpy(TARGETS), torch.tensor(2.0),
                            None if v is None else torch.from_numpy(v))
    _close(got, ref)


def test_language_model_loss_ignores_targets():
    vocab, L = 11, 9
    logits = RNG.standard_normal((B, L, vocab)).astype(np.float32)
    labels = RNG.integers(0, vocab, (B, L)).astype(np.int32)
    labels[:, :3] = -100
    labels[1, 6:] = -100
    ref = JL.language_model_loss(jnp.asarray(logits), jnp.asarray(labels))
    got = TL.language_model_loss(torch.from_numpy(logits),
                                 torch.from_numpy(labels))
    _close(got, ref)
    all_ignored = np.full_like(labels, -100)
    _close(TL.language_model_loss(torch.from_numpy(logits),
                                  torch.from_numpy(all_ignored)),
           JL.language_model_loss(jnp.asarray(logits),
                                  jnp.asarray(all_ignored)))


@pytest.mark.parametrize("logit_ce", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
def test_taxonomy_ce(logit_ce, weighted):
    w = WEIGHT if weighted else None
    ref = JL.taxonomy_ce_loss(jnp.asarray(PROBS), jnp.asarray(TAX),
                              None if w is None else jnp.asarray(w),
                              logit_ce=logit_ce)
    got = TL.taxonomy_ce_loss(torch.from_numpy(PROBS), torch.from_numpy(TAX),
                              None if w is None else torch.from_numpy(w),
                              logit_ce=logit_ce)
    _close(got, ref)


@pytest.mark.parametrize("valid,weighted", [(False, False), (True, False),
                                            (True, True), (False, True)])
def test_bimanual_mask_losses_gated(valid, weighted):
    args = (LOGITS, LOGITS_R, TARGETS, TARGETS_R, TAX)
    v = VALID if valid else None
    w = WEIGHT if weighted else None
    ref = JL.bimanual_mask_losses(
        *map(jnp.asarray, args), valid=None if v is None else jnp.asarray(v),
        sample_weight=None if w is None else jnp.asarray(w))
    got = TL.bimanual_mask_losses(
        *map(torch.from_numpy, args),
        valid=None if v is None else torch.from_numpy(v),
        sample_weight=None if w is None else torch.from_numpy(w))
    for g, r in zip(got, ref):
        _close(g, r)


def test_loss_gradients_match():
    """d(bce + dice)/d(pred) through the gates, against jax.grad."""
    import jax

    def jloss(pl, pr):
        bce, dice = JL.bimanual_mask_losses(
            pl, pr, jnp.asarray(TARGETS), jnp.asarray(TARGETS_R),
            jnp.asarray(TAX), valid=jnp.asarray(VALID),
            sample_weight=jnp.asarray(WEIGHT))
        return bce + dice

    ref = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(LOGITS),
                                           jnp.asarray(LOGITS_R))
    pl, pr = (torch.from_numpy(x).requires_grad_() for x in (LOGITS, LOGITS_R))
    bce, dice = TL.bimanual_mask_losses(
        pl, pr, torch.from_numpy(TARGETS), torch.from_numpy(TARGETS_R),
        torch.from_numpy(TAX), valid=torch.from_numpy(VALID),
        sample_weight=torch.from_numpy(WEIGHT))
    got = torch.autograd.grad(bce + dice, (pl, pr))
    for g, r in zip(got, ref):
        _close(g, r)
