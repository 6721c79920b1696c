"""The port's multimodal splice and [SEG] gather
(haff_tpu_torch/model/multimodal.py) against haff_tpu/model/multimodal.py
on the same seeded inputs: image position per row (and a row without an
image token), right padding, labels, RoPE positions, the [SEG] mask, and
gathering up to two [SEG] hidden states per row. All integer outputs must
be identical; the float outputs are copies of the inputs, so exact too."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from haff_tpu.model import multimodal as jmm
from haff_tpu_torch.core.config import IGNORE_INDEX, IMAGE_TOKEN_INDEX
from haff_tpu_torch.model import multimodal as tmm

B, L, P, E, SEG = 4, 9, 5, 6, 150  # ids below are < 100


def _inputs():
    rng = np.random.default_rng(0)
    ids = rng.integers(5, 100, (B, L)).astype(np.int32)
    ids[0, 2] = ids[1, 0] = ids[2, 6] = IMAGE_TOKEN_INDEX   # row 3: no image
    ids[0, 5] = ids[0, 7] = ids[1, 4] = ids[3, 3] = SEG
    att = np.ones((B, L), np.int32)
    att[1, 6:] = 0
    att[3, 4:] = 0     # row 3's [SEG] at 3 is real, the tail is padding
    labels = np.where(rng.random((B, L)) < 0.3, IGNORE_INDEX, ids).astype(
        np.int32)
    tok = rng.standard_normal((B, L, E)).astype(np.float32)
    img = rng.standard_normal((B, P, E)).astype(np.float32)
    return ids, att, labels, tok, img


@pytest.mark.parametrize("with_optional", [True, False])
def test_splice_matches_jax(with_optional):
    ids, att, labels, tok, img = _inputs()
    if not with_optional:
        labels = att = None
    seg = SEG if with_optional else None
    jpos = jmm.find_image_position(jnp.asarray(ids))
    tpos = tmm.find_image_position(torch.from_numpy(ids))
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    assert tpos.tolist() == [2, 0, 6, L]
    ref = jmm.splice_image_embeddings(
        jnp.asarray(tok), jnp.asarray(img), jpos, jnp.asarray(ids),
        None if labels is None else jnp.asarray(labels),
        None if att is None else jnp.asarray(att), seg_token_idx=seg)
    got = tmm.splice_image_embeddings(
        torch.from_numpy(tok), torch.from_numpy(img), tpos,
        torch.from_numpy(ids),
        None if labels is None else torch.from_numpy(labels),
        None if att is None else torch.from_numpy(att), seg_token_idx=seg)
    for key in ref._fields:
        np.testing.assert_array_equal(getattr(got, key).numpy(),
                                      np.asarray(getattr(ref, key)),
                                      err_msg=key)


@pytest.mark.parametrize("max_segs", [1, 2])
def test_gather_seg_embeddings_matches_jax(max_segs):
    ids, att, labels, tok, img = _inputs()
    pos = tmm.find_image_position(torch.from_numpy(ids))
    sp = tmm.splice_image_embeddings(
        torch.from_numpy(tok), torch.from_numpy(img), pos,
        torch.from_numpy(ids), None, torch.from_numpy(att), SEG)
    hidden = np.random.default_rng(1).standard_normal(
        (B, L + P - 1, E)).astype(np.float32)
    mask = sp.seg_token_mask.numpy()
    assert mask.sum(1).tolist() == [2, 1, 0, 1]
    ref_emb, ref_valid = jmm.gather_seg_embeddings(
        jnp.asarray(hidden), jnp.asarray(mask), max_segs)
    emb, valid = tmm.gather_seg_embeddings(torch.from_numpy(hidden),
                                           torch.from_numpy(mask), max_segs)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(ref_valid))
    np.testing.assert_array_equal(emb.numpy(), np.asarray(ref_emb))


@pytest.mark.parametrize("max_segs", [1, 2])
def test_gradients_through_splice_and_gather_match_jax(max_segs):
    """The train forward's path from the token embeddings and the image
    features through the splice and the [SEG] gather: gradients of a fixed
    projection of (spliced embeddings, gathered [SEG] states) against
    jax.grad. Every element is one copied input times a weight, so the
    gradients are exact sums of the weights (float32, 1e-6)."""
    import jax

    ids, att, labels, tok, img = _inputs()
    rng = np.random.default_rng(2)
    w_emb = rng.standard_normal((B, L + P - 1, E)).astype(np.float32)
    w_seg = rng.standard_normal((B, max_segs, E)).astype(np.float32)
    jpos = jmm.find_image_position(jnp.asarray(ids))

    def jloss(tok, img):
        sp = jmm.splice_image_embeddings(tok, img, jpos, jnp.asarray(ids),
                                         jnp.asarray(labels), jnp.asarray(att),
                                         seg_token_idx=SEG)
        seg, _ = jmm.gather_seg_embeddings(sp.embeds, sp.seg_token_mask,
                                           max_segs)
        return jnp.sum(sp.embeds * w_emb) + jnp.sum(seg * w_seg)

    ref = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(tok), jnp.asarray(img))
    t_tok, t_img = (torch.from_numpy(x).requires_grad_() for x in (tok, img))
    sp = tmm.splice_image_embeddings(
        t_tok, t_img, tmm.find_image_position(torch.from_numpy(ids)),
        torch.from_numpy(ids), torch.from_numpy(labels),
        torch.from_numpy(att), seg_token_idx=SEG)
    seg, _ = tmm.gather_seg_embeddings(sp.embeds, sp.seg_token_mask, max_segs)
    loss = (sp.embeds * torch.from_numpy(w_emb)).sum() + (
        seg * torch.from_numpy(w_seg)).sum()
    got = torch.autograd.grad(loss, (t_tok, t_img))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6,
                                   atol=1e-6)
    assert got[0].abs().sum() > 0 and got[1].abs().sum() > 0
