"""A run whose timed path is broken underneath comes out not correct.
Each test skips the look for a card and drives the rest of a run on the
CPU at the tiny widths, with the cell's own limits, and breaks the
program where it produces its answer: a mask, the taxonomy, a layer of
the prefill or of the decode left out, the decode's keys and values
written one cache slot early, a decoded token altered before it is fed
back. (The cells run one request at a time on one card: no batch to
halve, no exchange between cards, no training state.)"""

import pytest
import torch

from portbench import harness
from portbench.tests import tiny
from portbench.tests.test_portbench_reference import CELLS


def run_broken(cell, break_it):
    res = harness.run(
        ["--workload", cell, "--seed", str(2 ** 31 + 101), "--seconds", "1.5",
         "--trace", "0"], device="cpu", cell=tiny.cell(cell),
        cfg=CELLS[cell](), after_setup=break_it)
    return res


def _alter_evaluate(drv, alter):
    inner = drv.evaluate

    def broken(*args):
        return alter(inner(*args))

    drv.evaluate = broken


def negate_left_mask(drv):
    _alter_evaluate(drv, lambda r: r._replace(
        pred_masks_left=-r.pred_masks_left))


def swap_taxonomy(drv):
    _alter_evaluate(drv, lambda r: r._replace(
        taxonomies=torch.flip(r.taxonomies, dims=[-1])))


def _llm_calls(drv, prefill):
    """(flag, restore): the flag is set while the LLM runs the prefill
    (`prefill`) or a decode step (not `prefill`)."""
    inner = drv.model.llm_forward
    on = [False]

    def llm_forward(embeds, *args, **kwargs):
        on[0] = (embeds.shape[1] > 1) == prefill
        try:
            return inner(embeds, *args, **kwargs)
        finally:
            on[0] = False

    drv.model.llm_forward = llm_forward
    return on


def _skip_block(drv, k, prefill):
    on = _llm_calls(drv, prefill)
    block = drv.model.llm.blocks[k]
    inner = block.forward

    def forward(x, slopes, segment_ids=None, kv_cache=None, *args, **kw):
        if on[0]:
            return x, kv_cache
        return inner(x, slopes, segment_ids, kv_cache, *args, **kw)

    block.forward = forward


def skip_prefill_layer(drv):
    _skip_block(drv, 0, prefill=True)


def skip_decode_layer(drv):
    _skip_block(drv, 1, prefill=False)


def stale_kv_slot(drv):
    inner = drv.model.llm_forward

    def llm_forward(embeds, positions, segment_ids=None, kv_caches=None,
                    cache_index=None, kv_segment_ids=None):
        if embeds.shape[1] == 1:
            cache_index = cache_index - 1
        return inner(embeds, positions, segment_ids, kv_caches, cache_index,
                     kv_segment_ids)

    drv.model.llm_forward = llm_forward


def alter_fed_back_token(drv):
    inner = drv.model.embed_tokens
    vocab = drv.model.llm.cfg.vocab_size

    def embed_tokens(ids):
        return inner((ids + 1) % vocab if ids.shape[-1] == 1 else ids)

    drv.model.embed_tokens = embed_tokens


@pytest.mark.parametrize("fault,number", [
    (negate_left_mask, "mask_rel_err"),
    (swap_taxonomy, "taxonomy_err"),
    (skip_prefill_layer, "llm_hidden_rel_err"),
    (skip_decode_layer, "llm_hidden_rel_err"),
    (stale_kv_slot, "llm_hidden_rel_err"),
    (alter_fed_back_token, "llm_hidden_rel_err")])
def test_lisa_fault_fails(fault, number):
    res = run_broken("lisa_mpt7b.robot_b1", fault)
    c = res["checks"][number]
    assert res["correct"] is False
    assert c["value"] > c["limit"], c
