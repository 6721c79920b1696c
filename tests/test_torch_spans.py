"""The port's spans (haff_tpu_torch/utils/profiling.py `span`) on the
CPU: a no-op unless a profiler collects, a `record_function` range on the
trace's clock when one does, and the stage names that evaluate_fn's
greedy and speculative paths open. The graphed path's names are checked
on the card (test_torch_kernels_cuda.py), Predictor.predict_batch's in
test_torch_predictor.py."""

import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from haff_tpu_torch.utils import profiling

EVALUATE_SPANS = ("evaluate.inputs", "evaluate.prompt", "evaluate.prefill",
                  "evaluate.decode", "evaluate.finish")
PREDICTOR_SPANS = ("predictor.collate", "predictor.evaluate",
                   "predictor.fetch", "predictor.post")


def ranges(prof):
    """(name, start ns, end ns) of the trace's host ranges named
    `evaluate.*` or `predictor.*`, in start order."""
    out = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events()
           if e.is_user_annotation()
           and e.name().startswith(("evaluate.", "predictor."))
           and not str(e.device_type()).endswith("CUDA")]
    return sorted(out, key=lambda r: r[1])


def test_span_without_a_profiler_opens_no_range(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    first = profiling.span("predictor.collate")
    assert profiling.span("evaluate.decode") is first
    with first:
        with profiling.span("evaluate.prefill"):
            pass


def test_span_under_a_profiler_is_a_nested_range_on_the_epoch_clock():
    t_before = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("predictor.evaluate"):
            with profiling.span("evaluate.prefill"):
                torch.randn(32, 32) @ torch.randn(32, 32)
    t_after = time.time_ns()
    (outer, o0, o1), (inner, i0, i1) = ranges(prof)
    assert (outer, inner) == ("predictor.evaluate", "evaluate.prefill")
    assert o0 <= i0 < i1 <= o1
    # Kineto stamps ranges in Unix-epoch nanoseconds, the card's activity
    # on the same clock.
    assert t_before <= o0 and o1 <= t_after
    assert profiling.span("x") is profiling.span("y")  # off again


@pytest.fixture(scope="module")
def tiny_model():
    from haff_tpu_torch.core.config import ModelConfig
    from haff_tpu_torch.model.lisa import LisaModel

    torch.manual_seed(0)
    return LisaModel(ModelConfig.preset("tiny"), torch.float32, device="cpu")


def _request(cfg, seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(5, 400, (1, 12))
    ids[:, 2] = -200
    S, C = cfg.sam_encoder.image_size, cfg.clip.image_size
    return (rng.randn(1, S, S, 3).astype(np.float32),
            rng.randn(1, C, C, 3).astype(np.float32), ids,
            np.ones((1, 12), np.int64))


@pytest.mark.parametrize("speculative", [False, True])
def test_evaluate_fn_opens_each_stage_once(tiny_model, speculative):
    """Greedy and speculative evaluate_fn name the same five stages, once
    each, one after the other, and profiling changes no output."""
    from haff_tpu_torch.infer.evaluate import evaluate_fn

    kw = {}
    if speculative:
        kw = dict(draft_corpus=np.arange(5, 40)[None], draft_len=4)
    req = _request(tiny_model.cfg)
    plain = evaluate_fn(tiny_model, *req, 5, 2, **kw)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = evaluate_fn(tiny_model, *req, 5, 2, **kw)
    got = ranges(prof)
    assert [r[0] for r in got] == list(EVALUATE_SPANS)
    assert all(a[2] <= b[1] for a, b in zip(got, got[1:]))
    for a, b in zip(plain, traced):
        assert (a is None and b is None) or torch.equal(a, b)
