"""The readers of the program's spans (`program_spans.py` and the four
metrics on it) on a hand-built stand-in for the traced window's trace,
with known intervals in nanoseconds."""

from types import SimpleNamespace

import pytest

from portbench import program_spans
from portbench.metrics import (collate_ms_per_req, launch_idle_ms_per_req,
                               post_ms_per_req, prefill_ms_per_req)

MS = 1_000_000


class FakeTrace:
    """`Trace`'s public attributes: spans (t0, t1, name, thread), the
    window, its busy intervals and each named range's kernel seconds."""

    def __init__(self, spans, busy, t0, t1, kernels=None):
        self.spans = [(a * MS, b * MS, n, 1) for a, b, n in spans]
        self._busy = [(a * MS, b * MS) for a, b in busy]
        self.t0, self.t1 = t0 * MS, t1 * MS
        self._kernels = kernels or {}

    def busy_intervals(self):
        return self._busy

    def span_kernels(self, name):
        return self._kernels.get(name, [])


def two_requests(**kw):
    """Two requests in a 0-200 ms window. Request 0: collate 0-30, the
    evaluate 30-80 (inputs 30-32, prompt 32-40, prefill 40-45, decode
    45-70, finish 70-80), fetch 80-85, post 85-95. Request 1 the same
    100 ms later. The card is busy 34-38, 42-84, 134-138 and 142-184, so
    idle 0-34, 38-42, 84-134, 138-142 and 184-200: the gap 84-134 runs
    through fetch, post, the harness's 95-100 and the next collate."""
    req = [(0, 30, "predictor.collate"), (30, 80, "predictor.evaluate"),
           (30, 32, "evaluate.inputs"), (32, 40, "evaluate.prompt"),
           (40, 45, "evaluate.prefill"), (45, 70, "evaluate.decode"),
           (70, 80, "evaluate.finish"), (80, 85, "predictor.fetch"),
           (85, 95, "predictor.post"), (0, 97, "request")]
    spans = [(a + k * 100, b + k * 100, n) for k in (0, 1) for a, b, n in req]
    spans.append((0, 200, "traced_window"))
    busy = [(34, 38), (42, 84), (134, 138), (142, 184)]
    return SimpleNamespace(
        trace=FakeTrace(spans, busy, 0, 200, **kw), traced={5, 6})


def test_idle_is_the_window_less_the_busy_union():
    tr = two_requests().trace
    assert program_spans.idle(tr) == [
        (0, 34 * MS), (38 * MS, 42 * MS), (84 * MS, 134 * MS),
        (138 * MS, 142 * MS), (184 * MS, 200 * MS)]


def test_host_time_of_collate_and_post():
    ctx = two_requests()
    assert collate_ms_per_req.read(ctx) == pytest.approx(30.0)
    assert post_ms_per_req.read(ctx) == pytest.approx(10.0)


def test_a_gap_across_post_and_the_next_collate_is_split():
    ctx = two_requests()
    gap = lambda names: program_spans.idle_ms_per_req(ctx, names)  # noqa: E731
    # Idle under post: 85-95 and 185-195, 10 ms each.
    assert gap(["predictor.post"]) == pytest.approx(10.0)
    # Under collate: 0-30 and 100-130 (the 84-134 gap's tail and the
    # 138-142 gap lie outside it), 30 ms each.
    assert gap(["predictor.collate"]) == pytest.approx(30.0)
    # Under fetch: 84-85 and 184-185.
    assert gap(["predictor.fetch"]) == pytest.approx(1.0)
    # Outside every program span: the harness's 95-100 and 195-200.
    covered = gap(["predictor.collate", "predictor.evaluate",
                   "predictor.fetch", "predictor.post"])
    total = sum(b - a for a, b in program_spans.idle(ctx.trace)) / MS / 2
    assert total - covered == pytest.approx(5.0)


def test_launch_idle_is_the_idle_under_the_eager_stages():
    # Idle 30-34 (inputs 30-32, prompt 32-34), 38-40 (prompt), 40-42
    # (prefill); finish 70-80 and decode are busy: 8 ms a request.
    assert launch_idle_ms_per_req.read(two_requests()) == pytest.approx(8.0)


def test_prefill_device_time_per_request():
    ctx = two_requests(kernels={"evaluate.prefill": [0.004, 0.006]})
    assert prefill_ms_per_req.read(ctx) == pytest.approx(5.0)


def test_no_program_span_reads_none():
    """A program that opens no span (or a run with no trace) gives no
    value, and no error."""
    tr = FakeTrace([(0, 97, "request"), (0, 200, "traced_window"),
                    (30, 80, "evaluate")], [(34, 84)], 0, 200)
    for ctx in (SimpleNamespace(trace=tr, traced={1}),
                SimpleNamespace(trace=None, traced=set())):
        for reader in (collate_ms_per_req, post_ms_per_req,
                       launch_idle_ms_per_req, prefill_ms_per_req):
            assert reader.read(ctx) is None


def test_spans_outside_the_window_are_not_read():
    ctx = two_requests()
    ctx.trace.spans.append((300 * MS, 340 * MS, "predictor.collate", 1))
    assert collate_ms_per_req.read(ctx) == pytest.approx(30.0)
