"""One run of one cell: set-up, the measured window, the traced
sub-window, the check against the plain reference, the result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up runs from the process's start to the window's: imports, the
kernels' build (reused from build/ after a checkout's first run), the
seeded weights on the card, and the driver's warm-up of the cell's own
shapes. The window is a closed loop: the next request goes out when the
previous one's answer is back, until `--seconds` have passed; the window
ends with the last answer. With `--trace 1` the benchmark's spans are on
and the profiler traces `trace_requests` requests inside the window.
After the window the peak memory is read, the program's state freed, and
a seeded sample of the answered requests is compared with the plain
float32 reference. The last line of standard output is one JSON object;
the numbers compared, each with its limit, are the last lines of
standard error and the line's last key.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import subprocess
import sys
import time
import traceback
from types import SimpleNamespace

import numpy as np

from . import registry, traffic
from .spans import Spans

FORBIDDEN = ("jax", "jaxlib", "flax", "haff_tpu")
H100_BF16_FLOPS = 989e12    # dense bf16 tensor-core peak, H100 SXM data sheet
H100_BYTES_PER_S = 3.35e12  # HBM3, same data sheet


class NoDevice(RuntimeError):
    pass


def parse(argv):
    p = argparse.ArgumentParser(prog="portbench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules():
    """Top-level module names of the JAX package family in this process,
    compared whole (haff_tpu_torch is not haff_tpu)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def device_info(torch, device):
    """The card's name, the cards used, and nvidia-smi's power limit."""
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
             "-i", str(device.index or 0)],
            capture_output=True, text=True, timeout=30)
        info["power_limit"] = out.stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        info["power_limit"] = f"unread ({e})"
    return info


def run(argv=None, t_start=None, device=None, cell=None, cfg=None,
        after_setup=None):
    """Run one cell; return its result line as a dict. `device`,
    `cell`, `cfg` and `after_setup` are for the tests: a CPU device skips
    the look for a card, and `after_setup(driver)` may break the timed
    path underneath."""
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse(argv)
    import torch

    cell = cell or registry.workload(args.workload)
    cfg = cfg or registry.config(cell["config"])
    if device is None:
        if not torch.cuda.is_available():
            raise NoDevice("no CUDA device: the benchmark runs on the card only")
        if torch.cuda.device_count() < cell["chips"]:
            raise NoDevice(f"{cell['name']} needs {cell['chips']} cards, "
                           f"{torch.cuda.device_count()} present")
        device = torch.device("cuda", 0)
    device = torch.device(device)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.set_device(device)
    trace = bool(args.trace)
    spans = Spans(trace, cuda)
    drv = registry.driver(cell["entry"]).Driver(
        cfg, cell, args.seed, device, spans)
    drv.setup()
    drv.install_spans()
    if after_setup is not None:
        after_setup(drv)
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start

    # ---- the window ----
    from torch.profiler import ProfilerActivity, profile, record_function

    t_after = cell.get("trace_after", 1)
    t_count = cell.get("trace_requests", 4)
    prof = win_rf = None
    traced = []
    lat, done, failed, first_error = [], [], 0, None
    i = 0
    t0 = time.perf_counter()
    deadline = t0 + args.seconds
    while time.perf_counter() < deadline:
        if trace and i == t_after:
            prof = profile(activities=[ProfilerActivity.CPU]
                           + ([ProfilerActivity.CUDA] if cuda else []),
                           record_shapes=True)
            prof.start()
            win_rf = record_function("traced_window")
            win_rf.__enter__()
        spans.request_index = i
        s0 = time.perf_counter()
        try:
            with record_function("request"):
                drv.request(i)
            done.append(i)
            lat.append(time.perf_counter() - s0)
        except Exception:  # a failed request counts; the loop goes on
            failed += 1
            first_error = first_error or traceback.format_exc()
        if prof is not None and win_rf is not None:
            traced.append(i)
            if len(traced) == t_count:
                win_rf.__exit__(None, None, None)
                prof.stop()
                win_rf = None
        i += 1
    if win_rf is not None:
        if cuda:
            torch.cuda.synchronize()
        win_rf.__exit__(None, None, None)
        prof.stop()
    window_s = time.perf_counter() - t0
    attempted = i

    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    dev = device_info(torch, device) if cuda else {
        "platform": "cpu", "kind": "cpu", "count": 1}
    dev["memory_peak_bytes"] = int(peak)

    tr = None
    if prof is not None:
        from .trace import Trace

        tr = Trace(prof, "traced_window")
        dev["busy_s"] = tr.busy_s()
        dev["window_s"] = tr.window_s
        del prof

    ctx = SimpleNamespace(
        cell=cell, cfg=cfg, driver=drv, spans=spans, trace=tr,
        setup_s=setup_s, window_s=window_s, latencies_s=lat, done=done,
        traced=set(traced), peak_bytes=peak,
        flops_per_request=drv.flops_per_request(),
        peak_flops=H100_BF16_FLOPS, peak_bytes_per_s=H100_BYTES_PER_S)
    metrics = {}
    for m in registry.benchmark_metrics(cell["name"], trace):
        value = registry.metric(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    # ---- the check: a seeded sample of the answered requests ----
    drv.free()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    sample = choose_sample(args.seed, done, cell["check_requests"], drv)
    numbers = drv.check(sample) if sample else {}
    limits = cell["checks"]
    checks = {k: {"value": (float(numbers[k]) if k in numbers else None),
                  "limit": limits[k]} for k in limits}
    correct = bool(sample) and failed == 0 and all(
        c["value"] is not None and math.isfinite(c["value"])
        and c["value"] <= c["limit"] for c in checks.values())

    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if tr is not None:
        result["breakdown"] = {"device_ops": tr.top_device_ops(),
                               "idle_gaps": tr.idle_gaps()}
    result["checks"] = checks
    if first_error:
        print(first_error, file=sys.stderr)
    if lat:
        q = np.percentile(np.asarray(lat) * 1e3, [10, 25, 50, 75, 90, 99])
        print(f"window {window_s:.3f} s, {len(done)} answered, latency ms "
              f"p10/25/50/75/90/99 " + " ".join(f"{v:.1f}" for v in q),
              file=sys.stderr)
    print(f"checked requests {sample} of {len(done)} answered", file=sys.stderr)
    for k in sorted(set(numbers) - set(checks)):
        print(f"reading {k} {numbers[k]!r} (not compared)", file=sys.stderr)
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    return result


def choose_sample(seed, done, n, drv):
    """A seeded sample of the answered requests, with the longest in it.
    Up to half of it is drawn from the requests the driver's `priority`
    names (those that took a path the others skip; may be none), the
    rest from all."""
    if not done:
        return []
    longest = drv.longest(done)
    rng = traffic._rng(seed, 9)
    picked = {longest}

    def draw(pool, k):
        pool = [i for i in pool if i not in picked]
        k = min(k, len(pool))
        if k > 0:
            picked.update(pool[j] for j in rng.choice(len(pool), size=k,
                                                      replace=False))

    first = drv.priority(done)
    draw(first, n // 2 - len(picked.intersection(first)))
    draw(done, n - len(picked))
    return sorted(picked)


def main(argv=None, t_start=None) -> int:
    try:
        result = run(argv, t_start)
    except NoDevice as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the process loaded {bad}: the benchmark measures "
              "the PyTorch port only", file=sys.stderr)
        return 3
    print(json.dumps(result))
    return 0
