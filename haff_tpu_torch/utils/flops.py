"""FLOP accounting for self-auditing benchmarks (port of
haff_tpu/utils/flops.py).

JAX reads XLA's cost model of the compiled executable. Here the count is
`torch.utils.flop_counter.FlopCounterMode` over one call: matrix products
and convolutions by their shapes, and the SAM attention custom ops by the
formulas kernels/sam_attention.py registers for them. Elementwise work
is not counted, as in XLA's matmul-dominated totals.

The peak is the card's own: `measure_peak_tflops` times a chain of bf16
`torch.matmul` products on it, in the same run that reports the MFU;
there is no built-in figure.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.flop_counter import FlopCounterMode


def count_flops(fn, *args, **kwargs) -> int:
    """FLOPs of one call `fn(*args, **kwargs)` (the call runs)."""
    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return int(counter.get_total_flops())


def measure_peak_tflops(n: int = 8192, iters: int = 20,
                        device="cuda") -> float:
    """Sustained bf16 matmul rate of the card, TFLOP/s: `iters` chained
    (n x n) @ (n x n) products between CUDA events, after a warm-up."""
    if torch.device(device).type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("measure_peak_tflops: no CUDA device")
    g = torch.Generator(device).manual_seed(0)
    a = torch.randn((n, n), generator=g, device=device, dtype=torch.bfloat16)
    b = torch.randn((n, n), generator=g, device=device,
                    dtype=torch.bfloat16) / n ** 0.5
    x = a
    for _ in range(3):
        x = torch.matmul(x, b)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    x = a
    start.record()
    for _ in range(iters):
        x = torch.matmul(x, b)
    end.record()
    torch.cuda.synchronize()
    seconds = start.elapsed_time(end) / 1e3
    return 2.0 * n ** 3 * iters / seconds / 1e12


def mfu_fields(flops_per_call: Optional[float], calls_per_sec: float,
               peak_tflops: float, prefix: str = "") -> dict:
    """{tflops, mfu_pct} against `peak_tflops` (measured on the same card;
    empty when the flops are unknown)."""
    if not flops_per_call:
        return {}
    tflops = flops_per_call * calls_per_sec / 1e12
    return {prefix + "tflops": tflops,
            prefix + "mfu_pct": 100.0 * tflops / peak_tflops}
