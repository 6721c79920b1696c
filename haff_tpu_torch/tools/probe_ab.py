"""Times the matmul probe (`matmul_probe`, csrc/matmul_probe.cu) of
whichever `haff_tpu_torch` comes first on the import path, int8 and bf16
at 2048^3 (`chip_smoke.py`'s shape), 4096^3 and 8192^3, on the card, with
the library call computing the same product beside it; for comparing two
trees of the port in one chip call, in turns:

    for t in old new new old; do
        PYTHONPATH=$t python haff_tpu_torch/tools/probe_ab.py --label $t
    done

(run by path, with absolute imports, so PYTHONPATH picks the tree; each
tree builds its kernels into its own build/). Each line is one JSON
object: the case, the card's name and power limit, and two warm-L2 times
of one call: `ms_events`, CUDA events around `--iters` calls after a
warm-up (it includes the host's launch time where that is longer than the
kernel), and `ms_graph`, a CUDA graph of `--iters` calls replayed between
events (the device time alone). Beside them, timed the same two ways on
the same operands: `lib_*`, `torch._int_mm` (int8) or `torch.matmul`
(bf16).
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from haff_tpu_torch.tools.flash_ab import card, events_ms, graph_ms

# (name, M, K, N, dtype): the probe's 2048^3 in both types, then two
# sizes where the product is further from its launch and fill costs.
CASES = tuple((f"{s}^3 {dt}", s, s, s, dt) for s in (2048, 4096, 8192)
              for dt in ("int8", "bfloat16"))


def operands(case, gen, device="cuda"):
    """Seeded a (M, K) and b (N, K) of one case: int8 in [-127, 127] or
    bf16 normal."""
    _, m, k, n, dtype = case
    if dtype == "int8":
        return tuple(torch.randint(-127, 128, s, generator=gen, device=device,
                                   dtype=torch.int8) for s in ((m, k), (n, k)))
    return tuple(torch.randn(s, generator=gen, device=device).bfloat16()
                 for s in ((m, k), (n, k)))


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", default="")
    ap.add_argument("--iters", type=int, default=20)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    if not torch.cuda.is_available():
        print("probe_ab: needs a CUDA device", file=sys.stderr)
        return 2
    from haff_tpu_torch.tools.bench_kernels import matmul_probe

    name = card()
    gen = torch.Generator("cuda").manual_seed(0)
    for case in CASES:
        what, m, k, n, dtype = case
        a, b = operands(case, gen)
        iters = args.iters if m * n * k < 3e10 else 5
        runs = {"": lambda: matmul_probe(a, b),
                "lib_": ((lambda: torch._int_mm(a, b.T)) if dtype == "int8"
                         else (lambda: torch.matmul(a, b.T)))}
        line = dict(label=args.label, record="matmul_probe", what=what,
                    shape=[m, k, n], dtype=dtype)
        for key, run in runs.items():
            line[key + "ms_graph"] = graph_ms(run, iters)
            line[key + "ms_events"] = events_ms(run, iters)
        line["card"] = name
        print(json.dumps(line), flush=True)
        del a, b
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
