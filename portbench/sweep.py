"""The readings that set a cell's `correct` limits: the harness run in one
process over many seeds (weights and inputs made anew from each), as the
program or as its lower-precision control, one JSON line a run (the
checks, the readings, the end-to-end metrics) on the standard output
and appended to `--out` (default runs/sweep/<cell>_<mode>.jsonl).

    python3 portbench/sweep.py --workload <cell> --mode program|control \\
        --seconds 5 --seeds 2147500101 2147500102 ... [--until 900]

The control is the program's own int8 path: W8A8 on the decoder's dense
layers over the bf16 latent cache for a DeepSeek-V3 configuration
(portbench/tests/test_portbench_rows_control.py), else W8A8 on the
serving set over the int8 KV cache
(portbench/tests/test_portbench_control.py). `--until`
stops starting runs after that many wall seconds. The card only."""

import argparse
import contextlib
import io
import json
import os
import sys
import time
from pathlib import Path

T0 = time.perf_counter()
ROOT = Path(__file__).resolve().parent.parent
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
sys.path.insert(0, str(ROOT))


def control_hook(cfg):
    """The after_setup hook that turns the program into its control."""
    from portbench import deepseek

    if deepseek.is_deepseek(cfg):
        from portbench.tests.test_portbench_rows_control import w8a8
    else:
        from portbench.tests.test_portbench_control import w8a8
    return w8a8


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--mode", choices=("program", "control"), required=True)
    ap.add_argument("--seconds", default="5")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--until", type=float, default=float("inf"))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    from portbench import harness, registry

    cell = registry.workload(args.workload)
    hook = (control_hook(registry.config(cell["config"]))
            if args.mode == "control" else None)
    out = Path(args.out or ROOT / "runs" / "sweep"
               / f"{args.workload}_{args.mode}.jsonl")
    out.parent.mkdir(parents=True, exist_ok=True)
    for seed in args.seeds:
        if time.perf_counter() - T0 > args.until:
            break
        t = time.perf_counter()
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            res = harness.run(["--workload", args.workload, "--seed",
                               str(seed), "--seconds", args.seconds,
                               "--trace", "0"],
                              device=torch.device("cuda", 0),
                              after_setup=hook)
        lines = err.getvalue().splitlines()
        line = dict(
            cell=args.workload, mode=args.mode, seed=seed,
            correct=res["correct"], attempted=res["attempted"],
            checks={k: v["value"] for k, v in res["checks"].items()},
            readings={ln.split()[1]: float(ln.split()[2]) for ln in lines
                      if ln.startswith("reading ")},
            metrics={k: v["value"] for k, v in res["metrics"].items()},
            seg=[ln for ln in lines if ln.startswith("[SEG]")],
            secs=round(time.perf_counter() - t, 1))
        print(json.dumps(line), flush=True)
        with open(out, "a") as f:
            f.write(json.dumps(line) + "\n")
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
