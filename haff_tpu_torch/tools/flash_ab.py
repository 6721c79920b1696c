"""Times the flash forward (`flash_prefill_kernel`), dq
(`flash_bwd_dq_kernel`) and dk/dv (`flash_bwd_dkv_kernel`) entries of
whichever `haff_tpu_torch` comes first on the import path, at
`chip_smoke.py`'s phase-3 shapes, on the card; for comparing two trees of
the port in one chip call, in turns:

    for t in old new new old; do
        PYTHONPATH=$t python haff_tpu_torch/tools/flash_ab.py --label $t
    done

(run by path, with absolute imports, so PYTHONPATH picks the tree; each
tree builds its kernels into its own build/). Each line is one JSON
object: the entry and shape, the card's name and power limit, and two
warm-L2 times of one call: `ms_events`, CUDA events around `--iters`
calls after a warm-up (it includes the host's launch time where that is
longer than the kernel), and `ms_graph`, a CUDA graph of `--iters` calls
replayed between events (the device time alone).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch

# (record name, batch, length, heads, head dim, causal, valid lengths):
# chip_smoke.py phase 3's flash shapes, the LLaMA-7B prefill and train
# step of 2 requests, row 1 right-padded by 100.
CASES = (
    ("flash_prefill_fwd", 2, 575, 32, 128, True, (575, 475)),
    ("flash_bwd_dq", 2, 575, 32, 128, True, (575, 475)),
    ("flash_bwd_dkv", 2, 575, 32, 128, True, (575, 475)),
)


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def events_ms(fn, iters):
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters):
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (2 * iters)


def operands(case, gen, device="cuda"):
    """Seeded bf16 q, k, v, dO (B, L, H, D) and the segment ids (B, L)
    int32 of one case: 1 up to each row's valid length, 0 after."""
    _, b, l, h, d, _, lengths = case
    q, k, v, do = (torch.randn(b, l, h, d, generator=gen, device=device)
                   .bfloat16() for _ in range(4))
    valid = torch.tensor(lengths, device=device)
    seg = (torch.arange(l, device=device)[None] < valid[:, None]).to(torch.int32)
    return q, k, v, do, seg


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", default="")
    ap.add_argument("--iters", type=int, default=20)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    if not torch.cuda.is_available():
        print("flash_ab: needs a CUDA device", file=sys.stderr)
        return 2
    from haff_tpu_torch.kernels import flash_attention as fa

    name = card()
    gen = torch.Generator("cuda").manual_seed(0)
    for case in CASES:
        rec, b, l, h, d, causal, lengths = case
        q, k, v, do, seg = operands(case, gen)
        if rec == "flash_prefill_fwd":
            run = lambda: fa.flash_prefill_kernel(  # noqa: E731
                q, k, v, None, seg, seg, causal)
        else:
            out, lse = fa.flash_prefill_kernel(q, k, v, None, seg, seg, causal)
            bwd = (fa.flash_bwd_dq_kernel if rec == "flash_bwd_dq"
                   else fa.flash_bwd_dkv_kernel)
            run = lambda: bwd(  # noqa: E731
                q, k, v, None, seg, seg, out, lse, do, causal)
        ev, gr = events_ms(run, args.iters), graph_ms(run, args.iters)
        print(json.dumps(dict(label=args.label, record=rec, shape=[b, l, h, d],
                              causal=causal, lengths=list(lengths),
                              ms_graph=gr, ms_events=ev, card=name)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
