"""Times the SAM attention entries of whichever `haff_tpu_torch` comes
first on the import path, at `chip_smoke.py`'s phase-3 shapes, on the card;
for comparing two trees of the port in one chip call, in turns:

    for t in old new new old; do
        PYTHONPATH=$t python haff_tpu_torch/tools/sam_ab.py --label $t
    done

(run by path, with absolute imports, so PYTHONPATH picks the tree; each
tree builds its kernels into its own build/). Each line is one JSON
object: the entry and shape, the card's name and power limit, and two
warm-L2 times of one call: `ms_events`, CUDA events around `--iters`
calls after a warm-up (it includes the host's launch time where that is
longer than the kernel), and `ms_graph`, a CUDA graph of `--iters` calls
replayed between events (the device time alone), null where the call
cannot be captured (a wrapper that copies from the host inside the call,
as the scalar global path's band tables do).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch

# (record name, scope, entry, batch, grid, heads, head dim): chip_smoke.py
# phase 3's first shape of each SAM record, and the other shapes it times.
CASES = (
    ("sam_window_relpos_attn", "window", "split", 25, (14, 14), 16, 80),
    ("sam_global_relpos_attn", "global", "fused", 1, (64, 64), 16, 80),
    ("sam_window_relpos_attn_fused", "window", "fused", 25, (14, 14), 16, 80),
    ("sam_window_relpos_attn_fused", "window", "fused", 25, (14, 12), 16, 80),
    ("sam_window_relpos_attn/vit_b", "window", "split", 25, (14, 14), 12, 64),
    ("sam_window_relpos_attn/vit_b", "window", "split", 16, (8, 8), 8, 32),
    ("sam_global_relpos_attn_heads", "global", "heads", 1, (64, 64), 12, 64),
    ("sam_window_relpos_attn_heads", "window", "heads", 25, (14, 14), 16, 80),
    ("sam_global_relpos_attn", "global", "fused", 2, (64, 64), 16, 80),
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


def entry_call(sa, scope, entry, qkv, rh, rw, hw, nh):
    """The entry on operands laid out as chip_smoke.py's sam_case holds
    them: the fused projection, q3 / kv3 copies, or per-head copies."""
    c = qkv.shape[-1] // 3
    if entry == "fused":
        fn = (sa.sam_window_attention_qkv if scope == "window"
              else sa.sam_global_attention_qkv)
        return lambda: fn(qkv, rh, rw, hw, nh)
    if entry == "split":
        q3, kv3 = qkv[..., :c].contiguous(), qkv[..., c:].contiguous()
        return lambda: sa.sam_window_attention_qkv_split(q3, kv3, rh, rw, hw, nh)
    q, k, v = (sa.head_view(qkv, 3, i, nh).contiguous() for i in range(3))
    fn = sa.sam_window_attention if scope == "window" else sa.sam_global_attention
    return lambda: fn(q, k, v, rh, rw, hw)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", default="")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sam_ab: needs a CUDA device", file=sys.stderr)
        return 2
    from haff_tpu_torch.kernels import sam_attention as sa

    name = card()
    gen = torch.Generator("cuda").manual_seed(0)
    for rec, scope, entry, b, hw, nh, d in CASES:
        l = hw[0] * hw[1]
        qkv = torch.randn(b, l, 3 * nh * d, generator=gen, device="cuda").bfloat16()
        rh = 0.1 * torch.randn(2 * hw[0] - 1, d, generator=gen, device="cuda")
        rw = 0.1 * torch.randn(2 * hw[1] - 1, d, generator=gen, device="cuda")
        run = entry_call(sa, scope, entry, qkv, rh, rw, hw, nh)
        with torch.no_grad():
            ev = events_ms(run, args.iters)
            try:
                gr = graph_ms(run, args.iters)
            except RuntimeError:  # a host copy inside the call
                torch.cuda.synchronize()
                gr = None
        print(json.dumps(dict(label=args.label, record=rec, entry=entry,
                              shape=[b, l, nh, d], grid=list(hw),
                              ms_graph=gr, ms_events=ev, card=name)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
