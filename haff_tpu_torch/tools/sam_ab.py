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

`--encode vit_b,vit_h` times, instead of the entries, one eager
`Sam.encode_image` (bf16, weights drawn from a generator seeded 0, one
1024 x 1024 image, no grad) at each named encoder preset: `ms_events` as
above over `--iters` calls, and `ms_host`, the host's time to issue one
call (its Python and dispatch work; the card is the bottleneck where
`ms_host` < `ms_events`).

`--dispatch` (a tree whose kernels are the `haff::` ops) times instead
the host's cost of reaching the window kernel through
`torch.ops.haff.sam_window_relpos_attn` against calling its launcher
directly, at the first case's shape: `us_op` and `us_direct`, the median
over `--iters` rounds of the host time to issue 64 calls, a call.
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


def encode_times(preset, iters, label, name):
    """One JSON line: eager encode_image at encoder `preset` (see the
    module's docstring)."""
    import time

    from haff_tpu_torch.core.config import SamDecoderConfig, SamEncoderConfig
    from haff_tpu_torch.model.lisa import init_random_
    from haff_tpu_torch.nn.sam import Sam

    cfg = SamEncoderConfig.preset(preset)
    with torch.device("meta"):
        sam = Sam(cfg, SamDecoderConfig())
    sam = sam.to(torch.bfloat16).to_empty(device="cuda")
    with torch.no_grad():
        init_random_(sam, torch.Generator("cuda").manual_seed(0))
        x = torch.randn((1, cfg.image_size, cfg.image_size, 3), device="cuda",
                        generator=torch.Generator("cuda").manual_seed(1))
        run = lambda: sam.encode_image(x)  # noqa: E731
        ev = events_ms(run, iters)
        host = []
        for _ in range(iters):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            host.append(1e3 * (time.perf_counter() - t0))
        torch.cuda.synchronize()
    print(json.dumps(dict(label=label, record="encode_image", preset=preset,
                          ms_events=ev, ms_host=sorted(host)[len(host) // 2],
                          card=name)), flush=True)


def dispatch_times(sa, iters, label, name):
    """One JSON line: host microseconds a call, op against launcher (see
    the module's docstring)."""
    import time

    _, _, _, b, hw, nh, d = CASES[0]
    gen = torch.Generator("cuda").manual_seed(0)
    q, k, v = (torch.randn(b, hw[0] * hw[1], nh, d, generator=gen,
                           device="cuda").bfloat16() for _ in range(3))
    rh = 0.1 * torch.randn(2 * hw[0] - 1, d, generator=gen, device="cuda")
    rw = 0.1 * torch.randn(2 * hw[1] - 1, d, generator=gen, device="cuda")
    args = (q, k, v, rh, rw, hw, d ** -0.5, sa.WINDOW_SPLIT)
    calls = {"us_op": lambda: sa.WINDOW_OP(*args),
             "us_direct": lambda: sa._launch_window(*args)}
    got = {key: [] for key in calls}
    for _ in range(iters):
        for key, fn in calls.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(64):
                fn()
            got[key].append(1e6 * (time.perf_counter() - t0) / 64)
    torch.cuda.synchronize()
    print(json.dumps(dict(label=label, record="dispatch", shape=[
        b, hw[0] * hw[1], nh, d], **{key: sorted(t)[len(t) // 2]
                                     for key, t in got.items()},
        card=name)), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", default="")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--encode", default="",
                    help="comma-separated encoder presets (vit_b, vit_h)")
    ap.add_argument("--dispatch", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sam_ab: needs a CUDA device", file=sys.stderr)
        return 2
    from haff_tpu_torch.kernels import sam_attention as sa

    name = card()
    if args.dispatch:
        dispatch_times(sa, args.iters, args.label, name)
        return 0
    if args.encode:
        for preset in args.encode.split(","):
            encode_times(preset, args.iters, args.label, name)
        return 0
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
