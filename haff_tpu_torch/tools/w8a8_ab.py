"""Times the W8A8 product (`int8_matmul_kernel`, csrc/w8a8_matmul.cu) of
whichever `haff_tpu_torch` comes first on the import path, at
`chip_smoke.py`'s phase-3 shapes, on the card; for comparing two trees of
the port in one chip call, in turns:

    for t in old new new old; do
        PYTHONPATH=$t python haff_tpu_torch/tools/w8a8_ab.py --label $t
    done

(run by path, with absolute imports, so PYTHONPATH picks the tree; each
tree builds its kernels into its own build/). Each line is one JSON
object: the shape, the card's name and power limit, and two warm-L2
times of one call with a bf16 output: `ms_events`, CUDA events around
`--iters` calls after a warm-up (it includes the host's launch time
where that is longer than the kernel), and `ms_graph`, a CUDA graph of
`--iters` calls replayed between events (the device time alone). Beside
them, timed the same two ways: `lib_*`, `torch._int_mm` + the rescale on
the same int8 operands, padded outside the timed call as `_int_mm`
requires (M to at least 32, N and K to multiples of 8).
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from haff_tpu_torch.tools.flash_ab import card, events_ms, graph_ms

# (name, M, K, N): chip_smoke.py phase 3's w8a8 shapes: the LLaMA-7B
# prefill of 2 requests (1150 tokens) through a 4096 x 4096 projection, a
# decode step, the prefill's lm_head, SAM ViT-H's qkv at batch 2, and the
# other decode products of a step of 2 (gate/up, down, lm_head), a
# 4096 x 4096 projection at the skinny path's largest M, and MPT-7B's
# decode products (fused Wqkv, up, down at expansion 4).
CASES = (
    ("prefill", 1150, 4096, 4096),
    ("decode", 2, 4096, 4096),
    ("lm_head", 1150, 4096, 32004),
    ("sam qkv", 9800, 1280, 3840),
    ("decode gate/up", 2, 4096, 11008),
    ("decode down", 2, 11008, 4096),
    ("decode lm_head", 2, 4096, 32004),
    ("decode M=16", 16, 4096, 4096),
    ("MPT Wqkv decode", 2, 4096, 12288),
    ("MPT up decode", 2, 4096, 16384),
    ("MPT down decode", 2, 16384, 4096),
)


def operands(case, gen, device="cuda"):
    """Seeded int8 xq (M, K) and weight (N, K), float32 scales sx (M,)
    and sw (N,) of one case, quantized as `int8_matmul` quantizes."""
    from haff_tpu_torch.nn import quant

    _, m, k, n = case
    x = torch.randn(m, k, generator=gen, device=device).bfloat16()
    w = torch.randn(n, k, generator=gen, device=device) * k ** -0.5
    q, sw = quant.quantize_kernel(w)
    xq, sx = quant.quantize_activation(x)
    return xq, q, sx[:, 0].contiguous(), sw


def library_fn(xq, q, sx, sw, out_dtype=torch.bfloat16):
    """torch._int_mm + the rescale on xq (M, K) and q (N, K), both padded
    here, before any timing: M to at least 32 (and 8), N and K to
    multiples of 8. The (M, N) corner of its result is the product."""
    (m, k), n = xq.shape, q.shape[0]
    mp, np_, kp = max(32, -(-m // 8) * 8), -(-n // 8) * 8, -(-k // 8) * 8
    xq_p = xq.new_zeros(mp, kp)
    xq_p[:m, :k] = xq
    q_p = q.new_zeros(np_, kp)
    q_p[:n, :k] = q
    sx_p = sx.new_ones(mp, 1)
    sx_p[:m, 0] = sx
    sw_p = sw.new_ones(np_)
    sw_p[:n] = sw
    return lambda: (torch._int_mm(xq_p, q_p.T).float() * sx_p
                    * sw_p).to(out_dtype)


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", default="")
    ap.add_argument("--iters", type=int, default=20)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    if not torch.cuda.is_available():
        print("w8a8_ab: needs a CUDA device", file=sys.stderr)
        return 2
    from haff_tpu_torch.nn import quant

    name = card()
    gen = torch.Generator("cuda").manual_seed(0)
    for case in CASES:
        what, m, k, n = case
        xq, q, sx, sw = operands(case, gen)
        runs = {"": lambda: quant.int8_matmul_kernel(
            xq, q, sx, sw, torch.bfloat16), "lib_": library_fn(xq, q, sx, sw)}
        line = dict(label=args.label, record="w8a8_matmul", what=what,
                    shape=[m, k, n])
        for key, run in runs.items():
            line[key + "ms_graph"] = graph_ms(run, args.iters)
            line[key + "ms_events"] = events_ms(run, args.iters)
        line["card"] = name
        print(json.dumps(line), flush=True)
        del runs, xq, q
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
