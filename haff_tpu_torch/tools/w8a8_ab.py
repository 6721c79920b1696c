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
`--iters` calls replayed between events (the device time alone).
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
# other decode products of a step of 2 (gate/up, down, lm_head) and a
# 4096 x 4096 projection at the skinny path's largest M.
CASES = (
    ("prefill", 1150, 4096, 4096),
    ("decode", 2, 4096, 4096),
    ("lm_head", 1150, 4096, 32004),
    ("sam qkv", 9800, 1280, 3840),
    ("decode gate/up", 2, 4096, 11008),
    ("decode down", 2, 11008, 4096),
    ("decode lm_head", 2, 4096, 32004),
    ("decode M=16", 16, 4096, 4096),
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
        run = lambda: quant.int8_matmul_kernel(  # noqa: E731
            xq, q, sx, sw, torch.bfloat16)
        ev, gr = events_ms(run, args.iters), graph_ms(run, args.iters)
        print(json.dumps(dict(label=args.label, record="w8a8_matmul", what=what,
                              shape=[m, k, n], ms_graph=gr, ms_events=ev,
                              card=name)), flush=True)
        del xq, q
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
