"""Times the W4A16 product (`int4_matmul_kernel`, csrc/w4a16_matmul.cu) of
whichever `haff_tpu_torch` comes first on the import path, at
`chip_smoke.py`'s phase-3 w4a16 shapes, on the card; for comparing two
trees of the port in one chip call, in turns:

    for t in old new new old; do
        PYTHONPATH=$t python haff_tpu_torch/tools/w4a16_ab.py --label $t
    done

(run by path, with absolute imports, so PYTHONPATH picks the tree; each
tree builds its kernels into its own build/). Each line is one JSON
object: the shape, the path the wrapper chose (where the tree has
`w4a16_path`), the card's name and power limit, and two warm-L2 times of
one call: `ms_events`, CUDA events around `--iters` calls after a warm-up
(it includes the host's launch time where that is longer than the
kernel), and `ms_graph`, a CUDA graph of `--iters` calls replayed between
events (the device time alone). Beside them, timed the same two ways on
the same operands: `bf16_*`, `torch.matmul` on the weight already
dequantized to bf16 (what a bf16 model runs; float32 in the float32
case), and `dequant_*`, dequantize
+ `torch.matmul` (`int4_matmul_dequant`, the prefill route).
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from haff_tpu_torch.tools.flash_ab import card, events_ms, graph_ms

GROUP = 64  # the 7b serving group (chip_smoke.py quantize_for)

# (name, M, K, N, dtype): the LLaMA-7B decode step's products at a batch
# of 2 (4096 x 4096, gate/up, down, lm_head), a 4096 x 4096 product at M =
# 16, the widest layer at the largest M the kernel takes (256), one
# scalar-path case (float32 activations), a speculative verify step's
# products at M = 16 (batch 2 x 8 drafts: gate/up, down, lm_head) and
# MPT-7B's decode products (fused Wqkv, up, down at expansion 4).
CASES = (
    ("decode", 2, 4096, 4096, "bfloat16"),
    ("decode gate/up", 2, 4096, 11008, "bfloat16"),
    ("decode down", 2, 11008, 4096, "bfloat16"),
    ("decode lm_head", 2, 4096, 32004, "bfloat16"),
    ("decode M=16", 16, 4096, 4096, "bfloat16"),
    ("M=256", 256, 4096, 11008, "bfloat16"),
    ("float32", 2, 4096, 11008, "float32"),
    ("verify M=16 gate/up", 16, 4096, 11008, "bfloat16"),
    ("verify M=16 down", 16, 11008, 4096, "bfloat16"),
    ("verify M=16 lm_head", 16, 4096, 32004, "bfloat16"),
    ("MPT Wqkv decode", 2, 4096, 12288, "bfloat16"),
    ("MPT up decode", 2, 4096, 16384, "bfloat16"),
    ("MPT down decode", 2, 16384, 4096, "bfloat16"),
)


def operands(case, gen, device="cuda"):
    """Seeded x (M, K) in the case's dtype, packed (N, K/2) uint8 and
    scale (N, K/GROUP) float32 of one case, quantized as `quantize_model_`
    quantizes a 4-bit layer."""
    from haff_tpu_torch.nn import quant

    _, m, k, n, dtype = case
    x = torch.randn(m, k, generator=gen, device=device).to(getattr(torch,
                                                                  dtype))
    w = torch.randn(n, k, generator=gen, device=device) * k ** -0.5
    packed, scale = quant.quantize_kernel_int4(w, GROUP)
    return x, packed, scale


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", default="")
    ap.add_argument("--iters", type=int, default=20)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    if not torch.cuda.is_available():
        print("w4a16_ab: needs a CUDA device", file=sys.stderr)
        return 2
    from haff_tpu_torch.nn import quant

    name = card()
    gen = torch.Generator("cuda").manual_seed(0)
    path_of = getattr(quant, "w4a16_path", None)
    for case in CASES:
        what, m, k, n, _ = case
        x, packed, sc = operands(case, gen)
        dt = x.dtype
        wd = quant.dequantize_kernel_int4(packed, sc, GROUP, dt)
        runs = {
            "": lambda: quant.int4_matmul_kernel(x, packed, sc, GROUP, dt),
            "bf16_": lambda: torch.matmul(x, wd.T),
            "dequant_": lambda: quant.int4_matmul_dequant(x, packed, sc,
                                                          GROUP, dt),
        }
        line = dict(label=args.label, record="w4a16_matmul", what=what,
                    shape=[m, k, n], dtype=str(dt).replace("torch.", ""),
                    path=(quant.W4A16_PATH_NAMES[path_of(x, packed, sc, GROUP)]
                          if path_of else None))
        for key, run in runs.items():
            line[key + "ms_graph"] = graph_ms(run, args.iters)
            line[key + "ms_events"] = events_ms(run, args.iters)
        line["card"] = name
        print(json.dumps(line), flush=True)
        del x, packed, sc, wd
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
