"""Times decode attention (`decode_attention_kernel`,
csrc/decode_attn.cu) of whichever `haff_tpu_torch` comes first on the
import path, at `chip_smoke.py`'s phase-3 decode shapes, on the card; for
comparing two trees of the port in one chip call, in turns:

    for t in old new new old; do
        PYTHONPATH=$t python haff_tpu_torch/tools/decode_ab.py --label $t
    done

(run by path, with absolute imports, so PYTHONPATH picks the tree; each
tree builds its kernels into its own build/). Each line is one JSON
object: the cache kind, shape and live lengths, the card's name and power
limit, and two warm-L2 times of one call: `ms_events`, CUDA events around
`--iters` calls after a warm-up (it includes the host's launch time where
that is longer than the kernel), and `ms_graph`, a CUDA graph of
`--iters` calls replayed between events (the device time alone).
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from haff_tpu_torch.tools.flash_ab import card, events_ms, graph_ms

# (cache kind, batch, cache slots, heads, head dim, live lengths):
# chip_smoke.py phase 3's decode shapes, a LLaMA-7B decode step of 2
# requests over 591 slots (575 spliced + 16 new), one row nearly full and
# one with a single live slot, or both nearly full.
CASES = (
    ("int8", 2, 591, 32, 128, (590, 1)),
    ("bf16", 2, 591, 32, 128, (590, 1)),
    ("int8", 2, 591, 32, 128, (590, 590)),
)


def operands(case, gen, device="cuda"):
    """Seeded bf16 q (B, nh, hd), the k and v caches (B, Lmax, nh, hd) as
    bf16 tensors or int8 QuantArrays (quantized as the int8 KV cache is)
    and the int32 mask (B, Lmax), 1 up to each row's live length."""
    from haff_tpu_torch.nn import quant

    kind, b, lmax, nh, hd, lengths = case
    q = (0.5 * torch.randn(b, nh, hd, generator=gen, device=device)).bfloat16()
    k = 0.5 * torch.randn(b, lmax, nh, hd, generator=gen, device=device)
    v = torch.randn(b, lmax, nh, hd, generator=gen, device=device)
    if kind == "int8":
        k, v = quant.quantize_activation(k), quant.quantize_activation(v)
    else:
        k, v = k.bfloat16(), v.bfloat16()
    mask = (torch.arange(lmax, device=device)[None]
            < torch.tensor(lengths, device=device)[:, None]).to(torch.int32)
    return q, k, v, mask


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", default="")
    ap.add_argument("--iters", type=int, default=50)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    if not torch.cuda.is_available():
        print("decode_ab: needs a CUDA device", file=sys.stderr)
        return 2
    from haff_tpu_torch.kernels import decode_attention as da

    name = card()
    gen = torch.Generator("cuda").manual_seed(0)
    for case in CASES:
        kind, b, lmax, nh, hd, lengths = case
        q, k, v, mask = operands(case, gen)
        run = lambda: da.decode_attention_kernel(  # noqa: E731
            q, k, v, mask, hd ** -0.5)
        ev, gr = events_ms(run, args.iters), graph_ms(run, args.iters)
        print(json.dumps(dict(label=args.label, record="decode_attn",
                              cache=kind, shape=[b, lmax, nh, hd],
                              lengths=list(lengths), ms_graph=gr,
                              ms_events=ev, card=name)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
