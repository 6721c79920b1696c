"""One launch of the MLA decode kernel (csrc/mla_decode_attn.cu) over a
batch whose rows have `live` live latent slots in all (of `lmax` each),
nh heads, R + P = `width` values a slot of which R are values, bf16.
Bytes: the live slots read once for all heads, each row's new slot
written, the queries read, the outputs written, the live-slot mask
read. Operations: a score over the width and a sum over R a (head,
live slot)."""


def count(live: int, b: int, lmax: int, nh: int, width: int, r: int) -> dict:
    return {"flops": 2 * nh * live * (width + r),
            "bytes": (live + b) * width * 2 + b * nh * (width + r) * 2
            + b * lmax * 4}
