"""One launch of the routed-expert decode kernel (csrc/moe_decode.cu):
`experts` distinct experts chosen by B rows, k each, of width F at
hidden size d, and `shared` shared experts of the same width that every
row takes, bf16 weights. Bytes: each chosen and each shared expert's
gate, up and down read once, x read, the f32 h and per-(row, expert)
outputs written and read back, y written. Operations: 3 products of
F x d a (row, expert)."""


def count(experts: int, b: int, k: int, f: int, d: int, shared: int = 0) -> dict:
    weights = (experts + shared) * 3 * f * d * 2
    scratch = 2 * b * (k + shared) * (f + d) * 4
    return {"flops": 2 * b * (k + shared) * 3 * f * d,
            "bytes": weights + scratch + 2 * b * d * 2}
