"""SAM attention with the decomposed rel-pos bias over one operand set:
q, k, v (B, L, nh, d), L = h * w, rel-pos tables (2h - 1, d), (2w - 1, d).
Operations: q . Rh and q . Rw (the band), q k^T and p v. Bytes: q, k, v
and both tables read once, the output written once, in `itemsize` bytes
an element."""


def count(b: int, l: int, nh: int, d: int, h: int, w: int,
          itemsize: int = 2) -> dict:
    flops = 2 * b * nh * l * d * (2 * l + h + w)
    nbytes = itemsize * (4 * b * l * nh * d + (2 * h - 1 + 2 * w - 1) * d)
    return {"flops": flops, "bytes": nbytes}
