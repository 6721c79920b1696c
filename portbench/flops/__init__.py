"""Operation and byte counts, one file an op, worked out from shapes.

Each module has `count(...) -> dict(flops=..., bytes=...)`: flops are
2 x the multiply-adds of the op's matrix products and convolutions
(elementwise work, norms and softmax are not counted); bytes, where a
module gives them, count each input read once and each output written
once. The harness finds a module by its name (`registry.flops`).
"""
