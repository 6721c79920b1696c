"""The routed experts of a decode step (the deepseek_v3 decoder's MoE
layers, nn/deepseek_v3.py): `moe_decode` -> csrc/moe_decode.cu on the
card, `moe_decode_plain` for CPU tensors, with no fallback between the
two.

    y[b] = sum_k w[b, k] * down_e (silu(gate_e x[b]) * up_e x[b]),
    e = idx[b, k]

over the stacked expert weights gate / up (E, F, d) and down (E, d, F),
plus the shared experts' SwiGLU (gate / up (S F, d), down (d, S F)) with
weight 1.
The routing comes as device tensors (idx (B, k) int64, w (B, k)
float32), so the call needs no host sync and is captured in the decode
graph. The kernel reads only the chosen experts' weights, each once a
step even where several rows chose it: the block of an expert's first
(row, k) slot computes every row that chose it, and the blocks of its
later slots leave at once. Gate and up with SiLU times up, then down,
run in float32 from the bf16 operands; the k outputs of a row are summed
in float32 in the order k = 0, 1, ... (deterministic), the shared
experts' added last (the kernel takes them as S more experts of width F,
each one F-wide part of their SwiGLU), then rounded to x's dtype. One C entry launches the gate/up, down and combine kernels:
one count of `moe_decode` a call.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build

_NAME = "moe_decode"


def moe_decode_plain(x, idx, w, gate, up, down, shared):
    """x (B, d); idx (B, k) expert ids; w (B, k) float32 weights; gate /
    up (E, F, d), down (E, d, F); `shared` the shared experts' (gate
    (S F, d), up (S F, d), down (d, S F)). float32 products, the k terms
    summed in order, the shared experts' last. Returns (B, d) in x's
    dtype."""
    xf = x.float()
    y = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for k in range(idx.shape[1]):
        e = idx[:, k].long()
        g = torch.einsum("bd,bfd->bf", xf, gate[e].float())
        u = torch.einsum("bd,bfd->bf", xf, up[e].float())
        h = F.silu(g) * u
        y = y + w[:, k].float()[:, None] * torch.einsum(
            "bf,bdf->bd", h, down[e].float())
    sg, su, sd = (t.float() for t in shared)
    y = y + F.linear(F.silu(F.linear(xf, sg)) * F.linear(xf, su), sd)
    return y.to(x.dtype)


def _lib():
    fn = _build.library(_NAME).moe_decode
    if fn.argtypes is None:
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, i32,
                       i32, i32, i32, i32, i32, vp]
        fn.restype = ctypes.c_int
    return fn


def moe_decode_kernel(x, idx, w, gate, up, down, shared):
    """Launch csrc/moe_decode.cu (bf16 operands). Forward only."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, gate, up, down)):
        raise RuntimeError(f"{_NAME}: the CUDA kernel is forward-only; "
                           "decode under torch.no_grad()")
    b, d = x.shape
    k = idx.shape[1]
    e, f = gate.shape[:2]
    if d % 8 or f % 8 or b > 64:
        raise ValueError(f"{_NAME}: B={b} d={d} F={f}; need B <= 64 and "
                         "d, F % 8 == 0")
    check = _build.check_operand
    for what, t, shape in (("x", x, (b, d)), ("gate", gate, (e, f, d)),
                           ("up", up, (e, f, d)), ("down", down, (e, d, f))):
        check(_NAME, what, t, torch.bfloat16, shape)
    sg, su, sd = shared
    n_shared = sg.shape[0] // f
    if n_shared < 1 or n_shared * f != sg.shape[0]:
        raise ValueError(f"{_NAME}: shared width {sg.shape[0]} is not a "
                         f"positive multiple of the experts' {f}")
    for what, t, shape in (("shared gate", sg, (n_shared * f, d)),
                           ("shared up", su, (n_shared * f, d)),
                           ("shared down", sd, (d, n_shared * f))):
        check(_NAME, what, t, torch.bfloat16, shape)
    idx = idx.long().contiguous()
    wf = w.float().contiguous()
    check(_NAME, "idx", idx, torch.int64, (b, k))
    check(_NAME, "w", wf, torch.float32, (b, k))
    out = torch.empty_like(x)
    if b and k:
        rows = b * (k + n_shared)
        h = torch.empty(rows * f, dtype=torch.float32, device=x.device)
        part = torch.empty(rows * d, dtype=torch.float32, device=x.device)
        ptr = _build.ptr
        err = _lib()(ptr(x), ptr(idx), ptr(wf), ptr(gate), ptr(up), ptr(down),
                     ptr(sg), ptr(su), ptr(sd), ptr(h), ptr(part), ptr(out), b,
                     k, e, n_shared, f, d, _build.stream_handle(x.device))
        _build.LAUNCHES[_NAME] += 1
        _build.check(err, _NAME)
    return out


def moe_decode(x, idx, w, gate, up, down, shared):
    """The routed experts' sum for B tokens with the shared experts' (see
    the module docstring): the kernel for CUDA tensors, the plain version
    otherwise."""
    run = moe_decode_kernel if x.is_cuda else moe_decode_plain
    return run(x, idx, w, gate, up, down, shared)
