"""Kernel micro-benchmarks on the card (port of the root
tools/bench_kernels.py):

    python -m haff_tpu_torch.tools.bench_kernels <cmd> [options]

    winprof   [--batch B]      SAM ViT-H windowed block at batch B: the qkv
                               projection, the attention kernel, the block
    winvar    [--batch B]      the window kernel through its three operand
                               entries (split, fused, per-head): what the
                               TPU variants compared was operand layout
    attnpath  [--batch B]      fused projection + fused entry against split
                               projection + split entry
    int8probe [--shape M K N]  one tensor-core matmul structure (wgmma +
                               TMA), int8 against bf16: the rate ratio
    w8a8      [--shape M K N]  the w8a8 product, its plain version, the
                               torch._int_mm route, the bf16 matmul
    w4a16     [--shape M K N]  the w4a16 product, its plain version,
                               dequantize + torch.matmul

Times are CUDA events around `--iters` launches after a warm-up, with a
warm L2; every line ends with the card's name and power limit
(nvidia-smi). `--device cpu` rehearses a command with the plain versions
on the host clock and says so on every line: those are not device times.

Also holds the wrapper and the plain version of the one kernel that
belongs to this tool, csrc/matmul_probe.cu.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import time

import torch

from ..core.config import SamEncoderConfig
from ..kernels import _build
from ..kernels import sam_attention as sa
from ..nn import quant
from ..nn.sam_image_encoder import SamBlock

PROBE = "matmul_probe"


# ---------------------------------------------------------------------------
# The probe kernel: wrapper and plain version
# ---------------------------------------------------------------------------

def matmul_probe_plain(a, b):
    """a (M, K) @ b (N, K)^T: int8 -> int32 (through float64, exact: the
    card has no integer matmul in PyTorch), bf16 -> float32."""
    if a.dtype == torch.int8:
        return (a.double() @ b.double().T).to(torch.int32)
    return a.float() @ b.float().T


def matmul_probe(a, b):
    """The probe product a (M, K) @ b (N, K)^T, both int8 (-> int32) or
    both bfloat16 (-> float32), on the tensor cores. CUDA tensors launch
    csrc/matmul_probe.cu, CPU tensors take the plain version."""
    if not a.is_cuda:
        return matmul_probe_plain(a, b)
    if a.dtype not in (torch.int8, torch.bfloat16) or b.dtype != a.dtype:
        raise TypeError(f"{PROBE}: dtypes {a.dtype}, {b.dtype}; need two "
                        "int8 or two bfloat16 operands")
    (m, k), n = a.shape, b.shape[0]
    _build.check_operand(PROBE, "a", a, a.dtype, (m, k))
    _build.check_operand(PROBE, "b", b, a.dtype, (n, k))
    if k % 32 or a.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError(f"{PROBE}: K = {k} must be a multiple of 32 and the "
                         "operands 16-byte aligned (TMA tensor maps)")
    fn = _build.library(PROBE).matmul_probe
    if fn.argtypes is None:
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, i32, i32, i32, i32, vp]
        fn.restype = ctypes.c_int
    is_int8 = a.dtype == torch.int8
    out = torch.empty((m, n), device=a.device,
                      dtype=torch.int32 if is_int8 else torch.float32)
    if m and n:
        err = fn(_build.ptr(a), _build.ptr(b), _build.ptr(out), m, n, k,
                 int(is_int8), _build.stream_handle(a.device))
        _build.LAUNCHES[PROBE] += 1
        _build.check(err, PROBE)
    return out


# ---------------------------------------------------------------------------
# Timing
# ---------------------------------------------------------------------------

class Bench:
    """Times callables on one device and prints one line each."""

    def __init__(self, device="cuda", iters=20):
        self.dev = torch.device(device)
        self.iters = iters
        if self.dev.type == "cuda":
            self.where = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True, text=True,
                check=True).stdout.strip().splitlines()[0]
        else:
            self.where = "cpu rehearsal, host clock: not a device time"
        self.rows = {}

    def ms(self, fn, warmup=2):
        for _ in range(warmup):
            fn()
        if self.dev.type != "cuda":
            t0 = time.perf_counter()
            for _ in range(self.iters):
                fn()
            return (time.perf_counter() - t0) / self.iters * 1e3
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(self.iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / self.iters

    def row(self, name, fn, ops=None):
        """Time `fn`, print its line (with T op/s when `ops` is given)."""
        t = self.ms(fn)
        rate = "" if ops is None else f"  {ops / t / 1e9:8.2f} Top/s"
        print(f"{name:24s} {t:10.4f} ms{rate}  [{self.where}]", flush=True)
        self.rows[name] = t
        return t

    def randn(self, *shape, scale=1.0, dtype=torch.bfloat16, seed=0):
        g = torch.Generator(self.dev).manual_seed(seed)
        return (scale * torch.randn(*shape, generator=g,
                                    device=self.dev)).to(dtype)


def _window_operands(bench, batch, cfg, dtype):
    """Window-partitioned tokens of `batch` images and a windowed block."""
    wins = (-(-cfg.grid_size // cfg.window_size)) ** 2 * batch
    l = cfg.window_size ** 2
    x = bench.randn(wins, l, cfg.embed_dim, dtype=dtype)
    block = SamBlock(cfg, cfg.window_size).to(bench.dev, dtype)
    gen = torch.Generator(bench.dev).manual_seed(1)
    with torch.no_grad():
        for p in block.parameters():
            p.copy_(0.02 * torch.randn(p.shape, generator=gen, device=bench.dev))
    return x, block


@torch.no_grad()
def cmd_winprof(bench, batch=1, cfg=None, dtype=torch.bfloat16):
    cfg = cfg or SamEncoderConfig.preset("vit_h")
    x, block = _window_operands(bench, batch, cfg, dtype)
    attn, c, w = block.attn, cfg.embed_dim, cfg.window_size
    bw, l, _ = x.shape
    split = lambda: attn.qkv(x.reshape(bw * l, c), out_split=(c, 2 * c))  # noqa: E731
    q3, kv3 = (t.reshape(bw, l, -1) for t in split())
    image = bench.randn(batch, cfg.grid_size, cfg.grid_size, c, dtype=dtype)
    print(f"winprof: batch {batch}, {bw} windows of {w} x {w}, "
          f"{cfg.num_heads} heads x {c // cfg.num_heads}, {dtype}")
    bench.row("qkv projection (split)", split, ops=2 * bw * l * c * 3 * c)
    bench.row("window attention", lambda: sa.sam_window_attention_qkv_split(
        q3, kv3, attn.rel_pos_h, attn.rel_pos_w, (w, w), cfg.num_heads),
        ops=4 * bw * l * l * c)
    bench.row("windowed block", lambda: block(image))
    return bench.rows


@torch.no_grad()
def cmd_winvar(bench, batch=1, cfg=None, dtype=torch.bfloat16):
    cfg = cfg or SamEncoderConfig.preset("vit_h")
    x, block = _window_operands(bench, batch, cfg, dtype)
    attn, c, w, nh = block.attn, cfg.embed_dim, cfg.window_size, cfg.num_heads
    bw, l, _ = x.shape
    qkv = attn.qkv(x)
    q3, kv3 = qkv[..., :c].contiguous(), qkv[..., c:].contiguous()
    q, k, v = (sa.head_view(qkv, 3, i, nh).contiguous() for i in range(3))
    rel = (attn.rel_pos_h, attn.rel_pos_w, (w, w))
    print(f"winvar: batch {batch}, {bw} windows of {w} x {w}, {nh} heads x "
          f"{c // nh}, {dtype}; one kernel, three operand layouts")
    outs = [sa.sam_window_attention_qkv_split(q3, kv3, *rel, nh),
            sa.sam_window_attention_qkv(qkv, *rel, nh),
            sa.sam_window_attention(q, k, v, *rel).reshape(bw, l, c)]
    if not (torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])):
        raise AssertionError("winvar: the three entries disagree")
    ops = 4 * bw * l * l * c
    bench.row("split (q3, kv3)", lambda: sa.sam_window_attention_qkv_split(
        q3, kv3, *rel, nh), ops)
    bench.row("fused (qkv)", lambda: sa.sam_window_attention_qkv(
        qkv, *rel, nh), ops)
    bench.row("per-head (q, k, v)", lambda: sa.sam_window_attention(
        q, k, v, *rel), ops)
    return bench.rows


@torch.no_grad()
def cmd_attnpath(bench, batch=1, cfg=None, dtype=torch.bfloat16):
    cfg = cfg or SamEncoderConfig.preset("vit_h")
    x, block = _window_operands(bench, batch, cfg, dtype)
    attn, c, w, nh = block.attn, cfg.embed_dim, cfg.window_size, cfg.num_heads
    bw, l, _ = x.shape
    rel = (attn.rel_pos_h, attn.rel_pos_w, (w, w), nh)

    def path_fused():
        return sa.sam_window_attention_qkv(attn.qkv(x), *rel)

    def path_split():
        q3, kv3 = attn.qkv(x.reshape(bw * l, c), out_split=(c, 2 * c))
        return sa.sam_window_attention_qkv_split(
            q3.reshape(bw, l, c), kv3.reshape(bw, l, 2 * c), *rel)

    print(f"attnpath: batch {batch}, {bw} windows of {w} x {w}, {dtype}; "
          "projection + attention")
    bench.row("path-fused", path_fused)
    bench.row("path-split", path_split)
    return bench.rows


@torch.no_grad()
def cmd_int8probe(bench, shape=(2048, 2048, 2048)):
    m, k, n = shape
    g = torch.Generator(bench.dev).manual_seed(0)
    a8, b8 = (torch.randint(-127, 128, s, generator=g, device=bench.dev,
                            dtype=torch.int8) for s in ((m, k), (n, k)))
    a16, b16 = bench.randn(m, k, seed=1), bench.randn(n, k, seed=2)
    if not torch.equal(matmul_probe(a8, b8), matmul_probe_plain(a8, b8)):
        raise AssertionError("int8probe: the int8 product is not exact")
    torch.testing.assert_close(matmul_probe(a16, b16),
                               matmul_probe_plain(a16, b16), rtol=1e-4,
                               atol=1e-3 * k ** 0.5)
    print(f"int8probe: ({m}, {k}) @ ({n}, {k})^T, one tensor-core structure")
    ops = 2 * m * n * k
    t16 = bench.row("probe bf16 (wgmma)", lambda: matmul_probe(a16, b16), ops)
    t8 = bench.row("probe int8 (wgmma)", lambda: matmul_probe(a8, b8), ops)
    l16 = bench.row("torch.matmul bf16", lambda: a16 @ b16.T, ops)
    ratio = f"int8 / bf16 rate at equal structure: {t16 / t8:.2f}x"
    if bench.dev.type == "cuda":
        l8 = bench.row("torch._int_mm", lambda: torch._int_mm(a8, b8.T), ops)
        ratio += f"; the library's: {l16 / l8:.2f}x"
    print(ratio)
    return bench.rows


@torch.no_grad()
def cmd_w8a8(bench, shape=(9800, 1280, 3840)):
    """Default: the SAM ViT-H windowed qkv projection at batch 2."""
    m, k, n = shape
    x = bench.randn(m, k, scale=0.5)
    w = bench.randn(n, k, scale=k ** -0.5, dtype=torch.float32, seed=1)
    q, sw = quant.quantize_kernel(w)
    xq, sx = quant.quantize_activation(x)
    sx = sx[:, 0].contiguous()
    bf = torch.bfloat16
    run = quant.int8_matmul_kernel if x.is_cuda else quant.int8_matmul_plain
    if not torch.equal(run(xq, q, sx, sw, torch.float32),
                       quant.int8_matmul_plain(xq, q, sx, sw, torch.float32)):
        raise AssertionError("w8a8: float32 output differs from the exact one")
    print(f"w8a8: x ({m}, {k}) @ w ({n}, {k})^T int8 -> bf16")
    ops = 2 * m * n * k
    bench.row("w8a8 kernel", lambda: run(xq, q, sx, sw, bf), ops)
    bench.row("quantize + kernel", lambda: quant.int8_matmul(x, q, sw), ops)
    bench.row("plain (float64)", lambda: quant.int8_matmul_plain(
        xq, q, sx, sw, bf), ops)
    if x.is_cuda and m >= 32 and n % 8 == 0:
        bench.row("torch._int_mm + rescale", lambda: (
            torch._int_mm(xq, q.T).float() * sx[:, None] * sw).to(bf), ops)
    wb = w.to(bf)
    bench.row("torch.matmul bf16", lambda: x @ wb.T, ops)
    return bench.rows


@torch.no_grad()
def cmd_w4a16(bench, shape=(2, 4096, 11008), group=64):
    """Default: the widest LLaMA-7B layer at the decode batch of 2."""
    m, k, n = shape
    bf = torch.bfloat16
    w = bench.randn(n, k, scale=k ** -0.5, dtype=torch.float32, seed=1)
    packed, sc = quant.quantize_kernel_int4(w, group)
    x = bench.randn(m, k)
    run = quant.int4_matmul_kernel if x.is_cuda else quant.int4_matmul_plain
    wd = quant.dequantize_kernel_int4(packed, sc, group, bf).float()
    torch.testing.assert_close(run(x, packed, sc, group, bf).float(),
                               x.float() @ wd.T, rtol=2.0 ** -7, atol=1e-3)
    print(f"w4a16: x ({m}, {k}) bf16 @ packed ({n}, {k // 2}) uint8, "
          f"group {group}")
    ops = 2 * m * n * k
    bench.row("w4a16 kernel", lambda: run(x, packed, sc, group, bf), ops)
    bench.row("plain", lambda: quant.int4_matmul_plain(x, packed, sc, group,
                                                       bf), ops)
    bench.row("dequantize + matmul", lambda: quant.int4_matmul_dequant(
        x, packed, sc, group, bf), ops)
    wb = w.to(bf)
    bench.row("torch.matmul bf16", lambda: x @ wb.T, ops)
    return bench.rows


COMMANDS = {"winprof": cmd_winprof, "winvar": cmd_winvar,
            "attnpath": cmd_attnpath, "int8probe": cmd_int8probe,
            "w8a8": cmd_w8a8, "w4a16": cmd_w4a16}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Kernel micro-benchmarks of haff_tpu_torch on the card.")
    ap.add_argument("cmd", choices=sorted(COMMANDS))
    ap.add_argument("--batch", type=int, default=1,
                    help="images (winprof, winvar, attnpath)")
    ap.add_argument("--shape", type=int, nargs=3, metavar=("M", "K", "N"),
                    help="product shape (int8probe, w8a8, w4a16)")
    ap.add_argument("--sam", default="vit_h",
                    help="SamEncoderConfig preset of the window commands")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (rehearsal, plain versions)")
    args = ap.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("bench_kernels: no CUDA device (pass --device cpu to rehearse "
              "with the plain versions)", file=sys.stderr)
        return 2
    bench = Bench(args.device, args.iters)
    if args.cmd in ("winprof", "winvar", "attnpath"):
        dtype = torch.bfloat16 if bench.dev.type == "cuda" else torch.float32
        COMMANDS[args.cmd](bench, args.batch,
                           SamEncoderConfig.preset(args.sam), dtype)
    elif args.shape:
        COMMANDS[args.cmd](bench, tuple(args.shape))
    else:
        COMMANDS[args.cmd](bench)
    return 0


if __name__ == "__main__":
    sys.exit(main())
