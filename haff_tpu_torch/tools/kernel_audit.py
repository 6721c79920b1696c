"""Kernel numerics audit on the card (port of
haff_tpu/tools/onchip_audit.py): every hand-written kernel of the port
against its plain PyTorch version, through the public entries and at the
shapes the JAX audit uses. Run after any kernel change:

    python -m haff_tpu_torch.tools.kernel_audit            # on the card
    python -m haff_tpu_torch.tools.kernel_audit --device cpu

Prints one PASS/FAIL line a check and exits 1 on a failure. A kernel that
does not build or launch raises: nothing is skipped. On the CPU (only when
asked) every wrapper takes its plain version, so the run rehearses the
script, not the kernels.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..kernels import sam_attention as sa
from ..kernels.decode_attention import (decode_attention_plain,
                                        flash_decode_attention)
from ..kernels.flash_attention import flash_attention, mha_reference
from ..nn import quant


def run_audit(device="cuda") -> list:
    """Run every check on `device`; returns the names that failed."""
    dev = torch.device(device)
    rng = np.random.RandomState(0)
    failures = []

    def rand(*shape, scale=1.0, dtype=torch.float32):
        return torch.as_tensor(rng.randn(*shape).astype(np.float32) * scale,
                               device=dev).to(dtype)

    def check(name, a, b, tol):
        d = float((a.float() - b.float()).abs().max())
        ok = d < tol and bool(torch.isfinite(a.float()).all())
        print(f"{'PASS' if ok else 'FAIL'} {name}: max abs diff {d:.2e}",
              flush=True)
        if not ok:
            failures.append(name)

    # --- flash attention, forward and backward ---
    B, L, H, D = 2, 256, 4, 128
    q, k, v = rand(B, L, H, D, scale=0.3), rand(B, L, H, D, scale=0.3), \
        rand(B, L, H, D)
    seg = torch.ones(B, L, dtype=torch.int32, device=dev)
    seg[0, 200:] = 0
    for name, kw in [("flash/plain", {}), ("flash/causal", dict(causal=True)),
                     ("flash/causal+seg", dict(causal=True, q_segment_ids=seg,
                                               kv_segment_ids=seg))]:
        check(name, flash_attention(q, k, v, **kw),
              mha_reference(q, k, v, **kw), 2e-2)

    def grads(fn):
        ins = [t.detach().requires_grad_() for t in (q, k, v)]
        return torch.autograd.grad(fn(*ins, causal=True).square().sum(), ins)

    for a, b, n in zip(grads(flash_attention), grads(mha_reference), "qkv"):
        check(f"flash/bwd d{n}", a, b, 1e-1)

    # --- legacy per-head SAM global attention ---
    Hs = Ws = 16
    nh, d = 2, 32
    qs, ks, vs = (rand(2, Hs * Ws, nh, d, scale=0.2),
                  rand(2, Hs * Ws, nh, d, scale=0.2), rand(2, Hs * Ws, nh, d))
    rel_h, rel_w = rand(2 * Hs - 1, d, scale=0.2), rand(2 * Ws - 1, d, scale=0.2)
    check("sam_global/fwd",
          sa.sam_global_attention(qs, ks, vs, rel_h, rel_w, (Hs, Ws)),
          sa.relpos_attention_plain(qs, ks, vs, rel_h, rel_w, (Hs, Ws),
                                    d ** -0.5), 5e-3)

    # --- legacy per-head SAM window attention ---
    wh = ww = 14
    qw = rand(4, wh * ww, nh, d, scale=0.2)
    rel_hw = rand(2 * wh - 1, d, scale=0.2)
    check("sam_window/fwd",
          sa.sam_window_attention(qw, qw, qw, rel_hw, rel_hw, (wh, ww)),
          sa.sam_window_attention(qw, qw, qw, rel_hw, rel_hw, (wh, ww),
                                  force_xla=True), 5e-3)

    # --- decode attention over a float and an int8 cache ---
    bd, lmax, nhd, nkvd, hdd = 2, 2048, 8, 4, 128
    qd = rand(bd, nhd, hdd, scale=0.3)
    kd, vd = rand(bd, lmax, nkvd, hdd, scale=0.3), rand(bd, lmax, nkvd, hdd)
    maskd = torch.zeros(bd, lmax, dtype=torch.int32, device=dev)
    maskd[0, :700] = 1
    maskd[1, :2041] = 1
    check("decode/fp", flash_decode_attention(qd, kd, vd, maskd),
          decode_attention_plain(qd, kd, vd, maskd, hdd ** -0.5), 5e-4)
    qk, qv = quant.quantize_activation(kd), quant.quantize_activation(vd)
    check("decode/int8", flash_decode_attention(qd, qk, qv, maskd),
          decode_attention_plain(qd, qk, qv, maskd, hdd ** -0.5), 2e-3)

    # --- fused-qkv window entry, even and odd window counts ---
    for bw in (6, 5):
        qkv = rand(bw, 196, 3 * 1280, scale=0.1, dtype=torch.bfloat16)
        rel14 = rand(27, 80, scale=0.1)
        check(f"sam_window_qkv/bw{bw}",
              sa.sam_window_attention_qkv(qkv, rel14, rel14, (14, 14), 16),
              sa.global_attention_plain(qkv.float(), rel14, rel14, (14, 14),
                                        16, 80 ** -0.5), 5e-2)

    # --- W8A8 product ---
    xm = rand(300, 1280, scale=0.5)
    qm, sm = quant.quantize_kernel(rand(512, 1280, scale=0.02))
    xq, sx = quant.quantize_activation(xm)
    check("w8a8",
          quant.int8_matmul(xm, qm, sm, dtype=torch.bfloat16),
          quant.int8_matmul_plain(xq, qm, sx[:, 0].contiguous(), sm,
                                  torch.float32), 1e-2)
    return failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (plain versions only)")
    args = ap.parse_args(argv)
    if args.device.startswith("cuda"):
        if not torch.cuda.is_available():
            print("kernel_audit: no CUDA device (pass --device cpu to "
                  "rehearse with the plain versions)", file=sys.stderr)
            return 2
        print(f"device: {torch.cuda.get_device_name(0)} (kernels)")
    else:
        print("device: cpu (plain versions)")
    failures = run_audit(args.device)
    if failures:
        print("FAILURES:", failures)
        return 1
    print("all kernels match their plain versions on", args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
