"""The port's kernel tools (haff_tpu_torch/tools/kernel_audit.py,
bench_kernels.py, flash_ab.py, w8a8_ab.py, decode_ab.py) rehearsed on
the CPU, where
every wrapper takes its plain version: each audit check passes, each
bench command runs at a small shape and labels its lines as host-clock
rehearsals, the tools ask for the card by default, the A/B tools' cases
and operands are chip_smoke.py's, and the probe's plain version is exact.
"""

import numpy as np
import pytest
import torch

from haff_tpu_torch.core.config import SamEncoderConfig
from haff_tpu_torch.tools import bench_kernels as bk
from haff_tpu_torch.tools import kernel_audit


def test_audit_passes_on_the_cpu(capsys):
    assert kernel_audit.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    lines = [ln for ln in out.splitlines() if ln.startswith(("PASS", "FAIL"))]
    assert len(lines) == 13 and all(ln.startswith("PASS") for ln in lines)
    for name in ("flash/bwd dq", "sam_global/fwd", "sam_window/fwd",
                 "decode/int8", "sam_window_qkv/bw5", "w8a8"):
        assert any(name in ln for ln in lines), name


def test_audit_reports_a_failure(monkeypatch, capsys):
    from haff_tpu_torch.kernels import sam_attention as sa

    real = sa.sam_global_attention
    monkeypatch.setattr(sa, "sam_global_attention",
                        lambda *a, **k: real(*a, **k) + 0.1)
    assert kernel_audit.main(["--device", "cpu"]) == 1
    out = capsys.readouterr().out
    assert "FAIL sam_global/fwd" in out and "FAILURES" in out


@pytest.mark.parametrize("tool", [kernel_audit, bk], ids=["audit", "bench"])
def test_tools_ask_for_the_card_by_default(tool):
    argv = [] if tool is kernel_audit else ["int8probe"]
    if not torch.cuda.is_available():
        assert tool.main(argv) == 2


@pytest.mark.parametrize("cmd", ["winprof", "winvar", "attnpath"])
def test_window_bench_commands_run(cmd, capsys):
    bench = bk.Bench("cpu", iters=1)
    rows = bk.COMMANDS[cmd](bench, 1, SamEncoderConfig.preset("tiny"),
                            torch.float32)
    assert len(rows) >= 2 and all(t > 0 for t in rows.values())
    out = capsys.readouterr().out
    assert out.count("not a device time") == len(rows)


@pytest.mark.parametrize("cmd,shape", [("int8probe", (40, 64, 48)),
                                       ("w8a8", (40, 64, 48)),
                                       ("w4a16", (2, 128, 64))])
def test_product_bench_commands_run(cmd, shape, capsys):
    rows = bk.COMMANDS[cmd](bk.Bench("cpu", iters=1), shape)
    assert len(rows) >= 3
    assert "not a device time" in capsys.readouterr().out


def test_probe_plain_version_is_exact():
    rng = np.random.default_rng(0)
    a = rng.integers(-127, 128, (33, 64), dtype=np.int8)
    b = rng.integers(-127, 128, (17, 64), dtype=np.int8)
    got = bk.matmul_probe(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), a.astype(np.int32) @ b.astype(np.int32).T)
    x = torch.from_numpy(rng.standard_normal((5, 32)).astype(np.float32))
    out = bk.matmul_probe(x.bfloat16(), x.bfloat16())
    assert out.dtype == torch.float32
    torch.testing.assert_close(out, x.bfloat16().float() @ x.bfloat16().float().T)


def test_flash_ab_arguments_and_cases():
    """tools/flash_ab.py: its arguments, its case table (chip_smoke.py's
    phase-3 flash shapes) and the operands it builds, on the CPU; without
    a card it refuses to time."""
    from haff_tpu_torch.tools import flash_ab

    args = flash_ab.parse(["--label", "new", "--iters", "7"])
    assert (args.label, args.iters) == ("new", 7)
    assert (flash_ab.parse([]).label, flash_ab.parse([]).iters) == ("", 20)
    assert [c[0] for c in flash_ab.CASES] == ["flash_prefill_fwd",
                                              "flash_bwd_dq", "flash_bwd_dkv"]
    for case in flash_ab.CASES:
        assert case[1:] == (2, 575, 32, 128, True, (575, 475))
    small = ("flash_bwd_dkv", 2, 9, 2, 16, True, (9, 4))
    q, k, v, do, seg = flash_ab.operands(
        small, torch.Generator().manual_seed(0), device="cpu")
    assert all(t.shape == (2, 9, 2, 16) and t.dtype == torch.bfloat16
               for t in (q, k, v, do))
    assert seg.dtype == torch.int32 and seg.sum(1).tolist() == [9, 4]
    if not torch.cuda.is_available():
        assert flash_ab.main([]) == 2


def test_w8a8_ab_arguments_and_cases():
    """tools/w8a8_ab.py: its arguments, its case table (chip_smoke.py's
    phase-3 w8a8 shapes) and the operands it builds, on the CPU, where
    their product by the plain version is the exact one; without a card
    it refuses to time."""
    from haff_tpu_torch.nn import quant
    from haff_tpu_torch.tools import w8a8_ab

    args = w8a8_ab.parse(["--label", "old", "--iters", "3"])
    assert (args.label, args.iters) == ("old", 3)
    assert (w8a8_ab.parse([]).label, w8a8_ab.parse([]).iters) == ("", 20)
    assert w8a8_ab.CASES == (("prefill", 1150, 4096, 4096),
                             ("decode", 2, 4096, 4096),
                             ("lm_head", 1150, 4096, 32004),
                             ("sam qkv", 9800, 1280, 3840),
                             ("decode gate/up", 2, 4096, 11008),
                             ("decode down", 2, 11008, 4096),
                             ("decode lm_head", 2, 4096, 32004),
                             ("decode M=16", 16, 4096, 4096),
                             ("MPT Wqkv decode", 2, 4096, 12288),
                             ("MPT up decode", 2, 4096, 16384),
                             ("MPT down decode", 2, 16384, 4096))
    xq, q, sx, sw = w8a8_ab.operands(("small", 20, 48, 7),
                                     torch.Generator().manual_seed(0),
                                     device="cpu")
    assert xq.shape == (20, 48) and q.shape == (7, 48)
    assert xq.dtype == q.dtype == torch.int8
    assert sx.shape == (20,) and sw.shape == (7,)
    assert quant.w8a8_path(xq, q) == quant.W8A8_WGMMA
    exact = (xq.int() @ q.int().T).float() * sx[:, None] * sw[None, :]
    assert torch.equal(quant.int8_matmul_plain(xq, q, sx, sw, torch.float32),
                       exact)
    if not torch.cuda.is_available():
        assert w8a8_ab.main([]) == 2


@pytest.mark.parametrize("m,k,n", [(2, 44, 7), (20, 48, 16), (40, 64, 9)])
def test_w8a8_ab_library_is_the_exact_product(m, k, n):
    """tools/w8a8_ab.py's library yardstick: torch._int_mm on operands it
    pads (M to 32, N and K to multiples of 8) + the rescale; its (M, N)
    corner equals the exact product in float32."""
    from haff_tpu_torch.nn import quant
    from haff_tpu_torch.tools import w8a8_ab

    xq, q, sx, sw = w8a8_ab.operands(("small", m, k, n),
                                     torch.Generator().manual_seed(m),
                                     device="cpu")
    out = w8a8_ab.library_fn(xq, q, sx, sw, torch.float32)()
    assert out.shape == (max(32, -(-m // 8) * 8), -(-n // 8) * 8)
    assert torch.equal(out[:m, :n],
                       quant.int8_matmul_plain(xq, q, sx, sw, torch.float32))


def test_w4a16_ab_arguments_and_cases():
    """tools/w4a16_ab.py: its arguments, its case table (chip_smoke.py's
    phase-3 w4a16 shapes) and the operands it builds, on the CPU, where
    the entry point takes the plain version; every bf16 case is on the
    mma path and the float32 one on the scalar kernel; without a card it
    refuses to time."""
    from haff_tpu_torch.nn import quant
    from haff_tpu_torch.tools import w4a16_ab

    args = w4a16_ab.parse(["--label", "old", "--iters", "3"])
    assert (args.label, args.iters) == ("old", 3)
    assert (w4a16_ab.parse([]).label, w4a16_ab.parse([]).iters) == ("", 20)
    assert w4a16_ab.CASES == (("decode", 2, 4096, 4096, "bfloat16"),
                              ("decode gate/up", 2, 4096, 11008, "bfloat16"),
                              ("decode down", 2, 11008, 4096, "bfloat16"),
                              ("decode lm_head", 2, 4096, 32004, "bfloat16"),
                              ("decode M=16", 16, 4096, 4096, "bfloat16"),
                              ("M=256", 256, 4096, 11008, "bfloat16"),
                              ("float32", 2, 4096, 11008, "float32"),
                              ("verify M=16 gate/up", 16, 4096, 11008,
                               "bfloat16"),
                              ("verify M=16 down", 16, 11008, 4096,
                               "bfloat16"),
                              ("verify M=16 lm_head", 16, 4096, 32004,
                               "bfloat16"),
                              ("MPT Wqkv decode", 2, 4096, 12288, "bfloat16"),
                              ("MPT up decode", 2, 4096, 16384, "bfloat16"),
                              ("MPT down decode", 2, 16384, 4096, "bfloat16"))
    for case in w4a16_ab.CASES:
        _, m, k, n, dtype = case
        x, p, s = (torch.empty(r, c, dtype=t, device="meta") for r, c, t in (
            (m, k, getattr(torch, dtype)), (n, k // 2, torch.uint8),
            (n, k // w4a16_ab.GROUP, torch.float32)))
        want = quant.W4A16_MMA if dtype == "bfloat16" else quant.W4A16_SCALAR
        assert quant.w4a16_path(x, p, s, w4a16_ab.GROUP) == want
    x, packed, scale = w4a16_ab.operands(("small", 3, 128, 7, "bfloat16"),
                                         torch.Generator().manual_seed(0),
                                         device="cpu")
    assert x.shape == (3, 128) and x.dtype == torch.bfloat16
    assert packed.shape == (7, 64) and packed.dtype == torch.uint8
    assert scale.shape == (7, 2) and scale.dtype == torch.float32
    wd = quant.dequantize_kernel_int4(packed, scale, w4a16_ab.GROUP,
                                      torch.bfloat16)
    torch.testing.assert_close(
        quant.int4_matmul(x, packed, scale, w4a16_ab.GROUP),
        (x.float() @ wd.float().T).bfloat16())
    if not torch.cuda.is_available():
        assert w4a16_ab.main([]) == 2


def test_decode_ab_arguments_and_cases():
    """tools/decode_ab.py: its arguments, its case table (chip_smoke.py's
    phase-3 decode shapes) and the operands it builds, on the CPU, where
    the decode entry takes the plain version; without a card it refuses
    to time."""
    from haff_tpu_torch.kernels import decode_attention as da
    from haff_tpu_torch.nn import quant
    from haff_tpu_torch.tools import decode_ab

    args = decode_ab.parse(["--label", "new", "--iters", "4"])
    assert (args.label, args.iters) == ("new", 4)
    assert (decode_ab.parse([]).label, decode_ab.parse([]).iters) == ("", 50)
    assert decode_ab.CASES == (("int8", 2, 591, 32, 128, (590, 1)),
                               ("bf16", 2, 591, 32, 128, (590, 1)),
                               ("int8", 2, 591, 32, 128, (590, 590)))
    for kind in ("int8", "bf16"):
        q, k, v, mask = decode_ab.operands((kind, 2, 9, 4, 16, (9, 1)),
                                           torch.Generator().manual_seed(0),
                                           device="cpu")
        assert q.shape == (2, 4, 16) and q.dtype == torch.bfloat16
        assert isinstance(k, quant.QuantArray) == (kind == "int8")
        assert mask.dtype == torch.int32 and mask.sum(1).tolist() == [9, 1]
        out = da.flash_decode_attention(q, k, v, mask)
        assert out.shape == q.shape and torch.isfinite(out.float()).all()
    if not torch.cuda.is_available():
        assert decode_ab.main([]) == 2
