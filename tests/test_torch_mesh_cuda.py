"""Ring attention's CUDA roles on the card: 2 gloo ranks sharing cuda:0
(tests/torch_mesh_workers.py `case_ring_cuda`), sp = 2, causal, bf16,
padded and packed segment ids. Skipped without a CUDA device; on the card:

    python -m pytest -m cuda --noconftest tests/test_torch_mesh_cuda.py

Forward and gradients of sum(out * g * valid) against attention_plain /
attention_bwd_plain on the float32 values (the backward given the ring's
out, as its kernels are), |err| <= 1e-3 + 2^-7 |ref|;
launches: 3 forward (rank 0 its diagonal chunk, rank 1 its past and its
diagonal), as many dq and dk/dv. And the flash kernels' float32 outputs
(the ring's partials) against the plain version.
"""

import pytest
import torch

from torch_mesh_workers import run_ranks

pytestmark = pytest.mark.cuda


def _close(got, ref):
    err = (got.float() - ref.float()).abs()
    assert torch.isfinite(got.float()).all()
    assert bool((err <= 1e-3 + 2.0 ** -7 * ref.float().abs()).all()), \
        float(err.max())


def test_ring_attention_kernels_in_their_ring_roles(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python -m pytest "
                    "-m cuda --noconftest tests/test_torch_mesh_cuda.py)")
    from haff_tpu_torch.kernels import _build
    from haff_tpu_torch.kernels.flash_attention import (attention_bwd_plain,
                                                        attention_plain)

    _build.build_all(("flash_prefill", "flash_bwd"))  # once, for both ranks
    gen = torch.Generator().manual_seed(0)
    b, l, h, d = 2, 512, 4, 64
    q, k, v, g = (torch.randn((b, l, h, d), generator=gen)
                  .to(torch.bfloat16) for _ in range(4))
    seg = torch.zeros((b, l), dtype=torch.int32)
    seg[0, :200], seg[0, 200:480] = 1, 2
    seg[1, :300] = 1
    got = run_ranks("ring_cuda", dict(q=q, k=k, v=v, g=g, seg=seg), 2,
                    tmp_path)
    valid = (seg != 0)[:, :, None, None]
    qf, kf, vf = q.float(), k.float(), v.float()
    out, lse = attention_plain(qf, kf, vf, None, seg, seg, True)
    for r, res in enumerate(got):
        assert res["device"] == "cuda:0"
        _close(res["out"] * valid, out * valid)
        # the plain backward given the ring's out, as the kernels are
        dq, dk, dv = attention_bwd_plain(qf, kf, vf, None, seg, seg,
                                         res["out"].float(), lse,
                                         g.float() * valid, causal=True)
        for name, want in (("dq", dq), ("dk", dk), ("dv", dv)):
            _close(res[name], want)
        n = r + 1
        assert res["launches"] == {"flash_prefill_fwd": n, "flash_bwd_dq": n,
                                   "flash_bwd_dkv": n}, res["launches"]


@pytest.mark.parametrize("d", [128, 80, 32])
def test_kernels_write_float32_partials(d):
    """`out_dtype=torch.float32` (the ring's partials), forward and both
    backward kernels: the same accumulators unrounded, within the bf16
    tolerance of the plain version and no further from it than the bf16
    outputs, on the tensor-core path; the forward's lse unchanged. Head
    dims 80 and 32 run under a wider padded tile (128, 64): the float32
    store must keep to the head's own columns."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python -m pytest "
                    "-m cuda --noconftest tests/test_torch_mesh_cuda.py)")
    from haff_tpu_torch.kernels import flash_attention as fa

    gen = torch.Generator("cuda").manual_seed(1)
    b, l, h = 2, 300, 4
    q, k, v, do = (torch.randn((b, l, h, d), generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    seg = torch.ones((b, l), dtype=torch.int32, device="cuda")
    seg[1, 250:] = 0
    out, lse = fa.flash_prefill_kernel(q, k, v, None, seg, seg, True)
    args = (q, k, v, None, seg, seg, out, lse, do, True)
    assert fa.PATH_NAMES[fa.kernel_path(q, k, v, do)] == "wgmma"
    ref = fa.attention_bwd_plain(q.float(), k.float(), v.float(), None, seg,
                                 seg, out.float(), lse, do.float(), True)
    bf = fa.flash_bwd_kernel(*args)
    f32 = fa.flash_bwd_kernel(*args, out_dtype=torch.float32)
    out32, lse32 = fa.flash_prefill_kernel(q, k, v, None, seg, seg, True,
                                           out_dtype=torch.float32)
    want_out, _ = fa.attention_plain(q.float(), k.float(), v.float(), None,
                                     seg, seg, True)
    assert torch.equal(lse32, lse)
    for got16, got32, want in zip((out, *bf), (out32, *f32),
                                  (want_out, *ref)):
        assert got32.dtype == torch.float32
        _close(got32, want)
        assert float((got32 - want).abs().max()) <= float(
            (got16.float() - want).abs().max())
