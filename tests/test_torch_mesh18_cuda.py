"""Pipeline and row-parallel W8A8 roles on the card: 2 gloo ranks sharing
cuda:0 (tests/torch_mesh_workers.py `case_gpipe`, `case_amax`; CUDA
tensors staged through host memory). Skipped without a CUDA device; on
the card:

    python -m pytest -m cuda --noconftest tests/test_torch_mesh18_cuda.py

* The pipe hand-offs with CUDA tensors: a 4-layer LLaMA (float32: the
  comparison is of the hand-offs, not of bf16 rounding at two batch
  sizes) pipelined over pipe 2, 2 microbatches, forward and the
  gradients of mean(logits^2): logits, hidden and the embeddings'
  gradient within 1e-4 of the largest magnitude (+1e-6) of the same
  model on one process on the card; each stage launches the flash
  forward microbatches x its 2 layers x 2 (remat) times and each
  backward kernel microbatches x 2 times.
* The row-parallel W8A8 product (K = 4096 over 2 ranks, M = 16, a float32
  output): the kernel's partial products, summed, within 1e-5 relative
  of the one-process plain W8A8 with the whole row's amax; one launch a
  rank in the row-parallel role, one global-amax all-reduce.
"""

import dataclasses

import pytest
import torch

from torch_mesh_workers import run_ranks

pytestmark = pytest.mark.cuda


def _skip_without_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python -m pytest "
                    "-m cuda --noconftest tests/test_torch_mesh18_cuda.py)")


def _close(got, ref):
    err = float((got - ref).abs().max())
    assert torch.isfinite(got).all()
    assert err <= 1e-4 * float(ref.abs().max()) + 1e-6, err


def test_pipeline_hands_cuda_tensors_stage_to_stage(tmp_path):
    _skip_without_card()
    from haff_tpu_torch.core.config import LlamaConfig
    from haff_tpu_torch.kernels import _build
    from haff_tpu_torch.nn.llama import LlamaForCausalLM

    _build.build_all(("flash_prefill", "flash_bwd"))  # once, for both ranks
    cfg = LlamaConfig(vocab_size=256, hidden_size=256, intermediate_size=512,
                      num_layers=4, num_heads=2, num_kv_heads=2, head_dim=128,
                      max_seq_len=256, lora_rank=2)
    torch.manual_seed(0)
    model = LlamaForCausalLM(cfg)
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    gen = torch.Generator().manual_seed(1)
    b, l = 4, 128
    emb = torch.randn((b, l, cfg.hidden_size), generator=gen) * 0.5
    pos = torch.arange(l)[None].expand(b, l).contiguous()
    seg = torch.ones((b, l), dtype=torch.int32)
    seg[1, 100:] = 0
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    got = run_ranks("gpipe", dict(kind="llama", cfg=fields, sd=sd,
                                  embeds=emb, pos=pos, seg=seg,
                                  meshes=[(("pp", 2),)], grad=True,
                                  microbatches=2, device="cuda"), 2,
                    tmp_path)
    model = model.cuda()
    e = emb.cuda().requires_grad_(True)
    logits, hidden, _ = model(e, pos.cuda(), seg.cuda())
    logits.float().square().mean().backward()
    for r, (res,) in enumerate(got):
        assert res["device"] == "cuda:0", r
        _close(res["logits"], logits.detach().cpu())
        _close(res["hidden"], hidden.detach().cpu())
        _close(res["d_embeds"], e.grad.cpu())
        got = {k: res["launches"].get(k) for k in (
            "flash_prefill_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
        assert got == {"flash_prefill_fwd": 2 * 2 * 2, "flash_bwd_dq": 2 * 2,
                       "flash_bwd_dkv": 2 * 2}, res["launches"]


def test_row_parallel_w8a8_kernel_with_the_global_amax(tmp_path):
    _skip_without_card()
    from haff_tpu_torch.kernels import _build
    from haff_tpu_torch.nn import quant

    _build.build_all(("w8a8_matmul",))
    gen = torch.Generator().manual_seed(2)
    x = torch.randn((16, 4096), generator=gen)
    x[:, 3000:3010] *= 30.0   # the rows' amax in rank 1's slice
    w = torch.randn((1024, 4096), generator=gen)
    q, scale = quant.quantize_kernel(w)
    got = run_ranks("amax", dict(x=x, q=q, scale=scale, device="cuda"), 2,
                    tmp_path)
    xq = quant.quantize_activation(x)
    want = quant.int8_matmul_plain(xq.values, q, xq.scales[:, 0], scale,
                                   torch.float32)
    for r, res in enumerate(got):
        err = (res["global_"].float() - want).abs().max()
        assert err <= 1e-5 * want.abs().max(), (r, float(err))
        assert res["reduces"] == 2, r
        assert res["launches"]["w8a8_matmul/row_parallel"] == 1, r
