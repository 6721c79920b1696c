"""MoE decoder MLPs on the card. Skipped where there is no CUDA device; on
the chip:

    python -m pytest -m cuda tests/test_torch_moe_cuda.py --noconftest

* The `small` preset with 4 experts, top-2, in every layer, float32: the
  LLaMA forward (pooled training routing with a padded row, and per-row
  serving routing through the flash and decode kernels) and evaluate() on
  the card against the same weights on the CPU: logits within 1e-4,
  identical tokens, masks within 1e-4.
* One MoE decode step captured in a torch.cuda.CUDAGraph and replayed
  equals the eager step bit for bit: the routing never waits for the
  device (capture would raise on a host sync).
"""

import dataclasses

import numpy as np
import pytest
import torch

from haff_tpu_torch.core.config import ModelConfig
from haff_tpu_torch.infer.evaluate import evaluate_fn, make_jitted_evaluate
from haff_tpu_torch.infer.generate import alloc_caches
from haff_tpu_torch.model.lisa import LisaModel

pytestmark = pytest.mark.cuda

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python -m pytest "
                    "-m cuda tests/test_torch_moe_cuda.py --noconftest)")
    return torch.device("cuda")


def _pair(dev):
    base = ModelConfig.preset("small")
    cfg = base.replace(llama=dataclasses.replace(
        base.llama, moe_num_experts=4, moe_top_k=2, moe_every=1))
    gpu = LisaModel(cfg, torch.float32, device=dev,
                    generator=torch.Generator(dev).manual_seed(1))
    cpu = LisaModel(cfg, torch.float32, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    return cfg, gpu, cpu


def test_moe_forward_on_the_card_equals_cpu(dev):
    cfg, gpu, cpu = _pair(dev)
    rng = np.random.RandomState(0)
    ids = torch.from_numpy(rng.randint(5, 400, (2, 80)))
    seg = torch.ones((2, 80), dtype=torch.int32)
    seg[1, 60:] = 0
    pos = torch.arange(80)[None].repeat(2, 1)
    with torch.no_grad():
        outs = []
        for m in (gpu, cpu):
            d = m.device
            logits, _, _, aux = m.llm(m.embed_tokens(ids.to(d)), pos.to(d),
                                      seg.to(d), with_aux=True)
            caches = alloc_caches(cfg.llama, 2, 96, d, torch.float32)
            served, _, _ = m.llm_forward(m.embed_tokens(ids.to(d)), pos.to(d),
                                         seg.to(d), caches,
                                         torch.zeros(2, dtype=torch.long,
                                                     device=d))
            outs.append((logits.cpu(), float(aux), served.cpu()))
    (lg, ag, sg), (lc, ac, sc) = outs
    torch.testing.assert_close(lg, lc, **TOL)
    torch.testing.assert_close(sg, sc, **TOL)
    assert abs(ag - ac) < 1e-5
    S, C = cfg.sam_encoder.image_size, cfg.clip.image_size
    ids = rng.randint(5, 400, (2, 24))
    ids[:, 2] = -200
    att = np.ones((2, 24), np.int64)
    att[1, 20:] = 0
    req = (rng.randn(2, S, S, 3).astype(np.float32),
           rng.randn(2, C, C, 3).astype(np.float32), ids, att)
    ref = evaluate_fn(cpu, *req, 8, 2)
    for got in (evaluate_fn(gpu, *req, 8, 2),
                make_jitted_evaluate(gpu, 8, 2)(*req)):
        assert torch.equal(got.output_ids.cpu(), ref.output_ids)
        assert torch.equal(got.gen_lengths.cpu(), ref.gen_lengths)
        for key in ("pred_masks_left", "pred_masks_right", "taxonomies"):
            torch.testing.assert_close(getattr(got, key).cpu(),
                                       getattr(ref, key), **TOL)


def test_moe_decode_step_captured_in_a_graph_equals_eager(dev):
    cfg, gpu, _ = _pair(dev)
    b, lp, max_len = 2, 16, 32
    g = torch.Generator(dev).manual_seed(3)
    ids = torch.randint(5, 400, (b, lp), device=dev, generator=g)
    pos = torch.arange(lp, device=dev)[None].repeat(b, 1)
    seg = torch.ones((b, lp), dtype=torch.int32, device=dev)
    caches = alloc_caches(cfg.llama, b, max_len, dev, torch.float32)
    lengths = torch.full((b,), lp, dtype=torch.long, device=dev)
    kv_seg = (torch.arange(max_len, device=dev)[None] <= lengths[:, None]
              ).to(torch.int32)
    token = torch.randint(5, 400, (b, 1), device=dev, generator=g)
    with torch.inference_mode():
        gpu.llm_forward(gpu.embed_tokens(ids), pos, seg, caches,
                        torch.zeros(b, dtype=torch.long, device=dev))

        def step():
            logits, hidden, _ = gpu.llm_forward(
                gpu.embed_tokens(token), lengths[:, None], None, caches,
                lengths, kv_seg)
            return logits, hidden

        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            eager = [t.clone() for t in step()]
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            captured = step()
        graph.replay()
        torch.cuda.synchronize()
    for got, want in zip(captured, eager):
        assert torch.equal(got, want)
