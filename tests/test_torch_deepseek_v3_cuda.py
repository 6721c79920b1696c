"""The deepseek_v3 decoder's kernels and graphed decode on the card.
Skipped where there is no CUDA device; on the chip:

    python -m pytest -m cuda tests/test_torch_deepseek_v3_cuda.py --noconftest

* csrc/moe_decode.cu at Moonlight-16B-A3B's widths (64 experts of 1408
  at 2048, top-6, 2 shared) at batch 1, 2, 3 and 8, with rows that share
  experts, against `moe_decode_plain` (float32 products from the bf16
  weights):
  within 2^-7 |ref| + 1e-3 max |ref|, the bf16 rounding of the output
  and float32 sums in another order;
* csrc/mla_decode_attn.cu at Moonlight's widths (16 heads, 512 + 64)
  over ragged rows (one split and several, a row with no live slot),
  against the plain version: the written slot byte for byte, the output
  within the same tolerance;
* the prefill's grouped expert products (`torch._grouped_mm`) against
  the CPU's loop over experts, and the decoder's prefill forward (its
  routing record included) with no host sync, under
  `torch.cuda.set_sync_debug_mode("error")`: at the tiny widths and at
  Moonlight's;
* a graphed decode of the tiny decoder equal to the eager one, bit for
  bit, and the launches a forward counts: one `moe_decode` a MoE layer,
  one `mla_decode_attn/write` a layer, no `decode_attn`;
* GraphedEvaluate of the tiny LISA with the decoder, and of LISA at
  Moonlight's full widths and depth: a replay gives the capture's tokens
  and the eager evaluate's.
"""

import collections

import pytest
import torch

from haff_tpu_torch.kernels import _build
from haff_tpu_torch.kernels import mla_decode_attention as mla
from haff_tpu_torch.kernels import moe_decode as md
from haff_tpu_torch.nn import deepseek_v3 as dsv3

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python -m pytest "
                    "-m cuda tests/test_torch_deepseek_v3_cuda.py)")
    return torch.device("cuda")


def _close(got, ref):
    got, ref = got.float(), ref.float()
    tol = 2 ** -7 * ref.abs() + 1e-3 * ref.abs().max()
    assert bool(((got - ref).abs() <= tol).all()), float((got - ref).abs().max())


def _launched(fn, *args):
    before = collections.Counter(_build.LAUNCHES)
    out = fn(*args)
    torch.cuda.synchronize()
    after = collections.Counter(_build.LAUNCHES)
    after.subtract(before)
    return out, +after


@pytest.mark.parametrize("b,shared", [
    (1, False), (2, True), (3, False), (8, True), (8, False)])
def test_moe_decode_matches_plain(dev, b, shared):
    e, f, d, k = 64, 1408, 2048, 6
    g = torch.Generator(dev).manual_seed(b)
    gate, up = (torch.randn(e, f, d, generator=g, device=dev) / d ** 0.5
                for _ in range(2))
    down = torch.randn(e, d, f, generator=g, device=dev) / f ** 0.5
    gate, up, down = gate.bfloat16(), up.bfloat16(), down.bfloat16()
    x = torch.randn(b, d, generator=g, device=dev).bfloat16()
    if shared:  # every row takes experts 3 and 5, the rest its own
        idx = torch.stack([torch.tensor([3, 5, 10 + r, 20 + r, 30 + r, 40 + r])
                           for r in range(b)]).to(dev)
    else:
        idx = torch.stack([torch.randperm(e, generator=g, device=dev)[:k]
                           for _ in range(b)])
    w = torch.rand(b, k, generator=g, device=dev)
    # Moonlight's 2 shared experts: width 2816
    extra = tuple((torch.randn(*shape, generator=g, device=dev)
                   / shape[1] ** 0.5).bfloat16()
                  for shape in ((2 * f, d), (2 * f, d), (d, 2 * f)))
    got, n = _launched(md.moe_decode, x, idx, w, gate, up, down, extra)
    assert n == {"moe_decode": 1}
    _close(got, md.moe_decode_plain(x, idx, w, gate, up, down, extra))


@pytest.mark.parametrize("b,lmax", [(1, 607), (3, 607), (2, 40), (8, 607)])
def test_mla_write_attention_matches_plain(dev, b, lmax):
    nh, r, p = 16, 512, 64
    g = torch.Generator(dev).manual_seed(lmax + b)
    q = torch.randn(b, nh, r + p, generator=g, device=dev).bfloat16()
    new = torch.randn(b, r + p, generator=g, device=dev).bfloat16()
    cache = torch.randn(b, lmax, r + p, generator=g, device=dev).bfloat16()
    lengths = torch.randint(1, lmax - 1, (b,), generator=g, device=dev)
    if b > 2:
        lengths[2] = 0  # a row with nothing live but its new slot ...
    slots = torch.arange(lmax, device=dev)
    mask = (slots[None] <= lengths[:, None]).int()
    if b > 2:
        mask[2] = 0  # ... and not even that: its output is 0
    ref_cache = cache.clone()
    scale = 192 ** -0.5
    want = mla.mla_decode_write_attention_plain(q, new, ref_cache, mask,
                                                lengths, r, scale)
    got, n = _launched(mla.mla_decode_write_attention, q, new, cache, mask,
                       lengths, r, scale)
    assert n == {"mla_decode_attn/write": 1}
    assert torch.equal(cache, ref_cache)
    _close(got, want)
    if b > 2:
        assert not got[2].any()


def test_grouped_experts_match_the_loop(dev):
    n, k, e, f, d = 300, 6, 64, 64, 128
    g = torch.Generator(dev).manual_seed(3)
    x = torch.randn(n, d, generator=g, device=dev).bfloat16()
    idx = torch.stack([torch.randperm(e, generator=g, device=dev)[:k]
                       for _ in range(n)])
    idx[:40] = torch.arange(k, device=dev)  # crowded experts, empty ones
    w = torch.rand(n, k, generator=g, device=dev)
    gate, up = (torch.randn(e, f, d, generator=g, device=dev).bfloat16() / 11
                for _ in range(2))
    down = torch.randn(e, d, f, generator=g, device=dev).bfloat16() / 8
    got = dsv3.grouped_experts(x, idx, w, gate, up, down)
    want = dsv3.grouped_experts(*(t.cpu() for t in (x, idx, w, gate, up,
                                                     down)))
    _close(got.cpu(), want)


def _no_sync(fn):
    """fn() once as a warm-up, then again with a host sync an error
    (torch.cuda.set_sync_debug_mode); returns the second call's result."""
    fn()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")


def _prefill_without_sync(llm_fn, cfg, embeds, prompt_len):
    """generate.prefill of `embeds` (B, L, d) through `llm_fn` into a
    greedy state with the routing record, under _no_sync (the second of
    two prefills into the one state). Returns the state."""
    from haff_tpu_torch.infer.generate import DecodeState, prefill

    b, l, _ = embeds.shape
    dev = embeds.device
    pos = torch.arange(l, device=dev)[None].expand(b, l)
    seg = (pos < prompt_len).int()
    lengths = seg.sum(1)
    state = DecodeState(cfg, b, l, 4, dev)
    _no_sync(lambda: prefill(state, llm_fn, embeds, pos, seg, lengths))
    return state


@torch.inference_mode()
def test_prefill_needs_no_host_sync(dev):
    """The prefill's grouped expert products at Moonlight's widths (575
    tokens, top-6 of 64 experts of 1408 at 2048), and the tiny decoder's
    prefill with its routing record, issue no host sync."""
    n, k, e, f, d = 575, 6, 64, 1408, 2048
    g = torch.Generator(dev).manual_seed(6)
    x = torch.randn(n, d, generator=g, device=dev).bfloat16()
    idx = torch.rand(n, e, generator=g, device=dev).topk(k, dim=-1).indices
    w = torch.rand(n, k, generator=g, device=dev)
    gate, up = (torch.randn(e, f, d, generator=g, device=dev).bfloat16() / 45
                for _ in range(2))
    down = torch.randn(e, d, f, generator=g, device=dev).bfloat16() / 37
    y = _no_sync(lambda: dsv3.grouped_experts(x, idx, w, gate, up, down))
    assert y.shape == (n, d) and bool(y.isfinite().all())
    del gate, up, down
    model = _tiny_decoder(dev)
    cfg = model.cfg
    embeds = torch.randn(2, 48, cfg.hidden_size, generator=g,
                         device=dev).bfloat16()
    state = _prefill_without_sync(model, cfg, embeds, torch.tensor(
        [[48], [30]], device=dev))
    assert bool((state.prompt_experts[1, :30] >= 0).all())


def _tiny_decoder(dev):
    cfg = dsv3.DeepseekV3Config.preset("tiny")
    model = dsv3.DeepseekV3ForCausalLM(cfg).to(dev)
    g = torch.Generator(dev).manual_seed(0)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(torch.randn(p.shape, generator=g, device=dev) * 0.3
                    + (1.0 if "norm" in name else 0.0))
    return model.bfloat16().eval()


@torch.inference_mode()
def test_graphed_decode_equals_eager(dev):
    from haff_tpu_torch.infer.generate import DecodeState, decode_loop, prefill

    model = _tiny_decoder(dev)
    cfg = model.cfg
    b, p, steps = 2, 48, 8
    g = torch.Generator(dev).manual_seed(4)
    embeds = torch.randn(b, p, cfg.hidden_size, generator=g,
                         device=dev).bfloat16()
    pos = torch.arange(p, device=dev)[None].expand(b, p)
    seg = torch.ones(b, p, dtype=torch.int32, device=dev)
    seg[1, 30:] = 0

    def start(state):
        prefill(state, model, embeds, pos, seg, seg.sum(1))

    def loop(state):
        decode_loop(state, model.embed, model, steps, eos_id=-1)

    eager = DecodeState(cfg, b, p, steps, dev)
    start(eager)
    _, n_eager = _launched(loop, eager)
    graphed = DecodeState(cfg, b, p, steps, dev)
    start(graphed)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        loop(graphed)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        loop(graphed)
    graphed.reset_caches()
    start(graphed)
    graph.replay()
    torch.cuda.synchronize()
    forwards = steps - 1
    assert n_eager["moe_decode"] == forwards * cfg.num_moe_layers
    assert n_eager["mla_decode_attn/write"] == forwards * cfg.num_layers
    assert "decode_attn" not in n_eager and "decode_attn/write" not in n_eager
    assert torch.equal(graphed.tokens, eager.tokens)
    assert torch.equal(graphed.hiddens, eager.hiddens)
    assert torch.equal(graphed.decode_experts, eager.decode_experts)
    assert torch.equal(graphed.prompt_experts, eager.prompt_experts)
    for c_g, c_e in zip(graphed.caches, eager.caches):
        assert torch.equal(c_g, c_e)


@torch.inference_mode()
def test_graphed_lisa_evaluate(dev):
    import numpy as np

    from haff_tpu_torch.infer.evaluate import evaluate_fn, make_jitted_evaluate
    from haff_tpu_torch.model.lisa import LisaModel

    cfg = dsv3.model_config("tiny")
    model = LisaModel(cfg, torch.bfloat16, device=dev)
    rng = np.random.RandomState(2)
    ids = rng.randint(5, 400, (2, 12))
    ids[:, 2] = -200
    att = np.ones((2, 12), np.int64)
    att[1, 8:] = 0
    S, C = cfg.sam_encoder.image_size, cfg.clip.image_size
    req = (rng.randn(2, S, S, 3).astype(np.float32),
           rng.randn(2, C, C, 3).astype(np.float32), ids, att)
    graphed = make_jitted_evaluate(model, 6, 2)
    first = graphed(*req).output_ids.clone()
    again = graphed(*req)
    assert torch.equal(again.output_ids, first)
    assert (graphed.captures, graphed.replays) == (1, 1)
    (launches,) = graphed.decode_launches().values()
    assert launches["moe_decode"] == 5 * cfg.llama.num_moe_layers
    assert launches["mla_decode_attn/write"] == 5 * cfg.llama.num_layers
    eager = evaluate_fn(model, *req, max_new_tokens=6, eos_id=2)
    assert torch.equal(eager.output_ids, first)
    assert torch.equal(eager.pred_masks_left, again.pred_masks_left)


@pytest.fixture(scope="module")
def moonlight():
    """LISA at Moonlight-16B-A3B's full widths and depth (bf16, random
    weights, CLIP-L and SAM-H), shared by the tests below."""
    from haff_tpu_torch.model.lisa import LisaModel

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = dsv3.model_config("moonlight", seg_token_idx=260)
    return cfg, LisaModel(cfg, torch.bfloat16, device=torch.device("cuda"))


@torch.inference_mode()
def test_moonlight_prefill_needs_no_host_sync(moonlight):
    """The Moonlight decoder's prefill of a 575-position prompt (the
    cells' length; one row of two padded to 400), its routing record
    included, issues no host sync."""
    cfg, model = moonlight
    g = torch.Generator("cuda").manual_seed(7)
    embeds = torch.randn(2, 575, cfg.llama.hidden_size, generator=g,
                         device="cuda").bfloat16()
    state = _prefill_without_sync(model.llm_forward, cfg.llama, embeds,
                                  torch.tensor([[575], [400]], device="cuda"))
    assert bool((state.prompt_experts[0] >= 0).all())


@torch.inference_mode()
def test_graphed_moonlight_evaluate_equals_eager(moonlight):
    """At Moonlight-16B-A3B's full widths and depth (bf16, seeded random
    weights, CLIP-L and SAM-H): a replayed decode graph gives the eager
    evaluate's tokens and masks, bit for bit, and its replay launches one
    `moe_decode` a MoE layer and one `mla_decode_attn/write` a layer a
    forward."""
    import numpy as np

    from haff_tpu_torch.infer.evaluate import evaluate_fn, make_jitted_evaluate

    cfg, model = moonlight
    rng = np.random.RandomState(5)
    ids = rng.randint(5, 255, (1, 40))
    ids[:, 3] = -200
    att = np.ones((1, 40), np.int64)
    S, C = cfg.sam_encoder.image_size, cfg.clip.image_size
    req = (rng.randn(1, S, S, 3).astype(np.float32),
           rng.randn(1, C, C, 3).astype(np.float32), ids, att)
    graphed = make_jitted_evaluate(model, 5, 2)
    graphed(*req)
    replayed = graphed(*req)
    (launches,) = graphed.decode_launches().values()
    assert launches["moe_decode"] == 4 * 26
    assert launches["mla_decode_attn/write"] == 4 * 27
    eager = evaluate_fn(model, *req, max_new_tokens=5, eos_id=2)
    assert torch.equal(eager.output_ids, replayed.output_ids)
    assert torch.equal(eager.pred_masks_left, replayed.pred_masks_left)
