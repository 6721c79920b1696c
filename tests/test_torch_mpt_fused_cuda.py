"""The MPT decode step's fused kernels on the card, against their plain
versions. Skipped where there is no CUDA device; on the chip:

    python -m pytest -m cuda tests/test_torch_mpt_fused_cuda.py

* csrc/add_layer_norm.cu at MPT-7B's width (and a ragged one): the new
  residual bit for bit torch's add, the normalized row within one bf16
  ulp of the plain version (float32: 1e-5);
* csrc/decode_attn.cu's write variant at MPT-7B's widths (32 heads of
  128, 607 slots) and multi-query: the written cache byte for byte
  `write_kv_cache`'s, the attention within the decode kernel's tolerance
  of the split emulation and equal to the unfused kernel over the
  written cache, bit for bit;
* MptBlock.forward on a decode step (the pipelined decode's call) on the
  fused attention, against the same block on the CPU;
* a graphed MPT decode at MPT-7B's widths (two blocks, bf16) equal to
  the eager fused one, bit for bit, and the launches a replay counts:
  the fused kernels for a bf16 cache, the unfused path's for an int8
  cache and for qk_ln;
* the write variant's split counters: never made inside a capture, and
  two GraphedEvaluate buckets captured in turn and replayed out of order
  giving evaluate_fn's tokens.
"""

import collections
import dataclasses

import pytest
import torch

from haff_tpu_torch.kernels import _build
from haff_tpu_torch.kernels import add_layer_norm as aln
from haff_tpu_torch.kernels import decode_attention as da
from haff_tpu_torch.nn import mpt
from haff_tpu_torch.nn.layers import LayerNorm
from haff_tpu_torch.nn.llama import write_kv_cache

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python -m pytest "
                    "-m cuda tests/test_torch_mpt_fused_cuda.py)")
    return torch.device("cuda")


def _launched(fn, *args):
    before = collections.Counter(_build.LAUNCHES)
    out = fn(*args)
    torch.cuda.synchronize()
    after = collections.Counter(_build.LAUNCHES)
    after.subtract(before)
    return out, +after


def _within_one_bf16_ulp(got, ref):
    """|got - ref| <= one bf16 ulp at the larger magnitude of the two."""
    mag = torch.maximum(got.float().abs(), ref.float().abs()).clamp_min(2 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    err = (got.float() - ref.float()).abs()
    assert (err <= ulp).all(), float((err / ulp).max())


@pytest.mark.parametrize("with_delta", [True, False])
@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("dtype,w_dtype", [
    (torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32),
    (torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("d", [4096, 100])
def test_add_layer_norm_kernel_matches_plain(dev, with_delta, b, dtype,
                                             w_dtype, d):
    g = torch.Generator(dev).manual_seed(d + b)
    x = (3 * torch.randn(b, 1, d, generator=g, device=dev)).to(dtype)
    delta = (torch.randn(b, 1, d, generator=g, device=dev).to(dtype)
             if with_delta else None)
    w = (1 + 0.2 * torch.randn(d, generator=g, device=dev)).to(w_dtype)
    (res, y), n = _launched(aln.add_layer_norm_kernel, x, delta, w, 1e-5)
    assert n == {"add_layer_norm": 1}
    ref_res, ref_y = aln.add_layer_norm_plain(x, delta, w, 1e-5)
    assert torch.equal(res, ref_res)  # the residual: torch's add, bit for bit
    if not with_delta:
        assert res is x
    assert y.dtype == dtype and y.shape == x.shape
    if dtype == torch.bfloat16:
        _within_one_bf16_ulp(y, ref_y)
    else:
        torch.testing.assert_close(y, ref_y, rtol=1e-5, atol=1e-5)


def _close(got, ref):
    """tests/test_torch_kernels_cuda.py's decode tolerance."""
    tol = ((1e-3, 2.0 ** -7) if got.dtype == torch.bfloat16
           else (1e-4, 1e-4))
    err = (got.float() - ref.float()).abs()
    assert torch.isfinite(got.float()).all()
    assert (err <= tol[0] + tol[1] * ref.float().abs()).all(), float(err.max())


@pytest.mark.parametrize("alibi", [True, False])
@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("dtype,cache_dtype", [
    (torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32),
    (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize("nh,nkv,lmax", [(32, 32, 607), (32, 1, 607),
                                         (8, 8, 20)])
def test_write_attention_kernel_matches_plain(dev, alibi, b, dtype,
                                              cache_dtype, nh, nkv, lmax):
    """Row 0's new token at the last slot, row 1's at slot 300 with the
    splits after it dead; (8, 8, 20) is one split (no merge)."""
    g = torch.Generator(dev).manual_seed(nh + nkv + lmax + b)
    hd = 128
    qkv = (0.5 * torch.randn(b, (nh + 2 * nkv) * hd, generator=g,
                             device=dev)).to(dtype)
    kc, vc = ((0.5 * torch.randn(b, lmax, nkv, hd, generator=g, device=dev)
               ).to(cache_dtype) for _ in range(2))
    ref_k, ref_v = kc.clone(), vc.clone()
    index = torch.tensor([lmax - 1, min(300, lmax // 2)][:b], device=dev)
    mask = (torch.arange(lmax, device=dev)[None] <= index[:, None]).int()
    slopes = mpt.alibi_slopes(nh, device=dev) if alibi else None
    got, n = _launched(da.decode_write_attention_kernel, qkv, kc, vc, mask,
                       index, nh, hd ** -0.5, slopes)
    assert n == {"decode_attn/write": 1}
    q, k, v = qkv.split((nh * hd, nkv * hd, nkv * hd), dim=-1)
    write_kv_cache((ref_k, ref_v), k.reshape(b, 1, nkv, hd),
                   v.reshape(b, 1, nkv, hd), index)
    assert torch.equal(kc, ref_k) and torch.equal(vc, ref_v)
    assert got.dtype == dtype and got.shape == (b, nh, hd)
    _close(got, da.decode_attention_split(q.reshape(b, nh, hd).float(), ref_k,
                                          ref_v, mask, hd ** -0.5,
                                          slopes=slopes))
    unfused = da.decode_attention_kernel(q.reshape(b, nh, hd).contiguous(),
                                         ref_k, ref_v, mask, hd ** -0.5,
                                         slopes=slopes)
    torch.cuda.synchronize()
    assert torch.equal(got, unfused)


def test_block_forward_takes_the_fused_attention(dev):
    """MptBlock.forward on a decode step, as parallel/pipeline.py calls it
    block by block (float32, 4 heads of 128): one fused attention launch
    and the unfused norms; the output and the cache within 1e-4 of the
    same block's on the CPU (the products differ in their last bits), the
    written slots equal to the card's own Wqkv output."""
    cfg = mpt.MptConfig(d_model=512, n_heads=4, n_layers=1, vocab_size=64)
    torch.manual_seed(5)
    cpu = mpt.MptBlock(cfg).eval()
    with torch.no_grad():
        for name, p in cpu.named_parameters():
            p.normal_(1.0 if "norm" in name else 0.0, 0.1 if "norm" in name
                      else 0.05)
    gpu = mpt.MptBlock(cfg).to(dev).eval()
    gpu.load_state_dict(cpu.state_dict())
    g = torch.Generator().manual_seed(6)
    x = torch.randn(2, 1, cfg.d_model, generator=g)
    cache = [torch.randn(2, 40, cfg.n_heads, cfg.head_dim, generator=g)
             for _ in range(2)]
    index = torch.tensor([17, 39])
    mask = (torch.arange(40)[None] <= index[:, None]).int()
    slopes = mpt.alibi_slopes(cfg.n_heads)
    with torch.no_grad():
        ref_cache = [c.clone() for c in cache]
        ref, _ = cpu(x, slopes, None, ref_cache, index, mask)
        got_cache = [c.to(dev) for c in cache]
        (got, _), n = _launched(gpu, x.to(dev), slopes.to(dev), None,
                                got_cache, index.to(dev), mask.to(dev))
    assert n == {"decode_attn/write": 1}
    torch.testing.assert_close(got.cpu(), ref, rtol=1e-4, atol=1e-4)
    for c, r in zip(got_cache, ref_cache):
        torch.testing.assert_close(c.cpu(), r, rtol=1e-4, atol=1e-4)
    # The written slots hold the card's own Wqkv output, bit for bit.
    with torch.no_grad():
        fused = gpu.attn.Wqkv(gpu.norm_1(x.to(dev)).float())[:, 0]
    d, rows = cfg.d_model, torch.arange(2, device=dev)
    for c, new in zip(got_cache, (fused[:, d:2 * d], fused[:, 2 * d:])):
        assert torch.equal(c[rows, index.to(dev)].reshape(2, -1), new)


def _mpt_7b_wide(dev, layers=2, vocab=1024):
    """MPT-7B's block at its widths, `layers` of them, seeded, bf16."""
    cfg = dataclasses.replace(mpt.MptConfig(), n_layers=layers,
                              vocab_size=vocab)
    with torch.device(dev):
        model = mpt.MptForCausalLM(cfg)
    g = torch.Generator(dev).manual_seed(3)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "norm" in name:
                p.copy_(1 + 0.1 * torch.randn(p.shape, generator=g, device=dev))
            else:
                p.copy_(0.02 * torch.randn(p.shape, generator=g, device=dev))
    return model.to(torch.bfloat16).eval()


def test_graphed_mpt_decode_equals_eager_fused(dev):
    with torch.inference_mode():
        _graphed_equals_eager(dev)


def _graphed_equals_eager(dev):
    from haff_tpu_torch.infer.generate import DecodeState, decode_loop, prefill

    model = _mpt_7b_wide(dev)
    b, p, steps, layers = 2, 64, 8, model.cfg.n_layers
    g = torch.Generator(dev).manual_seed(4)
    embeds = torch.randn(b, p, model.cfg.d_model, generator=g,
                         device=dev).bfloat16()
    pos = torch.arange(p, device=dev)[None].expand(b, p)
    seg = torch.ones(b, p, dtype=torch.int32, device=dev)
    seg[1, 40:] = 0

    def start(state):
        prefill(state, model, embeds, pos, seg, seg.sum(1))

    def loop(state):
        decode_loop(state, model.embed, model, steps, eos_id=-1)

    eager = DecodeState(model.cfg, b, p, steps, dev)
    start(eager)
    _, n_eager = _launched(loop, eager)
    graphed = DecodeState(model.cfg, b, p, steps, dev)
    start(graphed)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        loop(graphed)  # the warm-up
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        loop(graphed)
    graphed.reset_caches()
    start(graphed)
    graph.replay()
    torch.cuda.synchronize()
    forwards = steps - 1
    assert n_eager["add_layer_norm"] == forwards * (2 * layers + 1)
    assert n_eager["decode_attn/write"] == forwards * layers
    assert "decode_attn" not in n_eager
    assert torch.equal(graphed.tokens, eager.tokens)
    assert torch.equal(graphed.hiddens, eager.hiddens)
    for pair_g, pair_e in zip(graphed.caches, eager.caches):
        for c_g, c_e in zip(pair_g, pair_e):
            assert torch.equal(c_g, c_e)


def _tiny_requests(cfg, rng, n=12):
    import numpy as np

    ids = rng.randint(5, 400, (2, n))
    ids[:, 2] = -200
    att = np.ones((2, n), np.int64)
    att[1, n - 4:] = 0
    S, C = cfg.sam_encoder.image_size, cfg.clip.image_size
    return (rng.randn(2, S, S, 3).astype(np.float32),
            rng.randn(2, C, C, 3).astype(np.float32), ids, att)


@pytest.mark.parametrize("kind", ["bf16", "int8", "qk_ln"])
def test_decode_launches_fused_and_fallbacks(dev, kind):
    """GraphedEvaluate.decode_launches() of the tiny LISA with the MPT
    decoder (2 blocks, 6 new tokens: 5 forwards a replay): with its bf16
    cache 5 add-norms and 2 fused attentions a forward and no unfused
    decode_attn; with an int8 cache, or with qk_ln, the unfused path's
    decode_attn (ALiBi) in every block and no fused launch."""
    import numpy as np

    from haff_tpu_torch.core.config import ModelConfig
    from haff_tpu_torch.infer.evaluate import make_jitted_evaluate
    from haff_tpu_torch.model.lisa import LisaModel

    cfg = ModelConfig.preset("tiny").replace(decoder="mpt")
    model = LisaModel(cfg, torch.float32, device=dev)
    if kind == "qk_ln":
        llm = model.llm
        llm.cfg = dataclasses.replace(llm.cfg, qk_ln=True)
        for block in llm.blocks:
            block.attn.cfg = llm.cfg
            for name in ("q_ln", "k_ln"):
                setattr(block.attn, name, LayerNorm(
                    llm.cfg.d_model, llm.cfg.layer_norm_eps).to(dev))
    graphed = make_jitted_evaluate(model, 6, 2, kv_cache_8bit=kind == "int8")
    req = _tiny_requests(cfg, np.random.RandomState(2))
    first = graphed(*req).output_ids.clone()  # the capture
    assert torch.equal(graphed(*req).output_ids, first)  # a replay
    assert (graphed.captures, graphed.replays) == (1, 1)
    (launches,) = graphed.decode_launches().values()
    forwards, layers = 5, model.llm.cfg.n_layers
    if kind == "bf16":
        assert launches["add_layer_norm"] == forwards * (2 * layers + 1)
        assert launches["decode_attn/write"] == forwards * layers
        assert "decode_attn" not in launches
    else:
        assert launches["decode_attn"] == forwards * layers
        assert launches["decode_attn/alibi"] == forwards * layers
        assert "add_layer_norm" not in launches
        assert "decode_attn/write" not in launches


def test_split_counters_are_never_made_inside_a_capture(dev, monkeypatch):
    """The write variant's split counters must start at zero, and a zero
    fill inside a capture runs only in that graph: with none made yet, a
    launch under capture raises instead of making them there."""
    monkeypatch.setattr(da, "_COUNTERS", {})
    nh, hd, lmax = 32, 128, 607
    assert da.decode_plan(1, nh, nh, lmax)[0] > 1
    qkv = torch.zeros(1, 3 * nh * hd, device=dev, dtype=torch.bfloat16)
    kc, vc = (torch.zeros(1, lmax, nh, hd, device=dev, dtype=torch.bfloat16)
              for _ in range(2))
    mask = torch.ones(1, lmax, dtype=torch.int32, device=dev)
    index = torch.tensor([lmax - 1], device=dev)
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="outside a CUDA graph capture"):
        with torch.cuda.graph(graph):
            da.decode_write_attention_kernel(qkv, kc, vc, mask, index, nh,
                                             hd ** -0.5)
    da.decode_write_attention_kernel(qkv, kc, vc, mask, index, nh, hd ** -0.5)
    (made,) = da._COUNTERS[qkv.device.index]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):  # made eagerly: the capture takes it
        da.decode_write_attention_kernel(qkv, kc, vc, mask, index, nh,
                                         hd ** -0.5)
    assert da._COUNTERS[qkv.device.index] == [made]


def test_two_buckets_replayed_out_of_order(dev):
    """GraphedEvaluate over the tiny LISA with the MPT decoder and its
    bf16 cache: two prompt shapes captured one after the other, then
    replayed second first. Each call's tokens equal evaluate_fn's on the
    card; both buckets' decode splits its slots, so every replay runs the
    split counters, which are zero after each call."""
    import numpy as np

    from haff_tpu_torch.core.config import ModelConfig
    from haff_tpu_torch.infer.evaluate import evaluate_fn, make_jitted_evaluate
    from haff_tpu_torch.model.lisa import LisaModel

    cfg = ModelConfig.preset("tiny").replace(decoder="mpt")
    model = LisaModel(cfg, torch.float32, device=dev)
    llm = model.llm.cfg
    rng = np.random.RandomState(7)
    reqs = [_tiny_requests(cfg, rng, n) for n in (30, 44)]
    with torch.inference_mode():
        want = [evaluate_fn(model, *r, 6, 2).output_ids for r in reqs]
    graphed = make_jitted_evaluate(model, 6, 2)
    for i in (0, 1, 1, 0, 1):
        assert torch.equal(graphed(*reqs[i]).output_ids, want[i]), i
        torch.cuda.synchronize()
        assert not da._COUNTERS[torch.cuda.current_device()][-1].any()
    assert (graphed.captures, graphed.replays) == (2, 3)
    nkv = 1 if llm.multiquery else llm.n_heads
    for state, _, launches in graphed._buckets.values():
        assert da.decode_plan(2, llm.n_heads, nkv, state.max_len)[0] > 1
        assert "decode_attn/write" in launches
