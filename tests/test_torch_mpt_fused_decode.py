"""The MPT decode step's fused ops in plain torch, on the CPU: the
versions the card's kernels are held to (csrc/add_layer_norm.cu and the
write variant of csrc/decode_attn.cu) and the restructured step that
calls them (nn/mpt.py `fused_decode_step`, `MptBlock.decode_step`):

* `add_layer_norm_plain` is `x = x + delta; LayerNorm(x).to(x.dtype)`
  with the model's norm, bit for bit;
* `decode_write_attention_split` writes the cache as `write_kv_cache`
  does and attends as `decode_attention_split` over the written cache,
  with and without ALiBi slopes, at batch 1 and 2, bf16 and float32,
  multi-head and multi-query;
* the fused path is chosen from the inputs alone, and a decode step
  through it (the write variant's plain version standing in for the
  kernel) gives the unfused step's tokens and hidden states;
* the write variant's split counters are made and zeroed eagerly, never
  during a CUDA graph capture.

Tiny widths; the kernels themselves are held to these on the card in
tests/test_torch_mpt_fused_cuda.py.
"""

import dataclasses
import types

import pytest
import torch

from haff_tpu_torch.kernels import add_layer_norm as aln
from haff_tpu_torch.kernels import decode_attention as da
from haff_tpu_torch.nn import mpt
from haff_tpu_torch.nn.layers import LayerNorm
from haff_tpu_torch.nn.llama import write_kv_cache
from haff_tpu_torch.nn.quant import QuantArray, quantize_activation


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("with_delta", [True, False])
def test_add_layer_norm_plain_is_add_then_norm(dtype, b, with_delta):
    g = torch.Generator().manual_seed(b)
    d = 64
    norm = LayerNorm(d, 1e-5, bias=False)
    with torch.no_grad():
        norm.weight.copy_(1 + 0.1 * torch.randn(d, generator=g))
    norm = norm.to(dtype)
    x = (3 * torch.randn(b, 1, d, generator=g)).to(dtype)
    delta = torch.randn(b, 1, d, generator=g).to(dtype) if with_delta else None
    res, y = aln.add_layer_norm(x, delta, norm.weight, norm.eps)
    ref_x = x + delta if with_delta else x
    assert res.dtype == y.dtype == dtype
    assert torch.equal(res, ref_x)
    assert torch.equal(y, norm(ref_x).to(dtype))


def _caches(b, lmax, nkv, hd, dtype, g):
    return [(0.5 * torch.randn(b, lmax, nkv, hd, generator=g)).to(dtype)
            for _ in range(2)]


@pytest.mark.parametrize("alibi", [True, False])
@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("dtype,cache_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize("nh,nkv,lmax", [(4, 4, 70), (8, 1, 33)])
def test_write_attention_split_is_write_then_attend(alibi, b, dtype,
                                                    cache_dtype, nh, nkv,
                                                    lmax):
    """Row b's new k/v land at cache_index[b], rounded to the cache's
    dtype, every other slot untouched; the attention over the written
    cache equals write_kv_cache followed by decode_attention_split."""
    g = torch.Generator().manual_seed(nh * lmax + b)
    hd = 16
    qkv = torch.randn(b, (nh + 2 * nkv) * hd, generator=g).to(dtype)
    kc, vc = _caches(b, lmax, nkv, hd, cache_dtype, g)
    orig = kc.clone(), vc.clone()
    ref_k, ref_v = kc.clone(), vc.clone()
    index = torch.tensor([lmax - 1, lmax // 3][:b])
    mask = (torch.arange(lmax)[None] <= index[:, None]).int()
    slopes = mpt.alibi_slopes(nh) if alibi else None
    got = da.decode_write_attention_split(qkv, kc, vc, mask, index, nh,
                                          hd ** -0.5, slopes=slopes)
    q, k, v = qkv.split((nh * hd, nkv * hd, nkv * hd), dim=-1)
    write_kv_cache((ref_k, ref_v), k.reshape(b, 1, nkv, hd),
                   v.reshape(b, 1, nkv, hd), index)
    assert torch.equal(kc, ref_k) and torch.equal(vc, ref_v)
    ref = da.decode_attention_split(q.reshape(b, nh, hd), ref_k, ref_v, mask,
                                    hd ** -0.5, slopes=slopes)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, ref, rtol=0, atol=0)
    # The public entry on the CPU: the same, in qkv's dtype.
    kc2, vc2 = orig[0].clone(), orig[1].clone()
    out = da.decode_write_attention(qkv, kc2, vc2, mask, index, nh,
                                    slopes=slopes)
    assert torch.equal(kc2, ref_k) and torch.equal(vc2, ref_v)
    assert out.dtype == dtype and out.shape == (b, nh, hd)
    assert torch.equal(out, ref.to(dtype))


def test_write_attention_split_outside_the_cache_writes_nothing():
    g = torch.Generator().manual_seed(5)
    b, nh, hd, lmax = 2, 4, 16, 20
    qkv = torch.randn(b, 3 * nh * hd, generator=g)
    kc, vc = _caches(b, lmax, nh, hd, torch.float32, g)
    before = kc.clone(), vc.clone()
    index = torch.tensor([lmax, 3])
    mask = torch.ones(b, lmax, dtype=torch.int32)
    da.decode_write_attention_split(qkv, kc, vc, mask, index, nh, 0.25)
    assert torch.equal(kc[0], before[0][0]) and torch.equal(vc[0], before[1][0])
    assert not torch.equal(kc[1], before[0][1])


def test_split_counters_are_made_eagerly_and_kept(monkeypatch):
    """The write variant's split counters: one zeroed buffer a device,
    reused while large enough, a larger one made beside it (a captured
    graph may still point at the first); none made during a capture."""
    monkeypatch.setattr(da, "_COUNTERS", {})
    dev = torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with pytest.raises(RuntimeError, match="outside a CUDA graph capture"):
        da._split_counters(dev, 8)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    first = da._split_counters(dev, 8)
    assert first.numel() == 1024 and not first.any()
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    assert da._split_counters(dev, 1024) is first
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    grown = da._split_counters(dev, 1025)
    assert grown.numel() == 1025 and not grown.any()
    bufs = da._COUNTERS[dev.index]
    assert len(bufs) == 2 and bufs[0] is first and bufs[1] is grown


def _tensor(shape, cuda=True):
    """Stands in for a tensor in the predicate: its device and shape."""
    return types.SimpleNamespace(is_cuda=cuda, shape=shape)


@pytest.mark.parametrize("case,fused", [
    ("decode", True), ("cpu", False), ("prefill", False), ("int8", False),
    ("qk_ln", False), ("clip_qkv", False), ("no_cache", False),
    ("no_mask", False), ("no_index", False)])
def test_fused_step_is_chosen_from_the_inputs(case, fused):
    cfg = mpt.MptConfig.preset("tiny")
    x = _tensor((2, 5 if case == "prefill" else 1, 64), cuda=case != "cpu")
    cache = (torch.zeros(2, 8, 4, 16, dtype=torch.bfloat16),) * 2
    if case == "int8":
        cache = (quantize_activation(torch.zeros(2, 8, 4, 16)),) * 2
        assert isinstance(cache[0], QuantArray)
    if case in ("qk_ln", "clip_qkv"):
        cfg = dataclasses.replace(cfg, **{case: 1.0 if case == "clip_qkv"
                                          else True})
    args = (cfg, x, None if case == "no_cache" else cache,
            None if case == "no_index" else torch.zeros(2, dtype=torch.long),
            None if case == "no_mask" else torch.ones(2, 8, dtype=torch.int32))
    assert mpt.fused_decode_step(*args) is fused


def _decode(model, monkeypatch, fused: bool, steps: int = 4):
    """Greedy decode of a seeded prompt through the model; with `fused`
    the fused step is taken on the CPU (its ops' plain versions)."""
    from haff_tpu_torch.infer.generate import DecodeState, decode_loop, prefill

    if fused:
        pick = mpt.fused_decode_step
        monkeypatch.setattr(mpt, "fused_decode_step", lambda cfg, x, *a: pick(
            cfg, _tensor(x.shape), *a))
    calls = []
    step = mpt.MptBlock.decode_step
    monkeypatch.setattr(mpt.MptBlock, "decode_step",
                        lambda self, *a: calls.append(1) or step(self, *a))
    g = torch.Generator().manual_seed(7)
    b, p, d = 2, 9, model.cfg.d_model
    embeds = torch.randn(b, p, d, generator=g)
    state = DecodeState(model.cfg, b, p, steps, "cpu",
                        cache_dtype=torch.float32)
    pos = torch.arange(p)[None].expand(b, p)
    seg = torch.ones(b, p, dtype=torch.int32)
    seg[1, 6:] = 0
    prefill(state, model, embeds, pos, seg, seg.sum(1))
    decode_loop(state, model.embed, model, steps, eos_id=-1)
    monkeypatch.undo()
    return state.result(), len(calls)


@pytest.mark.parametrize("multiquery", [False, True])
def test_fused_decode_step_matches_the_unfused_one(monkeypatch, multiquery):
    """Every decode forward takes decode_step in every block (none in the
    prefill), and the tokens and hidden states match the unfused loop's:
    the same ops but for the attention's split order (float32)."""
    torch.manual_seed(0)
    cfg = dataclasses.replace(mpt.MptConfig.preset("tiny"),
                              multiquery=multiquery)
    model = mpt.MptForCausalLM(cfg).eval()
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.normal_(1.0 if "norm" in name else 0.0, 0.1 if "norm" in name
                      else 0.3)
    with torch.no_grad():
        ref, n_ref = _decode(model, monkeypatch, fused=False)
        got, n_got = _decode(model, monkeypatch, fused=True)
    assert n_ref == 0 and n_got == 3 * cfg.n_layers
    assert torch.equal(got.tokens, ref.tokens)
    torch.testing.assert_close(got.hiddens, ref.hiddens, rtol=1e-5, atol=1e-5)


def _seeded_block(cfg, seed):
    torch.manual_seed(seed)
    block = mpt.MptBlock(cfg).eval()
    with torch.no_grad():
        for name, p in block.named_parameters():
            p.normal_(1.0 if "norm" in name else 0.0, 0.1 if "norm" in name
                      else 0.3)
    return block


@pytest.mark.parametrize("multiquery", [False, True])
def test_block_forward_decode_with_the_fused_attention(monkeypatch,
                                                       multiquery):
    """MptBlock.forward on a decode step, as parallel/pipeline.py calls it
    block by block: with the fused attention (its plain version standing
    in for the kernel) the output and the written cache match the unfused
    block's, and decode_step's (x, delta) add up to the same output."""
    cfg = dataclasses.replace(mpt.MptConfig.preset("tiny"),
                              multiquery=multiquery)
    block = _seeded_block(cfg, 1)
    nkv = 1 if multiquery else cfg.n_heads
    g = torch.Generator().manual_seed(2)
    x = torch.randn(2, 1, cfg.d_model, generator=g)
    cache = [torch.randn(2, 12, nkv, cfg.head_dim, generator=g)
             for _ in range(2)]
    index = torch.tensor([5, 9])
    mask = (torch.arange(12)[None] <= index[:, None]).int()
    slopes = mpt.alibi_slopes(cfg.n_heads)
    copies = lambda: [c.clone() for c in cache]  # noqa: E731
    with torch.no_grad():
        ref_cache = copies()
        ref, _ = block(x, slopes, None, ref_cache, index, mask)
        pick = mpt.fused_decode_step
        monkeypatch.setattr(mpt, "fused_decode_step", lambda cfg, x, *a: pick(
            cfg, _tensor(x.shape), *a))
        got_cache = copies()
        got, _ = block(x, slopes, None, got_cache, index, mask)
        step_cache = copies()
        x2, delta = block.decode_step(x, None, slopes, step_cache, index, mask)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(x2 + delta, ref, rtol=1e-5, atol=1e-5)
    for c in (got_cache, step_cache):
        assert all(torch.equal(a, r) for a, r in zip(c, ref_cache))
