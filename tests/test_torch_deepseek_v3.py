"""The deepseek_v3 decoder (nn/deepseek_v3.py) at tiny widths on the CPU
against the plain float32 reference `portbench/reference/deepseek_v3.py`
(the published modeling_deepseek.py's computation, no cache, no
batching) on seeded weights: hidden 64, 4 heads, nope 16, rope 8, v 16,
latent rank 32, 8 experts top-2 with 1 shared, 3 layers, the first dense.

Tolerances (float32 on both sides unless said): 2e-5 relative to the
largest logit where only the order of float32 sums differs (the fused
SDPA against an explicit softmax, grouped expert sums against a loop
over experts, the absorbed attention's W_UK / W_UV products folded
differently); 2e-2 where the decode reads the bfloat16 latent cache that
the port keeps whatever the model's dtype (one bf16 rounding, 2^-9
relative, of every cached value, carried through the later layers).
"""

import numpy as np
import pytest
import torch

from haff_tpu_torch.infer import generate
from haff_tpu_torch.kernels import mla_decode_attention as mla
from haff_tpu_torch.kernels import moe_decode as md
from haff_tpu_torch.nn import deepseek_v3 as dsv3
from portbench.reference import deepseek_v3 as ref

CFG = dsv3.DeepseekV3Config.preset("tiny")
EXACT = 2e-5      # float32 sums in another order
BF16_CACHE = 2e-2  # one bf16 rounding of the latent cache, carried on


def hf(cfg=CFG):
    """The reference's configuration: the published keys."""
    return dict(num_attention_heads=cfg.num_heads,
                qk_nope_head_dim=cfg.qk_nope_head_dim,
                qk_rope_head_dim=cfg.qk_rope_head_dim,
                v_head_dim=cfg.v_head_dim, kv_lora_rank=cfg.kv_lora_rank,
                rms_norm_eps=cfg.rms_norm_eps, rope_theta=cfg.rope_theta,
                num_experts_per_tok=cfg.num_experts_per_tok,
                norm_topk_prob=cfg.norm_topk_prob,
                routed_scaling_factor=cfg.routed_scaling_factor,
                num_hidden_layers=cfg.num_layers,
                first_k_dense_replace=cfg.first_k_dense_replace)


def seeded(model, seed=0, scale=0.3):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(torch.randn(p.shape, generator=g) * scale
                    + (1.0 if "norm" in name else 0.0))
    return model.eval()


@pytest.fixture(scope="module")
def model():
    return seeded(dsv3.DeepseekV3ForCausalLM(CFG))


def weights(m):
    return {n: p.detach() for n, p in m.named_parameters()}


def rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def embeds(length, seed=1, batch=1):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(batch, length, CFG.hidden_size, generator=g)


@torch.inference_mode()
@pytest.mark.parametrize("length", [7, 80])
def test_full_forward_logits(model, length):
    x = embeds(length)
    logits, hidden, caches = model(x, torch.arange(length)[None])
    want = ref.forward(x[0], weights(model), hf(), prefix="")
    assert caches is None
    assert rel(logits[0], want["logits"]) < EXACT
    assert rel(hidden[0], want["hidden"]) < EXACT


def _generate(model, x, steps, cache_dtype, lengths=None):
    b, l, _ = x.shape
    lengths = torch.full((b,), l) if lengths is None else lengths
    seg = (torch.arange(l)[None] < lengths[:, None]).int()
    pos = (torch.cumsum(seg, 1) - 1).clamp(min=0)
    return generate.greedy_generate(CFG, model.embed, model, x, pos, seg,
                                    lengths, steps, eos_id=-1,
                                    cache_dtype=cache_dtype)


@torch.inference_mode()
@pytest.mark.parametrize("cache_dtype,tol", [(torch.float32, EXACT),
                                             (torch.bfloat16, BF16_CACHE)])
def test_prefill_then_decode_matches_reference(model, cache_dtype, tol):
    """Prefill 70 positions, then 6 steps through the latent cache (the
    absorbed form): the logits of every step against the reference's one
    forward over the prompt and the fed tokens."""
    x, steps = embeds(70), 6
    res = _generate(model, x, steps, cache_dtype)
    toks = res.tokens[0].long()
    full = torch.cat([x[0], model.embed(toks[:-1])], 0)
    want = ref.forward(full, weights(model), hf(), prefix="")
    got = model.lm_head(res.hiddens[0])
    assert rel(got, want["logits"][69:]) < tol
    assert torch.equal(toks, want["logits"][69:].argmax(-1))


@torch.inference_mode()
def test_ragged_rows_decode_like_single_rows(model):
    """Two right-padded rows of a batch decode as each alone."""
    x = embeds(40, seed=3, batch=2)
    res = _generate(model, x, 5, torch.float32, torch.tensor([40, 29]))
    for r, n in enumerate((40, 29)):
        alone = _generate(model, x[r:r + 1, :n], 5, torch.float32)
        assert torch.equal(res.tokens[r], alone.tokens[0])
        assert rel(res.hiddens[r], alone.hiddens[0]) < EXACT


@torch.inference_mode()
def test_absorbed_equals_plain_attention(model):
    """One MLA layer: the last position through the latent cache in the
    absorbed form equals the plain form's last row."""
    attn = model.layers[1].self_attn
    l = 33
    x = embeds(l, seed=5)
    cis = model.rope_cis(torch.arange(l)[None])
    plain = attn(x, cis)
    cache = torch.zeros(1, l, CFG.latent_dim)
    attn(x[:, :-1], cis[:, :-1], None, cache, torch.zeros(1).long())
    mask = torch.ones(1, l, dtype=torch.int32)
    step = attn(x[:, -1:], cis[:, -1:], None, cache, torch.tensor([l - 1]),
                mask)
    assert rel(step[0, 0], plain[0, -1]) < EXACT
    # the step wrote its latent row where a prefill over all l writes it
    whole = torch.zeros(1, l, CFG.latent_dim)
    attn(x, cis, None, whole, torch.zeros(1).long())
    assert rel(cache, whole) < EXACT


def test_rope_rotates_pairs_as_the_published_layout_does():
    """RoPE on pairs (2i, 2i+1) gives the published view/transpose +
    rotate_half output up to that permutation, so dot products agree."""
    g = torch.Generator().manual_seed(0)
    q, k = torch.randn(2, 1, 9, 1, 8, generator=g)
    pos = torch.arange(9)[None]
    cis = dsv3.DeepseekV3ForCausalLM(CFG).rope_cis(pos)
    a, b = dsv3.rope_pairs(q, cis)[0, :, 0], dsv3.rope_pairs(k, cis)[0, :, 0]
    ra = ref.rope(q[0, :, 0], pos[0], 8, CFG.rope_theta)
    rb = ref.rope(k[0, :, 0], pos[0], 8, CFG.rope_theta)
    perm = torch.cat([torch.arange(0, 8, 2), torch.arange(1, 8, 2)])
    assert torch.allclose(a[:, perm], ra, atol=1e-6)
    assert torch.allclose(a @ b.T, ra @ rb.T, atol=1e-5)


@torch.inference_mode()
def test_router_sigmoid_bias_chooses_only_normalised_and_scaled():
    router = dsv3.Router(CFG)
    with torch.no_grad():
        router.weight.copy_(torch.eye(8, CFG.hidden_size))
        router.e_score_correction_bias.zero_()
        router.e_score_correction_bias[7] = 10.0  # chosen by the bias alone
    x = torch.zeros(1, CFG.hidden_size)
    x[0, :8] = torch.tensor([3.0, 2.0, 1.0, 0.0, -1.0, -2.0, -3.0, -4.0])
    idx, w = router(x)
    assert sorted(idx[0].tolist()) == [0, 7]
    s = torch.sigmoid(x[0, :8])
    picked = s[idx[0]]
    want = picked / (picked.sum() + 1e-20) * CFG.routed_scaling_factor
    assert torch.allclose(w[0], want)
    assert abs(float(w.sum()) - CFG.routed_scaling_factor) < 1e-5
    # the reference's router agrees (choice scores carry the bias)
    W = {"g.gate.weight": router.weight.detach(),
         "g.gate.e_score_correction_bias":
             router.e_score_correction_bias.detach()}
    choice, s_ref = ref.route(x, W, hf(), "g")
    assert torch.equal(torch.topk(choice, 2).indices.sort().values,
                       idx.sort().values)
    assert torch.allclose(s_ref[0], s)


@torch.inference_mode()
def test_no_token_dropped_at_long_lengths(model):
    """200 tokens (> 64), every one routed to the same two experts by
    the bias: each token's output is its own experts' sum, as a loop over
    tokens computes it, with no capacity and nothing on the residual."""
    moe = model.layers[1].mlp
    bias = moe.gate.e_score_correction_bias
    keep = bias.clone()
    bias.zero_()
    bias[[2, 5]] = 100.0
    try:
        x = embeds(200, seed=7)
        y, idx = moe(x, decode=False)
        W = {k[len("layers.1."):]: v for k, v in weights(model).items()
             if k.startswith("layers.1.mlp")}
        want = ref.moe(x[0], W, hf(), "mlp")
    finally:
        bias.copy_(keep)
    assert (idx.sort(-1).values == torch.tensor([2, 5])).all()
    assert rel(y[0], want) < EXACT


@torch.inference_mode()
def test_shared_experts_and_dense_first_layer(model):
    first, moe_layer = model.layers[0], model.layers[1]
    assert not first.is_moe and isinstance(first.mlp, dsv3.SwiGLU)
    assert first.mlp.gate_proj.weight.shape == (CFG.intermediate_size,
                                               CFG.hidden_size)
    shared = moe_layer.mlp.shared_experts
    assert shared.gate_proj.weight.shape == (
        CFG.moe_intermediate_size * CFG.n_shared_experts, CFG.hidden_size)
    assert moe_layer.mlp.gate_proj.shape == (
        CFG.n_routed_experts, CFG.moe_intermediate_size, CFG.hidden_size)
    # the MoE output is the routed sum plus the shared experts' SwiGLU
    x = embeds(9, seed=8)[0]
    y, idx = moe_layer.mlp(x[None], decode=False)
    i, w = moe_layer.mlp.gate(x)
    m = moe_layer.mlp
    weights3 = (shared.gate_proj.weight, shared.up_proj.weight,
                shared.down_proj.weight)
    none = tuple(torch.zeros_like(t) for t in weights3)  # SwiGLU(x) = 0
    routed = md.moe_decode_plain(x, i, w, m.gate_proj, m.up_proj, m.down_proj,
                                 none)
    assert rel(y[0], routed + shared(x)) < EXACT
    assert rel(y[0] - shared(x), routed) < EXACT
    both = md.moe_decode_plain(x, i, w, m.gate_proj, m.up_proj, m.down_proj,
                               weights3)
    assert rel(both, routed + shared(x)) < EXACT
    # the decode path (the kernel's plain version on the CPU, the shared
    # experts in the same call) agrees
    y_dec, _ = moe_layer.mlp(x[:, None], decode=True)
    assert rel(y_dec[:, 0], y[0]) < EXACT


def test_moe_decode_plain_is_the_per_row_sum():
    g = torch.Generator().manual_seed(2)
    e, f, d, b, k = 6, 8, 16, 3, 2
    gate, up = torch.randn(2, e, f, d, generator=g)
    down = torch.randn(e, d, f, generator=g)
    x = torch.randn(b, d, generator=g)
    idx = torch.tensor([[0, 3], [3, 5], [0, 3]])  # rows share experts
    w = torch.rand(b, k, generator=g)
    sg, su = torch.randn(2, 2 * f, d, generator=g)  # 2 shared experts
    sd = torch.randn(d, 2 * f, generator=g)
    got = md.moe_decode_plain(x, idx, w, gate, up, down, (sg, su, sd))
    silu = torch.nn.functional.silu
    for r in range(b):
        want = sum(w[r, j] * (down[idx[r, j]] @ (silu(
            gate[idx[r, j]] @ x[r]) * (up[idx[r, j]] @ x[r])))
            for j in range(k)) + sd @ (silu(sg @ x[r]) * (su @ x[r]))
        assert torch.allclose(got[r], want, rtol=1e-5, atol=1e-4)


def test_mla_plain_writes_and_attends():
    g = torch.Generator().manual_seed(3)
    b, nh, r, p, lmax = 3, 4, 16, 8, 20
    q = torch.randn(b, nh, r + p, generator=g)
    new = torch.randn(b, r + p, generator=g)
    cache = torch.randn(b, lmax, r + p, generator=g)
    index = torch.tensor([5, 19, 30])  # the last lies outside: no write
    mask = (torch.arange(lmax)[None] <= torch.tensor([5, 19, -1])[:, None]).int()
    before = cache.clone()
    out = mla.mla_decode_write_attention_plain(q, new, cache, mask, index, r,
                                               0.25)
    assert torch.equal(cache[0, 5], new[0]) and torch.equal(cache[1, 19], new[1])
    assert torch.equal(cache[2], before[2])
    assert not out[2].any()  # no live slot
    for row in range(2):
        n = int(index[row]) + 1
        s = (q[row] @ cache[row, :n].T) * 0.25
        want = s.softmax(-1) @ cache[row, :n, :r]
        assert torch.allclose(out[row], want, atol=1e-5)
    splits, chunk, heads = mla.mla_plan(1, 16, 607)
    assert splits * chunk >= 607 and (splits - 1) * chunk < 607
    assert heads == 4 and mla.mla_plan(8, 16, 607)[0] < splits


@torch.inference_mode()
def test_expert_ids_equal_the_references_choices(model):
    """The routing the state records (prompt and every fed step) is the
    reference's own top-k at every MoE layer and position (float32 on
    both sides: no near-tie at these seeds)."""
    x, steps = embeds(70, seed=9), 6
    res = _generate(model, x, steps, torch.float32)
    prompt_ids, decode_ids = res.expert_ids
    assert prompt_ids.shape == (1, 70, CFG.num_moe_layers, 2)
    assert decode_ids.dtype == torch.int16
    assert (decode_ids[0, -1] == -1).all()  # the last step feeds nothing
    toks = res.tokens[0].long()
    full = torch.cat([x[0], model.embed(toks[:-1])], 0)
    forced = torch.cat([prompt_ids[0], decode_ids[0, :-1]], 0)
    W = weights(model)
    want = ref.forward(full, W, hf(), prefix="", forced=forced)
    assert want["mismatched"] == 0 and want["margin_max"] == 0.0


def test_latent_cache_state():
    state = generate.DecodeState(CFG, 2, 10, 4, "cpu")
    assert all(isinstance(c, torch.Tensor) for c in state.caches)
    assert [tuple(c.shape) for c in state.caches] == [(2, 14, 40)] * 3
    # the routing record's static buffers: 2 MoE layers of top-2
    assert state.prompt_experts.shape == (2, 10, 2, 2)
    assert state.decode_experts.shape == (2, 4, 2, 2)
    assert state.caches[0].dtype == torch.bfloat16
    assert generate.cache_geometry(CFG) == (3, 1, 40)
    state.caches[1].fill_(1.0)
    state.reset_caches()
    assert not state.caches[1].any()
    with pytest.raises(ValueError, match="int8"):
        generate.alloc_caches(CFG, 1, 8, "cpu", kv_cache_8bit=True)


def test_predictor_end_to_end():
    from haff_tpu_torch.infer.predictor import Predictor

    pred = Predictor(model_preset="tiny", decoder="deepseek_v3",
                     precision="fp32", max_new_tokens=4, device="cpu")
    assert isinstance(pred.model.llm, dsv3.DeepseekV3ForCausalLM)
    assert pred.model.text_fc1.weight.shape == (64, 64)
    frame = np.random.RandomState(0).randint(0, 255, (48, 80, 3), np.uint8)
    (text, ml, mr, tax), second = pred.predict_batch(
        [frame, frame[::-1].copy()], ["open the jar", "cut the bread"])
    assert ml.shape == mr.shape == (48, 80) and tax.shape == (4,)
    assert abs(float(tax.sum()) - 1.0) < 1e-4 and np.isfinite(ml).all()
    assert len(second) == 4


def test_refusals():
    from haff_tpu_torch.infer.evaluate import make_jitted_evaluate
    from haff_tpu_torch.infer.predictor import Predictor
    from haff_tpu_torch.model.lisa import LisaModel

    model = LisaModel(dsv3.model_config("tiny"), torch.float32, device="cpu")
    with pytest.raises(ValueError, match="deepseek_v3"):
        make_jitted_evaluate(model, 4, 2, kv_cache_8bit=True)
    with pytest.raises(ValueError, match="deepseek_v3"):
        make_jitted_evaluate(model, 4, 2, draft_corpus=np.zeros((1, 8)))
    with pytest.raises(ValueError, match="deepseek_v3"):
        Predictor(model_preset="tiny", decoder="deepseek_v3", speculative=True,
                  precision="fp32", device="cpu")
    with pytest.raises(ValueError, match="mesh"):
        LisaModel(dsv3.model_config("tiny"), torch.float32, device="meta",
                  mesh=object())


@torch.inference_mode()
def test_bf16_model_runs_in_bf16_with_float32_norms_and_router():
    """The norms' and router's parameters stay float32 through
    `.to(bfloat16)` (no cast a call); the residual stream, the hidden
    states and the experts stay bf16."""
    m = seeded(dsv3.DeepseekV3ForCausalLM(CFG)).bfloat16()
    assert m.norm.weight.dtype == torch.float32
    assert m.layers[1].mlp.gate.weight.dtype == torch.float32
    assert m.layers[1].mlp.gate.e_score_correction_bias.dtype == torch.float32
    assert m.layers[1].mlp.gate_proj.dtype == torch.bfloat16
    logits, hidden, _ = m(embeds(5), torch.arange(5)[None])
    assert hidden.dtype == logits.dtype == torch.bfloat16
