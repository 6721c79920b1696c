"""Speculative decoding through the port's serving entry points, at the
tiny preset in float32 on the CPU: `evaluate_fn(draft_corpus=...)` and
`make_jitted_evaluate(..., draft_corpus=...)` against haff_tpu's jitted
evaluate on the same bridged weights and requests (a template corpus
that the random model mostly rejects); the W8A8 serving tree with the
int8 cache; JAX's corpus broadcasting and errors; the
`Predictor(speculative=True)` answer against the plain one; the batch
CLI's `--speculative`; and the MPT decoder's refusal.

Tolerances: tokens, lengths and decode steps identical; masks and
taxonomy within 1e-4 (float32, summation order), 2e-2 for the 8-bit
evaluate (its standing tolerance, tests/test_torch_quant_evaluate.py:
W8A8 rounds activations to int8, and a 1e-6 difference before a round
moves one int8 step).
"""

import os

import jax
import numpy as np
import pytest
import torch

from haff_tpu.infer.evaluate import make_jitted_evaluate as jax_evaluate
from haff_tpu.infer.generate import make_lookup_corpus
from haff_tpu.nn import quant as jq
from haff_tpu_torch.core.config import ModelConfig
from haff_tpu_torch.infer import cli
from haff_tpu_torch.infer.evaluate import evaluate_fn, make_jitted_evaluate
from haff_tpu_torch.infer.predictor import Predictor
from haff_tpu_torch.model.lisa import LisaModel
from test_torch_bridge import jax_tiny_params, port_model
from test_torch_entrypoints import TINY, _benchmark, _written
from test_torch_evaluate import B, EOS, T

TOL = dict(rtol=1e-4, atol=1e-4)
TOL8 = dict(rtol=2e-2, atol=2e-2)
CORPUS, LENS = make_lookup_corpus([[3, 4, 5]], width=8, batch=1, pad_id=2)
FIELDS = ("output_ids", "gen_lengths", "pred_masks_left", "pred_masks_right",
          "taxonomies", "seg_found", "decode_steps")


def _requests(cfg, seed=7):
    from haff_tpu.core.config import IMAGE_TOKEN_INDEX

    rng = np.random.default_rng(seed)
    ids = rng.integers(5, 400, (B, 10)).astype(np.int32)
    ids[:, 2] = IMAGE_TOKEN_INDEX
    att = np.ones((B, 10), np.int32)
    att[1, 7:] = 0
    att[2, 5:] = 0
    S, C = cfg.sam_encoder.image_size, cfg.clip.image_size
    return (rng.standard_normal((B, S, S, 3)).astype(np.float32),
            rng.standard_normal((B, C, C, 3)).astype(np.float32), ids, att)


def _np(res):
    return {k: np.asarray(v.numpy() if torch.is_tensor(v) else v)
            for k, v in res._asdict().items() if v is not None}


def _same(got, ref, tol, steps=True):
    np.testing.assert_array_equal(got["output_ids"], ref["output_ids"])
    np.testing.assert_array_equal(got["gen_lengths"], ref["gen_lengths"])
    np.testing.assert_array_equal(got["seg_found"], ref["seg_found"])
    if steps:
        assert int(got["decode_steps"]) == int(ref["decode_steps"])
    for key in ("pred_masks_left", "pred_masks_right", "taxonomies"):
        np.testing.assert_allclose(got[key], ref[key], **tol, err_msg=key)


@pytest.fixture(scope="module")
def trees():
    jmodel, params = jax_tiny_params()
    params["llm"]["lm_head"]["kernel"][:, jmodel.cfg.seg_token_idx] *= 2.0
    return jmodel, params, _requests(jmodel.cfg)


@pytest.fixture(scope="module")
def float_case(trees):
    jmodel, params, req = trees
    ref = jax_evaluate(jmodel, T, EOS, draft_corpus=CORPUS,
                       corpus_lengths=LENS, draft_len=3)({"params": params},
                                                         *req)
    return _np(ref), port_model(params)


@pytest.mark.parametrize("entry", ["evaluate_fn", "make_jitted_evaluate"])
def test_speculative_evaluate_matches_jax(float_case, trees, entry):
    ref, port = float_case
    req = trees[2]
    kw = dict(draft_corpus=CORPUS, corpus_lengths=LENS, draft_len=3)
    if entry == "evaluate_fn":
        got = evaluate_fn(port, *req, T, EOS, **kw)
    else:
        got = make_jitted_evaluate(port, T, EOS, **kw)(*req)
    got = _np(got)
    _same(got, ref, TOL)
    assert got["seg_found"].any() and 0 < int(got["decode_steps"]) <= T


def test_speculative_equals_greedy_and_oracle_saves_steps(float_case, trees):
    _, port = float_case
    req = trees[2]
    plain = _np(evaluate_fn(port, *req, T, EOS))
    assert "decode_steps" not in plain
    spec = _np(evaluate_fn(port, *req, T, EOS, draft_corpus=CORPUS,
                           corpus_lengths=LENS, draft_len=3))
    _same(spec, plain, TOL, steps=False)
    oracle = np.concatenate([np.full((B, 1), -1), plain["output_ids"]], 1)
    fast = _np(evaluate_fn(port, *req, T, EOS, draft_corpus=oracle,
                           draft_len=4))
    _same(fast, plain, TOL, steps=False)
    assert int(fast["decode_steps"]) <= -(-T // 4) + 1


def test_corpus_broadcasting_and_errors(float_case, trees):
    _, port = float_case
    req = trees[2]
    run = lambda **kw: _np(evaluate_fn(port, *req, T, EOS,  # noqa: E731
                                       draft_len=3, **kw))
    full = run(draft_corpus=np.repeat(CORPUS, B, 0),
               corpus_lengths=np.repeat(LENS, B))
    for kw in (dict(draft_corpus=CORPUS[0], corpus_lengths=LENS),
               dict(draft_corpus=torch.from_numpy(CORPUS),
                    corpus_lengths=int(LENS[0]))):
        _same(run(**kw), full, dict(rtol=0, atol=0))
    with pytest.raises(ValueError, match="corpus_lengths batch 2 != input "
                                         "batch 3"):
        run(draft_corpus=CORPUS, corpus_lengths=[5, 5])


def test_w8a8_serving_params_match_jax(trees):
    jmodel, params, req = trees
    qtree = jax.tree_util.tree_map(np.asarray, jq.quantize_dense_tree(
        params, jq.lisa_serving_predicate))
    ref = _np(jax_evaluate(jmodel, T, EOS, kv_cache_8bit=True,
                           draft_corpus=CORPUS[0], corpus_lengths=LENS[:1],
                           draft_len=3)({"params": qtree}, *req))
    port = port_model(qtree)
    kw = dict(kv_cache_8bit=True, draft_corpus=CORPUS[0],
              corpus_lengths=LENS[:1], draft_len=3)
    got = _np(evaluate_fn(port, *req, T, EOS, **kw))
    _same(got, ref, TOL8)
    plain = _np(evaluate_fn(port, *req, T, EOS, kv_cache_8bit=True))
    _same(got, plain, TOL8, steps=False)


def test_predictor_speculative_matches_plain():
    img = (np.random.RandomState(0).rand(48, 64, 3) * 255).astype(np.uint8)
    kw = dict(model_preset="tiny", precision="fp32", max_new_tokens=4,
              max_text_len=160, device="cpu")
    plain = Predictor(**kw)
    spec = Predictor(**kw, speculative=True, draft_len=4)
    (ans_p, ml_p, mr_p, tax_p), = plain.predict_batch([img], ["open it"])
    (ans_s, ml_s, mr_s, tax_s), = spec.predict_batch([img], ["open it"])
    assert ans_p == ans_s
    for a, b in ((ml_p, ml_s), (mr_p, mr_s), (tax_p, tax_s)):
        np.testing.assert_allclose(b, a, **TOL)


def test_cli_speculative_writes_the_plain_masks(tmp_path):
    bench = str(tmp_path / "bench")
    _benchmark(bench)
    for name, extra in (("plain", []), ("spec", ["--speculative",
                                                 "--draft_len", "3"])):
        cli.main(["--benchmark_dir", bench, "--vis_save_path",
                  str(tmp_path / name / "vis"), *TINY, "--device", "cpu",
                  *extra])
    ref, got = _written(tmp_path / "plain"), _written(tmp_path / "spec")
    assert set(got) == set(ref) and len(ref) >= 10
    for name, r in ref.items():
        np.testing.assert_array_equal(got[name], r, err_msg=name)


def test_mpt_decoder_refuses_speculation(tmp_path):
    cfg = ModelConfig.preset("tiny").replace(decoder="mpt")
    model = LisaModel(cfg, torch.float32, device="cpu")
    req = _requests(cfg)
    with pytest.raises(ValueError, match="llama decoder only"):
        evaluate_fn(model, *req, T, EOS, draft_corpus=CORPUS)
    with pytest.raises(ValueError, match="llama decoder only"):
        make_jitted_evaluate(model, T, EOS, draft_corpus=CORPUS)
    with pytest.raises(ValueError, match="requires the llama decoder"):
        Predictor(model_preset="tiny", decoder="mpt", precision="fp32",
                  speculative=True, device="cpu")
    bench = str(tmp_path / "bench")
    _benchmark(bench)
    with pytest.raises(SystemExit, match="requires the llama decoder"):
        cli.main(["--benchmark_dir", bench, "--vis_save_path",
                  os.path.join(str(tmp_path), "vis"), *TINY,
                  "--device", "cpu", "--decoder", "mpt", "--speculative"])
