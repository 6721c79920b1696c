"""Validation on a mesh (infer/evaluate.py `mesh_evaluate_fn` /
`make_mesh_evaluate`: the eager evaluate with the mesh's collectives
inside, every rank on the whole batch) against the one-process evaluate,
at the tiny preset in float32 in 4 gloo ranks on the CPU
(tests/torch_mesh_workers.py `case_mesh_eval`).

Meshes: data 2 x tensor 2 (each rank its heads' KV caches), pipe 2 x data
2 (each stage its layers' caches, the hidden state passed stage to stage
at the prefill and every decode step), sequence-parallel 2 x tensor 2
(the prefill's attention a ring, the decode on the whole cache), expert
2 x tensor 2 with MoE layers (the per-row routing's combine summed over
the expert group), pipe 2 x tensor 2 over the MPT decoder, and 4-bit
bases under tensor 2 x data 2. On every rank: the evaluate's tokens and
lengths equal the one-process evaluate's, its masks and taxonomy within
1e-4, and validate_on_benchmark's IoU, IoCM and per-frame records equal.
"""

import dataclasses

import numpy as np
import pytest
import torch

from haff_tpu_torch.core.config import ModelConfig
from haff_tpu_torch.data.aff_dataset import AffDatasetVal
from haff_tpu_torch.data.collate import collate_affordance
from haff_tpu_torch.data.tokenizer import load_tokenizer
from haff_tpu_torch.infer.evaluate import (evaluate_fn, make_jitted_evaluate,
                                           validate_on_benchmark)
from haff_tpu_torch.model.lisa import LisaModel
from haff_tpu_torch.nn import quant
from haff_tpu_torch.train import trainer as T
from haff_tpu_torch.train.cli import frozen_predicate
from test_torch_train_cli import synth_data  # noqa: F401 (a fixture)
from torch_mesh_workers import run_ranks

NEW_TOKENS = 6
LORA = dict(lora_rank=2)
MOE = dict(lora_rank=2, moe_num_experts=4, moe_top_k=2, moe_every=2)
RUNS = {
    "data2_tensor2": dict(mesh=(("data", 2), ("tensor", 2)), llama=LORA),
    "pp2_data2": dict(mesh=(("pp", 2), ("data", 2)), llama=LORA),
    "sp2_tensor2": dict(mesh=(("sp", 2), ("tensor", 2)),
                        llama=dict(LORA, sequence_parallel=True)),
    "ep2_tensor2_moe": dict(mesh=(("ep", 2), ("tensor", 2)), llama=MOE),
    "pp2_tensor2_mpt": dict(mesh=(("pp", 2), ("tensor", 2)), llama=LORA,
                            decoder="mpt"),
    "tensor2_data2_int4": dict(mesh=(("tensor", 2), ("data", 2)),
                               llama=LORA, bits=4),
}


def _model(run):
    base = ModelConfig.preset("tiny")
    llama = {k: v for k, v in run["llama"].items()
             if k != "sequence_parallel"}
    cfg = base.replace(decoder=run.get("decoder", "llama"),
                       llama=dataclasses.replace(base.llama, **llama))
    return LisaModel(cfg, torch.float32, device="cpu",
                     generator=torch.Generator().manual_seed(17))


@pytest.fixture(scope="module")
def results(synth_data, tmp_path_factory):  # noqa: F811
    _, bench = synth_data
    tok = load_tokenizer(None, model_max_length=448)
    ds = AffDatasetVal(bench)
    cfg = ModelConfig.preset("tiny")
    vb = collate_affordance([ds[0][0], ds[0][0]], tok,
                            sam_image_size=cfg.sam_encoder.image_size,
                            clip_image_size=cfg.clip.image_size,
                            max_text_len=448, for_training=False)
    inputs = tuple(torch.as_tensor(np.asarray(vb[k])) for k in (
        "images_sam", "images_clip", "input_ids", "attention_mask"))
    runs, refs = [], {}
    for name, run in RUNS.items():
        model = _model(run)
        sd = {k: v.clone() for k, v in model.state_dict().items()}
        if run.get("bits"):
            _, frozen = T.partition_params(model)
            quant.quantize_model_(model, frozen_predicate(
                set(frozen), quant.default_llm_predicate), bits=4, group=16)
        out = evaluate_fn(model, *inputs, max_new_tokens=NEW_TOKENS,
                          eos_id=tok.eos_token_id)
        ev = make_jitted_evaluate(model, NEW_TOKENS, tok.eos_token_id)
        refs[name] = dict(out=out, validate=validate_on_benchmark(
            model, tok, ds, evaluate=ev, model_max_length=448))
        runs.append(dict(run, sd=sd))
    got = run_ranks("mesh_eval", dict(
        preset="tiny", runs=runs, inputs=inputs, new_tokens=NEW_TOKENS,
        eos=tok.eos_token_id, bench=bench), 4,
        tmp_path_factory.mktemp("mesh_eval"), timeout=420)
    return {name: [got[r][i] for r in range(4)]
            for i, name in enumerate(RUNS)}, refs


@pytest.mark.parametrize("run", list(RUNS))
def test_mesh_validation_equals_one_process(results, run):
    got, refs = results
    want = refs[run]
    for r, res in enumerate(got[run]):
        out = want["out"]
        assert torch.equal(res["output_ids"], out.output_ids), r
        assert torch.equal(res["gen_lengths"], out.gen_lengths), r
        for k in ("pred_masks_left", "pred_masks_right", "taxonomies"):
            torch.testing.assert_close(res[k], getattr(out, k), rtol=1e-4,
                                       atol=1e-4)
        iou, iocm, frames = res["validate"]
        assert (iou, iocm) == want["validate"][:2], r
        assert frames == want["validate"][2], r
