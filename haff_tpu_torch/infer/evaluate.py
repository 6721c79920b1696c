"""The evaluate() API: text + image -> (output tokens, left/right
affordance masks, taxonomy) (port of haff_tpu/infer/evaluate.py
`evaluate_fn`, `make_jitted_evaluate` and `validate_on_benchmark`):
greedy decode, or with a draft corpus prompt-lookup speculative decode
(the same tokens in fewer decode forwards; LLaMA decoder only). The
deepseek_v3 decoder (nn/deepseek_v3.py) decodes greedily over its latent
cache, with the experts it chose in `GenerateResult.expert_ids`.

Generate with hidden-state capture, gather the first emitted [SEG]'s
hidden state, project it, prompt both SAM mask decoders with it, and
upsample the masks to the padded square canvas. Resizing to each frame's
original size is host-side (nn/sam.py resize_to_original).

`make_jitted_evaluate` is the counterpart of JAX's compiled static-shape
evaluate: on a CUDA model the decode loop, one decoder forward a token, is
captured in a CUDA graph once per bucket (batch, prompt length, new
tokens, cache kind) and replayed on every later call of that bucket; the
CLIP tower, the prefill, the SAM encoder and the mask decode run eagerly.
Speculative decode has a data-dependent trip count (JAX's `while_loop`):
one verify step is captured per bucket (which adds the draft length and
the corpus width to the key) and replayed from the host while a row is
live, at most T times, reading a one-element flag after each replay.
With JAX's `quant_scales=` (nn/quant.py `quantize_tree`, bound into the
model by `bind_quantized_tree_`) the selected layers stay int8 / packed
int4 at rest and are dequantized at use during the evaluator's calls
(`DequantizeAtUse`), inside the graph on the card.
`validate_on_benchmark` scores a benchmark folder with it (the train
CLI's per-epoch validation).

While a profiler collects, each stage is a span (utils/profiling.py) of
the same name on the eager and the graphed path: `evaluate.inputs` (the
copies to the device), `evaluate.prompt` (CLIP, embeddings, splice),
`evaluate.prefill` (inside generate.prefill), `evaluate.decode` (the
eager loop, or the graph's capture or replay) and `evaluate.finish`.

On a mesh of ranks (core/mesh.py; the model sharded by
parallel/sharding.py) `make_mesh_evaluate` is the evaluate: eager, with
the mesh's collectives inside (a CUDA graph cannot capture gloo's
host-staged transfers, so none is attempted), every rank on the whole
batch and ending with the same tokens and masks. Under a pipe axis each
stage keeps the KV caches of its own layers and the hidden state passes
stage to stage at the prefill and at every decode step
(parallel/pipeline.py `pipelined_decode`); tensor-parallel ranks keep
their heads' caches; expert ranks sum their per-row MoE combine over the
expert group; under sp the prefill rings and the decode steps run on the
whole cache, as JAX's decoder does with a cache.
"""

from __future__ import annotations

import collections
import contextlib
from typing import NamedTuple

import torch

from ..kernels import _build
from ..model.lisa import LisaModel
from ..model.multimodal import find_image_position, splice_image_embeddings
from ..nn.sam import postprocess_masks_padded
from ..utils.profiling import span
from .generate import (DecodeState, SpeculativeState, decode_loop,
                       greedy_generate, prefill, speculative_generate,
                       verify_step)

_MPT_SPECULATIVE = ("speculative decoding is wired for the llama decoder "
                    "only (MPT attention has no chunked cache-verify mode)")
_DEEPSEEK = ("the deepseek_v3 decoder serves greedily on one process, over "
             "its bfloat16 latent cache: no speculative decoding, no int8 "
             "cache, no mesh")


def _check_decoder(model, speculative: bool, kv_cache_8bit: bool) -> None:
    """Raise ValueError for a path the model's decoder does not have."""
    if model.cfg.decoder == "deepseek_v3" and (speculative or kv_cache_8bit):
        raise ValueError(_DEEPSEEK)
    if speculative and model.cfg.decoder == "mpt":
        raise ValueError(_MPT_SPECULATIVE)


class EvaluateResult(NamedTuple):
    output_ids: torch.Tensor        # (B, T) generated tokens
    gen_lengths: torch.Tensor       # (B,)
    pred_masks_left: torch.Tensor   # (B, S, S) canvas logits, float32
    pred_masks_right: torch.Tensor  # (B, S, S)
    taxonomies: torch.Tensor        # (B, 4) softmax probabilities
    seg_found: torch.Tensor         # (B,) bool: a [SEG] was emitted
    # decode forwards taken (a scalar; speculative path only, else None)
    decode_steps: torch.Tensor = None


def _inputs(model, images_sam, images_clip, input_ids, attention_mask):
    """Tensors (or numpy arrays) -> tensors on the model's device."""
    as_t = lambda x: torch.as_tensor(x, device=model.device)  # noqa: E731
    with span("evaluate.inputs"):
        return (as_t(images_sam), as_t(images_clip), as_t(input_ids).long(),
                as_t(attention_mask))


def _prompt(model, images_clip, input_ids, attention_mask):
    """CLIP tower, token embeddings and the multimodal splice."""
    with span("evaluate.prompt"):
        clip_emb = model.encode_clip(images_clip)
        tok = model.embed_tokens(input_ids)
        return splice_image_embeddings(
            tok, clip_emb, find_image_position(input_ids), input_ids, None,
            attention_mask, seg_token_idx=model.cfg.seg_token_idx)


def _finish(model, gen, images_sam, max_new_tokens) -> EvaluateResult:
    """[SEG] gather and projection, SAM encode, dual mask decode."""
    cfg = model.cfg
    dev = model.device
    # [SEG] gather: the hidden state that emitted the first [SEG].
    steps = torch.arange(max_new_tokens, device=dev)[None, :]
    is_seg = (gen.tokens == cfg.seg_token_idx) & (steps < gen.lengths[:, None])
    seg_found = is_seg.any(dim=1)
    first = torch.argmax(is_seg.int(), dim=1)
    rows = torch.arange(gen.tokens.shape[0], device=dev)
    seg_hidden = gen.hiddens[rows, first][:, None]                # (B, 1, E)
    seg_emb = model.project_seg(seg_hidden)
    seg_emb = seg_emb * seg_found[:, None, None].to(seg_emb.dtype)

    sam_emb = model.encode_sam(images_sam)
    masks_l, masks_r, _, _, taxonomy = model.decode_masks(sam_emb, seg_emb)
    S = cfg.sam_encoder.image_size
    return EvaluateResult(
        output_ids=gen.tokens, gen_lengths=gen.lengths,
        pred_masks_left=postprocess_masks_padded(masks_l, S)[:, 0],
        pred_masks_right=postprocess_masks_padded(masks_r, S)[:, 0],
        taxonomies=taxonomy, seg_found=seg_found, decode_steps=gen.steps)


def draft_operands(model, draft_corpus, corpus_lengths, batch: int):
    """The draft corpus as (B, C) and its live lengths as (B,) (or None)
    long tensors on the model's device, with JAX's broadcasting: a 1-D
    corpus is one row, a one-row corpus is shared by the batch, one
    length is shared. Raises ValueError for the MPT and deepseek_v3
    decoders, and for a count of lengths that is neither 1 nor the
    batch."""
    _check_decoder(model, True, False)
    corpus = torch.as_tensor(draft_corpus, device=model.device).long()
    if corpus.dim() == 1:
        corpus = corpus[None]
    if corpus.shape[0] != batch:  # a shared (1, C) template corpus
        corpus = corpus.expand(batch, corpus.shape[1])
    lengths = None
    if corpus_lengths is not None:
        lengths = torch.as_tensor(corpus_lengths,
                                  device=model.device).long().reshape(-1)
        if lengths.shape[0] == 1:
            lengths = lengths.expand(batch)
        elif lengths.shape[0] != batch:
            raise ValueError(
                f"corpus_lengths batch {lengths.shape[0]} != input batch "
                f"{batch} (pass 1 shared length or one per row)")
    return corpus.contiguous(), (None if lengths is None
                                 else lengths.contiguous())


@torch.inference_mode()
def evaluate_fn(model: LisaModel, images_sam, images_clip, input_ids,
                attention_mask, max_new_tokens: int, eos_id: int,
                kv_cache_8bit: bool = False, draft_corpus=None,
                corpus_lengths=None, draft_len: int = 8) -> EvaluateResult:
    """images_sam (B, S, S, 3) and images_clip (B, C, C, 3) preprocessed
    NHWC; input_ids (B, L) with IMAGE_TOKEN_INDEX; attention_mask (B, L),
    1 = real token (right padding). Inputs (tensors or numpy) are moved to
    the model's device; the result stays there. `kv_cache_8bit` decodes
    over an int8 KV cache.

    With `draft_corpus` ((B, C) or (1, C) token ids, e.g. the tokenized
    ANSWER_LIST templates of generate.answer_template_corpus), decode runs
    prompt-lookup speculative decoding (generate.speculative_generate,
    `draft_len` tokens a verify step): the same tokens in fewer decode
    forwards, counted in `decode_steps`. LLaMA decoder only."""
    _check_decoder(model, draft_corpus is not None, kv_cache_8bit)
    images_sam, images_clip, input_ids, attention_mask = _inputs(
        model, images_sam, images_clip, input_ids, attention_mask)
    sp = _prompt(model, images_clip, input_ids, attention_mask)
    args = (model.llm.cfg, model.embed_tokens, model.llm_forward, sp.embeds,
            sp.positions, sp.segment_ids, sp.segment_ids.sum(dim=1),
            max_new_tokens, eos_id)
    if draft_corpus is not None:
        corpus, lengths = draft_operands(model, draft_corpus, corpus_lengths,
                                         input_ids.shape[0])
        gen = speculative_generate(*args, corpus, lengths, draft_len,
                                   kv_cache_8bit=kv_cache_8bit)
    else:
        gen = greedy_generate(*args, kv_cache_8bit=kv_cache_8bit)
    with span("evaluate.finish"):
        return _finish(model, gen, images_sam, max_new_tokens)


class GraphedEvaluate:
    """evaluate_fn with the decode in a CUDA graph per bucket.

    Greedy: the first call of a bucket allocates its DecodeState, runs the
    prefill, runs this call's decode loop eagerly on a side stream (the
    warm-up: every kernel library is loaded and every lazy handle made
    before capture), then captures the loop with torch.cuda.CUDAGraph.
    Every later call of the bucket zeroes its caches, runs the prefill
    into them and replays the graph.

    Speculative (`draft_corpus` given): the same, with a SpeculativeState,
    this call's whole verify loop as the warm-up and one `verify_step` as
    the graph; a later call replays it while the state's `live` flag,
    copied to pinned host memory after each replay, says a row is live,
    at most T times. `decode_steps` is the replay count. A capture or
    replay error raises; nothing falls back to the eager loop.

    Launch counting: the kernels' wrappers count in Python, so they count
    while the graph is captured, when nothing runs, and not when it is
    replayed. The counts the capture added are taken back out of
    `_build.LAUNCHES` and kept (`decode_launches`), and each replay adds
    them once: a graphed call counts exactly what an eager one does.
    `captures` and `replays` count the graphs captured and replayed."""

    def __init__(self, model: LisaModel, max_new_tokens: int, eos_id: int,
                 kv_cache_8bit: bool = False, draft_corpus=None,
                 corpus_lengths=None, draft_len: int = 8,
                 dequant=contextlib.nullcontext()):
        _check_decoder(model, draft_corpus is not None, kv_cache_8bit)
        if draft_corpus is not None:
            if draft_len < 2:
                raise ValueError("draft_len must be >= 2 (1 == plain greedy)")
        self.model = model
        self.max_new_tokens = max_new_tokens
        self.eos_id = eos_id
        self.kv_cache_8bit = kv_cache_8bit
        self.draft_corpus = draft_corpus
        self.corpus_lengths = corpus_lengths
        self.draft_len = draft_len
        self._dequant = dequant  # entered around every call
        # Speculative buckets also key on the draft length and corpus width.
        self._key = (() if draft_corpus is None else
                     (draft_len, *torch.as_tensor(draft_corpus).shape))
        self._buckets = {}  # key -> (state, CUDAGraph, launches)
        # The speculative loop's host copy of the state's `live` flag.
        self._live = (None if draft_corpus is None else
                      torch.zeros(1, dtype=torch.bool, pin_memory=True))
        self.captures = 0
        self.replays = 0

    def _decode(self, state):
        decode_loop(state, self.model.embed_tokens, self.model.llm_forward,
                    self.max_new_tokens, self.eos_id)

    def _verify(self, state):
        verify_step(state, self.model.embed_tokens, self.model.llm_forward)

    def _speculate(self, state):
        """This call's verify loop, eagerly (the warm-up)."""
        for _ in range(self.max_new_tokens):
            if not bool(state.live):
                break
            self._verify(state)

    def _new_state(self, batch, prompt_len):
        model = self.model
        if self.draft_corpus is None:
            return DecodeState(model.llm.cfg, batch, prompt_len,
                               self.max_new_tokens, model.device,
                               kv_cache_8bit=self.kv_cache_8bit)
        corpus, lengths = draft_operands(model, self.draft_corpus,
                                         self.corpus_lengths, batch)
        return SpeculativeState(model.llm.cfg, batch, prompt_len,
                                self.max_new_tokens, model.device, corpus,
                                lengths, self.draft_len, self.eos_id,
                                kv_cache_8bit=self.kv_cache_8bit)

    def _capture(self, state):
        spec = self.draft_corpus is not None
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            # This call's decode: the warm-up.
            (self._speculate if spec else self._decode)(state)
        torch.cuda.current_stream().wait_stream(side)
        before = collections.Counter(_build.LAUNCHES)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            (self._verify if spec else self._decode)(state)
        delta = collections.Counter(_build.LAUNCHES)
        delta.subtract(before)
        delta = +delta  # the launches of one replay
        _build.LAUNCHES.subtract(delta)  # nothing ran while capturing
        self.captures += 1
        return graph, delta

    def _replay(self, bucket) -> None:
        """Greedy: one replay. Speculative: replays while a row is live
        (at most T), the flag read after each through pinned memory."""
        state, graph, delta = bucket
        spec = self.draft_corpus is not None
        for _ in range(self.max_new_tokens if spec else 1):
            graph.replay()
            _build.LAUNCHES.update(delta)
            self.replays += 1
            if spec:
                self._live.copy_(state.live, non_blocking=True)
                torch.cuda.current_stream().synchronize()
                if not bool(self._live):
                    break

    @torch.inference_mode()
    def __call__(self, images_sam, images_clip, input_ids,
                 attention_mask) -> EvaluateResult:
        with self._dequant:
            return self._evaluate(images_sam, images_clip, input_ids,
                                  attention_mask)

    def _evaluate(self, images_sam, images_clip, input_ids, attention_mask):
        model = self.model
        images_sam, images_clip, input_ids, attention_mask = _inputs(
            model, images_sam, images_clip, input_ids, attention_mask)
        sp = _prompt(model, images_clip, input_ids, attention_mask)
        key = (*input_ids.shape, self.max_new_tokens, self.kv_cache_8bit,
               *self._key)
        bucket = self._buckets.get(key)
        if bucket is None:
            state = self._new_state(input_ids.shape[0], sp.embeds.shape[1])
        else:
            state = bucket[0]
            state.reset_caches()
        prefill(state, model.llm_forward, sp.embeds, sp.positions,
                sp.segment_ids, sp.segment_ids.sum(dim=1))
        with span("evaluate.decode"):
            if bucket is None:
                self._buckets[key] = (state, *self._capture(state))
            else:
                self._replay(bucket)
        with span("evaluate.finish"):
            return _finish(model, state.result(), images_sam,
                           self.max_new_tokens)

    def decode_launches(self):
        """{bucket key: the launches one replay of its graph adds}."""
        return {key: dict(b[2]) for key, b in self._buckets.items()}


def make_jitted_evaluate(model: LisaModel, max_new_tokens: int, eos_id: int,
                         quant_scales=None, quant_dtype=torch.bfloat16,
                         kv_cache_8bit: bool = False, draft_corpus=None,
                         corpus_lengths=None, draft_len: int = 8):
    """A callable (images_sam, images_clip, input_ids, attention_mask) ->
    EvaluateResult, with evaluate_fn's inputs and result: on a CUDA model
    a GraphedEvaluate (the greedy decode loop, or one speculative verify
    step, captured in a CUDA graph per bucket), on a CPU model evaluate_fn
    itself bound to `model` and the decode settings.

    With `quant_scales` (nn/quant.quantize_tree's scales over the model's
    state, whose quantized tensors the model holds after
    nn/quant.bind_quantized_tree_), the named layers stay int8 / packed
    int4 at rest and, during this callable's calls only, are dequantized
    to `quant_dtype` at use, each just before its product (inside the
    graphs on the card); their products launch no quantized kernel."""
    dequant = contextlib.nullcontext()
    if quant_scales is not None:
        from ..nn.quant import DequantizeAtUse

        dequant = DequantizeAtUse(model, quant_scales, quant_dtype)
    if model.device.type == "cuda":
        return GraphedEvaluate(model, max_new_tokens, eos_id, kv_cache_8bit,
                               draft_corpus, corpus_lengths, draft_len,
                               dequant)
    _check_decoder(model, draft_corpus is not None, kv_cache_8bit)

    def evaluate(images_sam, images_clip, input_ids, attention_mask):
        with dequant:
            return evaluate_fn(model, images_sam, images_clip, input_ids,
                               attention_mask, max_new_tokens=max_new_tokens,
                               eos_id=eos_id, kv_cache_8bit=kv_cache_8bit,
                               draft_corpus=draft_corpus,
                               corpus_lengths=corpus_lengths,
                               draft_len=draft_len)

    return evaluate


@torch.inference_mode()
def mesh_evaluate_fn(model: LisaModel, mesh, images_sam, images_clip,
                     input_ids, attention_mask, max_new_tokens: int,
                     eos_id: int, kv_cache_8bit: bool = False
                     ) -> EvaluateResult:
    """evaluate_fn's greedy path on a model sharded over `mesh`, every
    rank on the whole batch (see the module docstring)."""
    import dataclasses

    from ..core.mesh import use_mesh
    from .generate import DecodeState

    if model.cfg.decoder == "deepseek_v3":
        raise ValueError(_DEEPSEEK)
    images_sam, images_clip, input_ids, attention_mask = _inputs(
        model, images_sam, images_clip, input_ids, attention_mask)
    llm = model.llm
    pipe = getattr(llm, "pipe", None)
    with use_mesh(mesh):
        sp = _prompt(model, images_clip, input_ids, attention_mask)
        cfg = llm.cfg
        if hasattr(llm, "model"):  # LLaMA: this rank's kv heads
            first = llm.model.layers[pipe.lo if pipe is not None else 0]
            cfg = dataclasses.replace(
                cfg, num_kv_heads=first.self_attn.num_kv_heads)
        b, l, _ = sp.embeds.shape
        state = DecodeState(cfg, b, l, max_new_tokens, sp.embeds.device,
                            kv_cache_8bit=kv_cache_8bit)
        llm_fn = model.llm_forward
        if pipe is not None:
            from ..parallel.pipeline import pipelined_decode

            for i in range(len(state.caches)):
                if not pipe.lo <= i < pipe.hi:
                    state.caches[i] = None
            llm_fn = lambda *a: pipelined_decode(llm, *a)  # noqa: E731
        prefill(state, llm_fn, sp.embeds, sp.positions, sp.segment_ids,
                sp.segment_ids.sum(dim=1))
        decode_loop(state, model.embed_tokens, llm_fn, max_new_tokens,
                    eos_id)
        return _finish(model, state.result(), images_sam, max_new_tokens)


def make_mesh_evaluate(model: LisaModel, mesh, max_new_tokens: int,
                       eos_id: int, kv_cache_8bit: bool = False):
    """The evaluate of a model sharded over `mesh` (the train CLI's
    validation on a mesh): `mesh_evaluate_fn` bound to the model and the
    decode settings, with make_jitted_evaluate's call signature. Every
    rank of the mesh calls it on the same inputs."""

    def evaluate(images_sam, images_clip, input_ids, attention_mask):
        return mesh_evaluate_fn(model, mesh, images_sam, images_clip,
                                input_ids, attention_mask, max_new_tokens,
                                eos_id, kv_cache_8bit)

    return evaluate


def _resize_nearest(mask, gh: int, gw: int):
    """Nearest-neighbour binary-mask resample to (gh, gw)."""
    import cv2
    import numpy as np

    return cv2.resize(np.asarray(mask, np.uint8), (gw, gh),
                      interpolation=cv2.INTER_NEAREST)


def validate_on_benchmark(model: LisaModel, tok, val_ds, *,
                          val_batch_size: int = 1,
                          model_max_length: int = 575,
                          conv_type: str = "llava_v1",
                          use_mm_start_end: bool = True,
                          max_new_tokens: int = 32, evaluate=None):
    """Reference validate() protocol (train_ds.py:625-758; port of
    haff_tpu/infer/evaluate.py `validate_on_benchmark`): batched evaluate
    over a benchmark walker (a short last batch padded by repeating its
    last sample), taxonomy-argmax mask gating, binarize at 0, union
    IoU/IoCM per frame; predictions are resized raw to the GT canvas when
    the benchmark keeps GT at another resolution than the frame
    (calculate_iou.py:212-234 convention).

    The model's own weights serve, quantized layers included. `evaluate`
    is a `make_jitted_evaluate(model, max_new_tokens, eos)` to reuse (the
    train CLI keeps one, so its decode graph is captured once and replayed
    in later epochs against the updated weights); by default one is made.
    The model runs in eval mode and returns to the mode it was in.
    Returns (mean IoU, mean IoCM, per-frame list)."""
    import cv2
    import numpy as np

    from ..data.collate import collate_affordance
    from ..eval.metrics import union_metrics
    from ..nn.sam import resize_to_original

    cfg = model.cfg
    ev = evaluate or make_jitted_evaluate(model, max_new_tokens=max_new_tokens,
                                          eos_id=tok.eos_token_id)
    ious, iocms, frames = [], [], []
    VB = max(1, val_batch_size)
    was_training = model.training
    model.eval()
    try:
        for start in range(0, len(val_ds), VB):
            samples = [val_ds[i][0] for i in
                       range(start, min(start + VB, len(val_ds)))]
            pad = VB - len(samples)
            vb = collate_affordance(
                samples + [samples[-1]] * pad, tok,
                sam_image_size=cfg.sam_encoder.image_size,
                clip_image_size=cfg.clip.image_size,
                max_text_len=model_max_length, conv_type=conv_type,
                use_mm_start_end=use_mm_start_end, for_training=False)
            res = ev(vb["images_sam"], vb["images_clip"], vb["input_ids"],
                     vb["attention_mask"])
            ml_all = res.pred_masks_left.float().cpu().numpy()
            mr_all = res.pred_masks_right.float().cpu().numpy()
            tax_all = res.taxonomies.float().cpu().numpy()
            for i, sample in enumerate(samples):
                rh, rw = vb["resizes"][i]
                orig = sample.image.shape[:2]
                ml = resize_to_original(ml_all[i:i + 1], (rh, rw), orig)[0]
                mr = resize_to_original(mr_all[i:i + 1], (rh, rw), orig)[0]
                gl, gr = sample.mask_left, sample.mask_right
                gh, gw = max(gl.shape, gr.shape, key=lambda s: s[0] * s[1])
                # A missing hand comes through as an all-zero mask whose
                # canvas may differ from the other hand's; a real mask at
                # another resolution is resampled, not discarded.
                if gl.shape != (gh, gw):
                    gl = (np.zeros((gh, gw), np.uint8) if not gl.any() else
                          _resize_nearest(gl, gh, gw))
                if gr.shape != (gh, gw):
                    gr = (np.zeros((gh, gw), np.uint8) if not gr.any() else
                          _resize_nearest(gr, gh, gw))
                if tuple(orig) != (gh, gw):
                    ml = cv2.resize(np.asarray(ml, np.float32), (gw, gh))
                    mr = cv2.resize(np.asarray(mr, np.float32), (gw, gh))
                tax = int(np.argmax(tax_all[i]))
                pl_ = (ml > 0).astype(np.uint8)
                pr_ = (mr > 0).astype(np.uint8)
                if tax == 0:
                    pr_[:] = 0
                elif tax == 1:
                    pl_[:] = 0
                m = union_metrics(pl_, pr_, gl, gr)
                ious.append(m["iou"])
                iocms.append(m["iocm"])
                frames.append(dict(iou=m["iou"], iocm=m["iocm"], tax=tax))
    finally:
        model.train(was_training)
    return float(np.mean(ious)), float(np.mean(iocms)), frames
