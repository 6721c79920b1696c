"""The evaluate() API: text + image -> (output tokens, left/right
affordance masks, taxonomy) (port of haff_tpu/infer/evaluate.py
`evaluate_fn`, `make_jitted_evaluate` and `validate_on_benchmark`,
greedy decode).

Generate with hidden-state capture, gather the first emitted [SEG]'s
hidden state, project it, prompt both SAM mask decoders with it, and
upsample the masks to the padded square canvas. Resizing to each frame's
original size is host-side (nn/sam.py resize_to_original).

`make_jitted_evaluate` is the counterpart of JAX's compiled static-shape
evaluate: on a CUDA model the decode loop, one LLaMA forward a token, is
captured in a CUDA graph once per bucket (batch, prompt length, new
tokens, cache kind) and replayed on every later call of that bucket; the
CLIP tower, the prefill, the SAM encoder and the mask decode run eagerly.
`validate_on_benchmark` scores a benchmark folder with it (the train
CLI's per-epoch validation).
"""

from __future__ import annotations

import collections
import functools
from typing import NamedTuple

import torch

from ..kernels import _build
from ..model.lisa import LisaModel
from ..model.multimodal import find_image_position, splice_image_embeddings
from ..nn.sam import postprocess_masks_padded
from .generate import DecodeState, decode_loop, greedy_generate, prefill


class EvaluateResult(NamedTuple):
    output_ids: torch.Tensor        # (B, T) generated tokens
    gen_lengths: torch.Tensor       # (B,)
    pred_masks_left: torch.Tensor   # (B, S, S) canvas logits, float32
    pred_masks_right: torch.Tensor  # (B, S, S)
    taxonomies: torch.Tensor        # (B, 4) softmax probabilities
    seg_found: torch.Tensor         # (B,) bool: a [SEG] was emitted


def _inputs(model, images_sam, images_clip, input_ids, attention_mask):
    """Tensors (or numpy arrays) -> tensors on the model's device."""
    as_t = lambda x: torch.as_tensor(x, device=model.device)  # noqa: E731
    return (as_t(images_sam), as_t(images_clip), as_t(input_ids).long(),
            as_t(attention_mask))


def _prompt(model, images_clip, input_ids, attention_mask):
    """CLIP tower, token embeddings and the multimodal splice."""
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
        taxonomies=taxonomy, seg_found=seg_found)


@torch.inference_mode()
def evaluate_fn(model: LisaModel, images_sam, images_clip, input_ids,
                attention_mask, max_new_tokens: int, eos_id: int,
                kv_cache_8bit: bool = False) -> EvaluateResult:
    """images_sam (B, S, S, 3) and images_clip (B, C, C, 3) preprocessed
    NHWC; input_ids (B, L) with IMAGE_TOKEN_INDEX; attention_mask (B, L),
    1 = real token (right padding). Inputs (tensors or numpy) are moved to
    the model's device; the result stays there. `kv_cache_8bit` decodes
    over an int8 KV cache."""
    images_sam, images_clip, input_ids, attention_mask = _inputs(
        model, images_sam, images_clip, input_ids, attention_mask)
    sp = _prompt(model, images_clip, input_ids, attention_mask)
    gen = greedy_generate(
        model.cfg.llama, model.embed_tokens, model.llm_forward, sp.embeds,
        sp.positions, sp.segment_ids, sp.segment_ids.sum(dim=1),
        max_new_tokens, eos_id, kv_cache_8bit=kv_cache_8bit)
    return _finish(model, gen, images_sam, max_new_tokens)


class GraphedEvaluate:
    """evaluate_fn with the decode loop in a CUDA graph per bucket.

    The first call of a bucket allocates its DecodeState, runs the
    prefill, runs this call's decode loop eagerly on a side stream (the
    warm-up: every kernel library is loaded and every lazy handle made
    before capture), then captures the loop with torch.cuda.CUDAGraph.
    Every later call of the bucket zeroes its caches, runs the prefill
    into them and replays the graph. A capture or replay error raises;
    nothing falls back to the eager loop.

    Launch counting: the kernels' wrappers count in Python, so they count
    while the graph is captured, when nothing runs, and not when it is
    replayed. The counts the capture added are taken back out of
    `_build.LAUNCHES` and kept (`decode_launches`), and each replay adds
    them once: a graphed call counts exactly what an eager one does.
    `captures` and `replays` count the graphs captured and replayed."""

    def __init__(self, model: LisaModel, max_new_tokens: int, eos_id: int,
                 kv_cache_8bit: bool = False):
        self.model = model
        self.max_new_tokens = max_new_tokens
        self.eos_id = eos_id
        self.kv_cache_8bit = kv_cache_8bit
        self._buckets = {}  # key -> (DecodeState, CUDAGraph, launches)
        self.captures = 0
        self.replays = 0

    def _decode(self, state):
        decode_loop(state, self.model.embed_tokens, self.model.llm_forward,
                    self.max_new_tokens, self.eos_id)

    def _capture(self, state):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            self._decode(state)  # this call's decode loop: the warm-up
        torch.cuda.current_stream().wait_stream(side)
        before = collections.Counter(_build.LAUNCHES)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            self._decode(state)
        delta = collections.Counter(_build.LAUNCHES)
        delta.subtract(before)
        delta = +delta  # the launches of one decode loop
        _build.LAUNCHES.subtract(delta)  # nothing ran while capturing
        self.captures += 1
        return graph, delta

    @torch.inference_mode()
    def __call__(self, images_sam, images_clip, input_ids,
                 attention_mask) -> EvaluateResult:
        model = self.model
        images_sam, images_clip, input_ids, attention_mask = _inputs(
            model, images_sam, images_clip, input_ids, attention_mask)
        sp = _prompt(model, images_clip, input_ids, attention_mask)
        key = (*input_ids.shape, self.max_new_tokens, self.kv_cache_8bit)
        bucket = self._buckets.get(key)
        if bucket is None:
            state = DecodeState(model.cfg.llama, input_ids.shape[0],
                                sp.embeds.shape[1], self.max_new_tokens,
                                model.device, kv_cache_8bit=self.kv_cache_8bit)
        else:
            state = bucket[0]
            state.reset_caches()
        prefill(state, model.llm_forward, sp.embeds, sp.positions,
                sp.segment_ids, sp.segment_ids.sum(dim=1))
        if bucket is None:
            self._buckets[key] = (state, *self._capture(state))
        else:
            bucket[1].replay()
            _build.LAUNCHES.update(bucket[2])
            self.replays += 1
        return _finish(model, state.result(), images_sam,
                       self.max_new_tokens)

    def decode_launches(self):
        """{bucket key: the launches one replay of its graph adds}."""
        return {key: dict(b[2]) for key, b in self._buckets.items()}


def make_jitted_evaluate(model: LisaModel, max_new_tokens: int, eos_id: int,
                         kv_cache_8bit: bool = False):
    """A callable (images_sam, images_clip, input_ids, attention_mask) ->
    EvaluateResult, with evaluate_fn's inputs and result: on a CUDA model
    a GraphedEvaluate (the decode loop captured in a CUDA graph per
    bucket), on a CPU model evaluate_fn itself bound to `model` and the
    decode settings. The JAX function's external-scales quantization
    (`quant_scales`) is not ported; quantize the model in place instead
    (nn/quant.quantize_model_)."""
    if model.device.type == "cuda":
        return GraphedEvaluate(model, max_new_tokens, eos_id, kv_cache_8bit)
    return functools.partial(evaluate_fn, model,
                             max_new_tokens=max_new_tokens, eos_id=eos_id,
                             kv_cache_8bit=kv_cache_8bit)


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
