"""Single-frame and batched predictor shared by the server, streaming,
chat, app and robot entry points (port of haff_tpu/infer/predictor.py).

    predictor(image_rgb_uint8, text_prompt) ->
        (answer_text, mask_left_logits, mask_right_logits, taxonomy)

with masks at the frame's original resolution. The model runs on
`device`: the card unless the caller asks for the CPU. Evaluation goes
through infer/evaluate.py make_jitted_evaluate, so on the card each batch
shape captures its decode loop in a CUDA graph once and replays it after.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from ..utils.profiling import span


def _require_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port's entry points run on the "
                           "card unless asked for the CPU (device='cpu', "
                           "--device cpu)")
    return device


def load_model(cfg, precision: str = "bf16", device="cuda",
               checkpoint: Optional[str] = None, load_in_8bit: bool = False,
               load_in_4bit: bool = False):
    """The serving LisaModel on `device`: seeded random weights (its
    generator); or `checkpoint`, either the flat .npz that
    haff_tpu/tools/export_params.py writes (loaded through
    tools/bridge.py), or a `ckpt_model` directory (or one step of it) that
    the port's train CLI wrote (train/checkpoints.py
    `load_trained_model`: the run's model rebuilt, its trained tensors
    loaded). `load_in_8bit` then quantizes the SAM encoder and LLM
    projections to int8 (W8A8), `load_in_4bit` the LLM projections to
    packed int4 (W4A16), in place."""
    from ..model.lisa import LisaModel

    dtype = torch.bfloat16 if precision == "bf16" else torch.float32
    device = _require_device(device)
    if checkpoint and os.path.isdir(checkpoint):
        from ..train.checkpoints import load_trained_model

        model = load_trained_model(checkpoint, cfg, precision, device)
    else:
        model = LisaModel(cfg, dtype, device=device)
    if checkpoint and not os.path.isdir(checkpoint):
        if not checkpoint.endswith(".npz"):
            raise NotImplementedError(
                f"{checkpoint}: neither an export .npz nor a checkpoint "
                "directory of the port's train CLI; export the parameters "
                "to an .npz with haff_tpu/tools/export_params.py")
        from ..tools.bridge import load_jax_params

        load_jax_params(model, checkpoint)
    if load_in_4bit or load_in_8bit:
        from ..nn import quant

        if load_in_4bit:
            quant.quantize_model_(model, quant.default_llm_predicate, bits=4)
        else:
            quant.quantize_model_(model, quant.lisa_serving_predicate)
    return model


class Predictor:
    def __init__(self, model_preset: str = "7b",
                 decoder: str = "llama",
                 checkpoint: Optional[str] = None,
                 tokenizer: Optional[str] = None, precision: str = "bf16",
                 max_new_tokens: int = 32, max_text_len: int = 320,
                 load_in_8bit: bool = False, load_in_4bit: bool = False,
                 kv_cache_8bit: bool = False,
                 conv_type: str = "llava_v1",
                 use_mm_start_end: bool = True,
                 use_template: bool = True,
                 speculative: bool = False,
                 draft_len: int = 8,
                 device="cuda"):
        """Weights and quantization as `load_model` says; `device` is the
        card unless the caller asks for the CPU. `speculative` decodes by
        prompt lookup over the ANSWER_LIST templates, `draft_len` tokens a
        verify step (LLaMA decoder only: MPT raises ValueError).
        `decoder="deepseek_v3"` serves the DeepSeek-V3 decoder
        (nn/deepseek_v3.py): `model_preset` "moonlight" is
        Moonlight-16B-A3B with CLIP ViT-L/14 and SAM ViT-H, "tiny" the
        test size; no speculation, int8 cache or 8/4-bit loading."""
        from ..core.config import ModelConfig
        from ..data.tokenizer import load_tokenizer, seg_token_idx
        from .evaluate import make_jitted_evaluate

        self.tok = load_tokenizer(tokenizer, model_max_length=max_text_len)
        if decoder == "deepseek_v3":
            from ..nn.deepseek_v3 import model_config

            if speculative or kv_cache_8bit or load_in_8bit or load_in_4bit:
                raise ValueError(
                    "the deepseek_v3 decoder serves in bf16 or fp32 over its "
                    "latent cache: no speculative decoding, int8 cache or "
                    "8/4-bit loading")
            self.cfg = model_config(model_preset,
                                    seg_token_idx=seg_token_idx(self.tok))
        else:
            self.cfg = ModelConfig.preset(model_preset).replace(
                seg_token_idx=seg_token_idx(self.tok), decoder=decoder)
        self.max_text_len = max_text_len
        self.conv_type = conv_type
        self.use_mm_start_end = use_mm_start_end
        self.use_template = use_template
        corpus = lens = None
        if speculative:
            # Prompt-lookup speculative decoding drafted from the
            # ANSWER_LIST templates: the greedy output in fewer decode
            # forwards (infer/generate.py speculative_generate).
            if decoder == "mpt":
                raise ValueError(
                    "speculative decoding requires the llama decoder "
                    "(the MPT attention has no chunked cache-verify "
                    "mode)")
            from .generate import answer_template_corpus

            corpus, lens = answer_template_corpus(self.tok)
        self.model = load_model(self.cfg, precision, device, checkpoint,
                                load_in_8bit, load_in_4bit)
        self._eval = make_jitted_evaluate(
            self.model, max_new_tokens=max_new_tokens,
            eos_id=self.tok.eos_token_id, kv_cache_8bit=kv_cache_8bit,
            draft_corpus=corpus, corpus_lengths=lens, draft_len=draft_len)

    def predict_batch(self, images, prompts):
        """Lists of RGB uint8 frames and text prompts -> list of (answer,
        mask_left, mask_right, taxonomy), masks at each frame's original
        resolution. One evaluate per call: the micro-batching entry that
        infer/server.py uses (a batch size is one graph bucket). Spans
        (utils/profiling.py): `predictor.collate`, `.evaluate`, `.fetch`
        (the copies to the host, which wait for the card) and `.post`."""
        from ..data.collate import Sample, collate_affordance
        from ..nn.sam import resize_to_original

        with span("predictor.collate"):
            samples = [
                Sample(image=img,
                       question=(p if "<image>" in p else ("<image>\n" + p)),
                       answer=None)
                for img, p in zip(images, prompts)]
            batch = collate_affordance(
                samples, self.tok,
                sam_image_size=self.cfg.sam_encoder.image_size,
                clip_image_size=self.cfg.clip.image_size,
                max_text_len=self.max_text_len, conv_type=self.conv_type,
                use_mm_start_end=self.use_mm_start_end,
                use_template=self.use_template, for_training=False)
        with span("predictor.evaluate"):
            res = self._eval(batch["images_sam"], batch["images_clip"],
                             batch["input_ids"], batch["attention_mask"])
        with span("predictor.fetch"):
            host = lambda t: t.float().cpu().numpy()  # noqa: E731
            out_ids = res.output_ids.cpu().numpy()
            gen_lengths = res.gen_lengths.cpu().numpy()
            ml_all = host(res.pred_masks_left)
            mr_all = host(res.pred_masks_right)
            tax_all = host(res.taxonomies)
        results = []
        with span("predictor.post"):
            for i, img in enumerate(images):
                text = self.tok.decode(
                    [t for t in out_ids[i][:int(gen_lengths[i])] if t >= 0])
                rh, rw = batch["resizes"][i]
                orig = img.shape[:2]
                ml = resize_to_original(ml_all[i:i + 1], (rh, rw), orig)[0]
                mr = resize_to_original(mr_all[i:i + 1], (rh, rw), orig)[0]
                results.append((text, ml, mr, tax_all[i]))
        return results

    def __call__(self, image: np.ndarray, prompt: str
                 ) -> Tuple[str, np.ndarray, np.ndarray, np.ndarray]:
        return self.predict_batch([image], [prompt])[0]
