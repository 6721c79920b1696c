"""Video-clip streaming inference: a clip -> per-frame bimanual masks
(port of haff_tpu/infer/streaming.py).

Raw frames go to the model's device whole; resize, pad and normalize run
there (data/transforms.device_*). A background thread stages the next
chunk (padding, and on the card a pinned host copy and an asynchronous
upload on a stream of its own) while the current one computes. The prompt
is tokenized once per clip (one narration, the same prompt for every
frame). Evaluation goes through infer/evaluate.py make_jitted_evaluate:
on the card the chunk's decode loop is a CUDA graph, captured at the
first chunk and replayed for the others.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch


class StreamingPipeline:
    def __init__(self, model, tokenizer, narration: str, chunk: int = 8,
                 max_new_tokens: int = 16, max_text_len: int = 320):
        """`model`: a LisaModel on its device (the card, or the CPU)."""
        from ..data.collate import tokenize_conversation
        from ..data.prompts import INFERENCE_QUESTION
        from .evaluate import make_jitted_evaluate

        self.chunk = chunk
        self.model = model
        cfg = model.cfg
        # Same prompt convention as the batch CLI: bare tokenization,
        # narration casing kept.
        q = INFERENCE_QUESTION.format(class_name=narration)
        ids, _ = tokenize_conversation(q, None, tokenizer, use_template=False)
        ids = ids[:max_text_len]
        input_ids = np.zeros((chunk, max_text_len), np.int64)
        attn = np.zeros((chunk, max_text_len), np.int64)
        input_ids[:, :len(ids)] = ids
        attn[:, :len(ids)] = 1
        self._ids = torch.as_tensor(input_ids, device=model.device)
        self._attn = torch.as_tensor(attn, device=model.device)
        self._S = cfg.sam_encoder.image_size
        self._C = cfg.clip.image_size
        self._eval = make_jitted_evaluate(model, max_new_tokens,
                                          tokenizer.eos_token_id)
        self._upload = (torch.cuda.Stream(model.device)
                        if model.device.type == "cuda" else None)

    def step(self, frames):
        """frames (chunk, H, W, 3) uint8 on the model's device -> (masks
        left, masks right, taxonomies) on the canvas, on the device."""
        from ..data.transforms import (device_clip_preprocess,
                                       device_sam_preprocess)

        sam_in, _ = device_sam_preprocess(frames, self._S)
        clip_in = device_clip_preprocess(frames, self._C)
        res = self._eval(sam_in, clip_in, self._ids, self._attn)
        return res.pred_masks_left, res.pred_masks_right, res.taxonomies

    def _stage(self, block: np.ndarray):
        """A chunk on its way to the device: (tensor, event or None)."""
        if self._upload is None:
            return torch.from_numpy(block), None
        with torch.cuda.stream(self._upload):
            t = torch.from_numpy(block).pin_memory().to(self.model.device,
                                                        non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        return t, done

    def run(self, frames: np.ndarray) -> Iterator[dict]:
        """frames: (N, H, W, 3) uint8 RGB, one H and W per clip. Yields a
        dict per chunk with canvas-space mask logits and the taxonomy (host
        numpy, the padding of the last chunk dropped); a thread keeps the
        next chunk staged while the device computes."""
        from ..data.transforms import get_preprocess_shape

        n = frames.shape[0]
        h, w = frames.shape[1:3]
        rh, rw = get_preprocess_shape(h, w, self._S)
        q: queue.Queue = queue.Queue(maxsize=2)

        def feed():
            try:
                for s in range(0, n, self.chunk):
                    block = frames[s:s + self.chunk]
                    pad = self.chunk - block.shape[0]
                    if pad:
                        block = np.concatenate(
                            [block, np.repeat(block[-1:], pad, 0)])
                    q.put((s, *self._stage(np.ascontiguousarray(block)),
                           block.shape[0] - pad))
                q.put(None)
            except BaseException as e:  # hand the failure to the consumer
                q.put(e)

        threading.Thread(target=feed, daemon=True).start()
        while True:
            item = q.get()
            if item is None:
                return
            if isinstance(item, BaseException):
                raise item
            start, block, ready, valid = item
            if ready is not None:
                torch.cuda.current_stream().wait_event(ready)
                block.record_stream(torch.cuda.current_stream())
            ml, mr, tax = self.step(block)
            host = lambda t: t[:valid].float().cpu().numpy()  # noqa: E731
            yield dict(start=start, masks_left=host(ml),
                       masks_right=host(mr), taxonomies=host(tax),
                       resize_hw=(rh, rw))
