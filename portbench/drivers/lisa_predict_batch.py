"""LISA with the MPT decoder through `Predictor.predict_batch`: one seeded
frame and one seeded bimanual instruction a request, batch 1.

The timed path is the program's: collate (tokenizer, SAM and CLIP
preprocessing), the graphed evaluate (CLIP tower and splice, the MPT
prefill, the 32-step decode replayed from its CUDA graph, the [SEG]
gather and projection, the SAM encoder, both mask decoders) and the
resize of the masks to the frame. The benchmark keeps each answer: the
masks and taxonomy `predict_batch` returns, the token ids its evaluate
served (read off the evaluate's result, which the returned text drops
when an id lies outside the byte tokenizer's range) and the hidden state
that emitted each served token (the prefill's for the first, the
replayed decode's for the rest).
"""

from __future__ import annotations

import sys

import numpy as np

from .. import port, traffic, weights
from ..reference import lisa as ref_lisa
from ..reference import plain_precision

WARM = 10 ** 9  # request indices of the warm-up, apart from the window's
KERNELS = ("sam_window_attn", "sam_global_attn", "flash_prefill",
           "decode_attn")


class Driver:
    inner_spans = ("evaluate",)

    def __init__(self, cfg, cell, seed, device, spans):
        self.cfg, self.cell, self.seed = cfg, cell, seed
        self.device, self.spans = device, spans
        self.tr = cell["traffic"]
        self.outputs = {}
        self._last = self._gen = None

    # ---- inputs ----
    def inputs(self, i):
        t = self.tr
        frame = self.frames[i % len(self.frames)] if i < WARM else \
            traffic.frame(self.seed, i, t["height"], t["width"])
        return frame, traffic.prompt(self.seed, i, t["prompt_chars"])

    # ---- set-up ----
    def setup(self):
        port.build_kernels(self.device, KERNELS)
        t = self.tr
        self.frames = [traffic.frame(self.seed, k, t["height"], t["width"])
                       for k in range(t["frames"])]
        self.seg = port.seg_token_index()
        if self.seg != ref_lisa.seg_token_id():
            raise ValueError(f"the program's [SEG] is {self.seg}, the "
                             f"configuration's tokenizer gives "
                             f"{ref_lisa.seg_token_id()}")
        self.model = port.lisa_model(self.cfg, self.seed, self.device, self.seg)
        port.on_generation(self._keep_generation)
        self.bind()

    def _keep_generation(self, gen):
        self._gen = gen

    def bind(self, kv_cache_8bit: bool = False):
        """A Predictor around the model, and the cell's warm-up: its one
        shape (batch 1, text 320), whose first call captures the decode
        graph and second replays it."""
        self.predictor, self.evaluate = port.lisa_predictor(
            self.model, self.cfg, kv_cache_8bit=kv_cache_8bit)

        def capture(*args):
            res = self.evaluate(*args)
            self._last = (res.output_ids, res.gen_lengths, self._gen.hiddens)
            return res

        self.predictor._eval = capture
        for k in range(2):
            self.predictor.predict_batch(*map(lambda x: [x], self.inputs(WARM + k)))
        self.outputs.clear()

    def install_spans(self):
        s = self.spans
        s.wrap(self.predictor, "_eval", "evaluate", sync=True)
        if hasattr(self.evaluate, "_replay"):
            s.wrap(self.evaluate, "_replay", "decode_replay", device=True,
                   per=self.cfg["lisa"]["max_new_tokens"])
        s.hook(self.model.visual_model.image_encoder, "sam_encoder")

    # ---- the window ----
    def request(self, i):
        frame, text = self.inputs(i)
        _, ml, mr, tax = self.predictor.predict_batch([frame], [text])[0]
        # The answer is back on the host; the hidden states sit in the
        # graph's buffer, which the next request overwrites.
        ids, lengths, hiddens = self._last
        n = int(lengths[0])
        self.outputs[i] = dict(served=ids[0, :n].cpu().numpy(),
                               hidden=hiddens[0, :n].cpu(), ml=ml, mr=mr,
                               tax=tax)

    def longest(self, done):
        lengths = [len(self.outputs[i]["served"]) for i in done]
        return done[int(np.argmax(lengths))]

    def priority(self, done):
        """The requests that served [SEG]: their masks are prompted by the
        projected hidden state, the others' by zeros."""
        return [i for i in done if self.seg in self.outputs[i]["served"]]

    def flops_per_request(self):
        from ..registry import flops

        cfg = self.cfg
        mpt, clip, lisa = cfg["mpt"], cfg["clip"], cfg["lisa"]
        enc, dec = cfg["sam"]["encoder"], cfg["sam"]["decoder"]
        patches = (clip["image_size"] // clip["patch_size"]) ** 2
        prompt = lisa["max_text_len"] + patches - 1
        return sum(f["flops"] for f in (
            flops("clip_vit").count(clip, mpt["d_model"]),
            flops("mpt_generate").count(mpt, prompt, lisa["max_new_tokens"]),
            flops("seg_projection").count(mpt["d_model"], lisa["out_dim"]),
            flops("sam_encoder").count(enc),
            flops("sam_decoders").count(enc, dec, prompt_tokens=1)))

    def free(self):
        self.predictor = self.evaluate = self.model = None
        self._last = self._gen = None

    # ---- the check ----
    def check(self, sample):
        """Against the reference run over each checked request's prompt
        and served tokens: the relative L2 error of the hidden states that
        emitted the served tokens (the prefill's and every decode step's)
        and of the masks at the frame's size,
        the taxonomy's largest difference, and the widest gap of a served
        token's logit below the reference's best (a reading)."""
        plain_precision()
        spec = weights.lisa_spec(self.cfg)
        W = weights.reference_weights(spec, self.seed, self.device,
                                      port.dtype_of(self.cfg),
                                      port.seg_special(self.cfg,
                                                       ref_lisa.seg_token_id()))
        out = dict(llm_hidden_rel_err=0.0, mask_rel_err=0.0, taxonomy_err=0.0)
        gap_all, segs = [], 0
        for i in sample:
            o = self.outputs[i]
            segs += int(self.seg in o["served"])
            frame, text = self.inputs(i)
            ref = ref_lisa.evaluate(frame, text, o["served"], W, self.cfg,
                                    self.device)
            gap_all.append(ref_lisa.gaps(ref["logits"], o["served"]))
            for key, prog, want in (
                    ("llm_hidden_rel_err", o["hidden"], ref["hidden"]),
                    ("mask_rel_err", o["ml"], ref["masks_left"]),
                    ("mask_rel_err", o["mr"], ref["masks_right"])):
                out[key] = max(out[key], rel_err(prog, want))
            out["taxonomy_err"] = max(out["taxonomy_err"], float(
                np.abs(np.asarray(o["tax"]) - ref["taxonomy"]).max()))
        del W
        print(f"[SEG] served in {segs} of {len(sample)} checked requests",
              file=sys.stderr)
        g = np.concatenate(gap_all)
        out.update(token_gap=float(g.max()),
                   token_mismatch_share=float((g > 0).mean()))
        return out


def rel_err(prog, ref) -> float:
    """||prog - ref|| / ||ref|| over all the entries of an output."""
    as64 = lambda x: (x.detach().double().cpu().numpy()  # noqa: E731
                      if hasattr(x, "detach") else np.asarray(x, np.float64))
    prog, ref = as64(prog), as64(ref)
    return float(np.linalg.norm(prog - ref) / max(np.linalg.norm(ref), 1e-30))

