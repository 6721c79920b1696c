"""LISA through `Predictor.predict_batch` with `traffic.batch` rows a call
(default 1), for either decoder a configuration names: MPT (the `mpt`
section, port.py) or DeepSeek-V3 (the published keys at the top level,
deepseek.py).

Request i is one call of B rows: row r takes frame (i * B + r) of the
cell's pool (cycled) and seeded instruction i * B + r, so at B = 1 the
inputs are lisa_predict_batch's. The timed path is the program's, as
there: collate, the graphed evaluate (CLIP, prefill, the decode replayed
from its CUDA graph, the [SEG] gather, SAM, both decoders) and the
resize of the masks. The benchmark keeps each row's answer: masks,
taxonomy, the served token ids and the hidden state that emitted each,
and with the DeepSeek-V3 decoder the experts its MoE layers chose at
every prompt position and fed token (`GenerateResult.expert_ids`).

The check compares every row of each checked request with the plain
float32 reference (reference/lisa.py or reference/lisa_deepseek_v3.py):
the relative L2 error of the served hidden states and of the masks, the
taxonomy's largest difference; with DeepSeek-V3 also the latent cache
(the largest relative error of a (layer, slot) row the decode wrote,
and of the last prompt slot, `latent_rel_err`) and the routing: where
the program's experts differ from the reference's own top-k, the largest
margin by which a swapped-in expert's choice score lies below the
reference's k-th best (`route_margin_max`; the reference then continues
with the program's experts), and the share of (token, layer) routings
that differ (`route_mismatch_share`, a reading).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from .. import deepseek, port, traffic, weights
from ..reference import lisa as ref_lisa
from ..reference import lisa_deepseek_v3 as ref_lisa_ds
from ..reference import plain_precision
from .lisa_predict_batch import rel_err

WARM = 10 ** 9  # request indices of the warm-up, apart from the window's
MPT_KERNELS = ("sam_window_attn", "sam_global_attn", "flash_prefill",
               "decode_attn", "add_layer_norm")
DS_KERNELS = ("sam_window_attn", "sam_global_attn", "flash_prefill",
              "moe_decode", "mla_decode_attn")


class Driver:
    inner_spans = ("evaluate",)

    def __init__(self, cfg, cell, seed, device, spans):
        self.cfg, self.cell, self.seed = cfg, cell, seed
        self.device, self.spans = device, spans
        self.tr = cell["traffic"]
        self.batch = int(self.tr.get("batch", 1))
        self.ds = deepseek.is_deepseek(cfg)
        self.outputs = {}
        self._last = self._gen = None

    # ---- inputs ----
    def inputs(self, i):
        """(frames, prompts) of request i: B of each."""
        t, b = self.tr, self.batch
        if i < WARM:
            frames = [self.frames[(i * b + r) % len(self.frames)]
                      for r in range(b)]
        else:
            frames = [traffic.frame(self.seed, i * b + r, t["height"],
                                    t["width"]) for r in range(b)]
        return frames, [traffic.prompt(self.seed, i * b + r, t["prompt_chars"])
                        for r in range(b)]

    # ---- set-up ----
    def setup(self):
        self.seg = port.seg_token_index()
        if self.seg != ref_lisa.seg_token_id():
            raise ValueError(f"the program's [SEG] is {self.seg}, the "
                             f"configuration's tokenizer gives "
                             f"{ref_lisa.seg_token_id()}")
        if self.ds:  # the decoder first: a program without it fails at once
            deepseek.lisa_config(self.cfg, self.seg)
        port.build_kernels(self.device, DS_KERNELS if self.ds else MPT_KERNELS)
        t = self.tr
        self.frames = [traffic.frame(self.seed, k, t["height"], t["width"])
                       for k in range(t["frames"])]
        build = deepseek.lisa_model if self.ds else port.lisa_model
        self.model = build(self.cfg, self.seed, self.device, self.seg)
        port.on_generation(self._keep_generation)
        self.bind()

    def _keep_generation(self, gen):
        self._gen = gen

    def bind(self, kv_cache_8bit: bool = False):
        """A Predictor around the model, and the cell's warm-up: its one
        shape (batch B, text padded to the configuration's length), whose
        first call captures the decode graph and second replays it."""
        self.predictor, self.evaluate = port.lisa_predictor(
            self.model, self.cfg, kv_cache_8bit=kv_cache_8bit)

        def capture(*args):
            res = self.evaluate(*args)
            gen = self._gen
            self._last = (res.output_ids, res.gen_lengths, gen.hiddens,
                          getattr(gen, "expert_ids", None),
                          getattr(gen, "latent_caches", None), args[3])
            return res

        self.predictor._eval = capture
        for k in range(2):
            self.predictor.predict_batch(*self.inputs(WARM + k))
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
        frames, texts = self.inputs(i)
        answers = self.predictor.predict_batch(frames, texts)
        # The answer is back on the host; the hidden states and the routing
        # sit in the graph's buffers, which the next request overwrites.
        ids, lengths, hiddens, experts, caches, attention = self._last
        ids, lengths = ids.cpu().numpy(), lengths.cpu().numpy()
        clip = self.cfg["clip"]
        patches = (clip["image_size"] // clip["patch_size"]) ** 2
        # The spliced prompt's length: the image token gives way to the patches.
        prompt = np.asarray(attention).sum(axis=1) - 1 + patches
        rows = []
        for r, (_, ml, mr, tax) in enumerate(answers):
            n = int(lengths[r])
            row = dict(served=ids[r, :n], hidden=hiddens[r, :n].cpu(), ml=ml,
                       mr=mr, tax=tax, prompt_len=int(prompt[r]))
            if experts is not None:
                row["prompt_experts"] = experts[0][r].cpu()
                row["decode_experts"] = experts[1][r].cpu()
            if caches is not None:  # from the last prompt slot on
                p, t = int(prompt[r]), ids.shape[1]
                row["latents"] = torch.stack(
                    [c[r, p - 1:p - 1 + t] for c in caches]).cpu()
            rows.append(row)
        self.outputs[i] = rows

    def longest(self, done):
        lengths = [sum(len(r["served"]) for r in self.outputs[i]) for i in done]
        return done[int(np.argmax(lengths))]

    def priority(self, done):
        """The requests with a row that served [SEG]: its masks are
        prompted by the projected hidden state, the others' by zeros."""
        return [i for i in done
                if any(self.seg in r["served"] for r in self.outputs[i])]

    def flops_per_request(self):
        from ..registry import flops

        cfg = self.cfg
        clip, lisa = cfg["clip"], cfg["lisa"]
        enc, dec = cfg["sam"]["encoder"], cfg["sam"]["decoder"]
        patches = (clip["image_size"] // clip["patch_size"]) ** 2
        prompt = lisa["max_text_len"] + patches - 1
        steps = lisa["max_new_tokens"]
        if self.ds:
            d = cfg["hidden_size"]
            llm = flops("deepseek_v3_generate").count(cfg, prompt, steps)
        else:
            d = cfg["mpt"]["d_model"]
            llm = flops("mpt_generate").count(cfg["mpt"], prompt, steps)
        return self.batch * sum(f["flops"] for f in (
            flops("clip_vit").count(clip, d), llm,
            flops("seg_projection").count(d, lisa["out_dim"]),
            flops("sam_encoder").count(enc),
            flops("sam_decoders").count(enc, dec, prompt_tokens=1)))

    def free(self):
        self.predictor = self.evaluate = self.model = None
        self._last = self._gen = None

    # ---- the check ----
    def _weights(self):
        if self.ds:
            return deepseek.reference_weights(self.cfg, self.seed, self.device,
                                              ref_lisa.seg_token_id())
        spec = weights.lisa_spec(self.cfg)
        return weights.reference_weights(
            spec, self.seed, self.device, port.dtype_of(self.cfg),
            port.seg_special(self.cfg, ref_lisa.seg_token_id()))

    def check(self, sample):
        """Against the reference run over each row's prompt and served
        tokens, every row of each checked request (see the module
        docstring); the widest gap of a served token's logit below the
        reference's best is a reading."""
        plain_precision()
        W = self._weights()
        out = dict(llm_hidden_rel_err=0.0, mask_rel_err=0.0, taxonomy_err=0.0)
        gap_all, segs, rows = [], 0, 0
        route = dict(tokens=0, mismatched=0, margin_max=0.0)
        for i in sample:
            frames, texts = self.inputs(i)
            for r, o in enumerate(self.outputs[i]):
                rows += 1
                segs += int(self.seg in o["served"])
                if self.ds:
                    ref = ref_lisa_ds.evaluate(
                        frames[r], texts[r], o["served"], W, self.cfg,
                        self.device, o["prompt_experts"], o["decode_experts"])
                    route["tokens"] += ref["tokens"]
                    route["mismatched"] += ref["mismatched"]
                    route["margin_max"] = max(route["margin_max"],
                                              ref["margin_max"])
                    out["latent_rel_err"] = max(out.get("latent_rel_err", 0.0),
                                                latent_err(o["latents"],
                                                           ref["latents"],
                                                           self.cfg))
                else:
                    ref = ref_lisa.evaluate(frames[r], texts[r], o["served"], W,
                                            self.cfg, self.device)
                gap_all.append(ref_lisa.gaps(ref["logits"], o["served"]))
                for key, prog, want in (
                        ("llm_hidden_rel_err", o["hidden"], ref["hidden"]),
                        ("mask_rel_err", o["ml"], ref["masks_left"]),
                        ("mask_rel_err", o["mr"], ref["masks_right"])):
                    out[key] = max(out[key], rel_err(prog, want))
                out["taxonomy_err"] = max(out["taxonomy_err"], float(
                    np.abs(np.asarray(o["tax"]) - ref["taxonomy"]).max()))
        del W
        print(f"[SEG] served in {segs} of {rows} checked rows", file=sys.stderr)
        g = np.concatenate(gap_all)
        out.update(token_gap=float(g.max()),
                   token_mismatch_share=float((g > 0).mean()))
        if self.ds:
            out.update(route_margin_max=route["margin_max"],
                       route_mismatch_share=(route["mismatched"]
                                             / max(route["tokens"], 1)))
        return out


def latent_err(prog, ref, cfg) -> float:
    """The largest ||prog - ref|| / ||ref|| over the (layer, slot) rows
    of the latent cache that the reference also computes: prog (layers,
    T, R + P) as the program cached it, k_pe in rotated pairs; ref
    (layers, n, R + P), k_pe in the published layout (pairs (2i, 2i+1)
    at i and i + P/2)."""
    r = cfg["kv_lora_rank"]
    n = min(prog.shape[1], ref.shape[1])
    prog = prog[:, :n].float().to(ref.device)
    perm = torch.cat([torch.arange(r), r + torch.arange(0, prog.shape[-1] - r, 2),
                      r + torch.arange(1, prog.shape[-1] - r, 2)]).to(ref.device)
    prog = prog[..., perm]
    err = (prog - ref[:, :n]).norm(dim=-1) / ref[:, :n].norm(dim=-1).clamp_min(1e-30)
    return float(err.max())
