"""Smoke run of the PyTorch/CUDA port (haff_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):

1. device: requires CUDA; prints the card (nvidia-smi name, power limit).
2. build: compiles haff_tpu_torch/kernels/csrc/*.cu (one nvcc per source,
   in parallel) and prints build seconds and ptxas register/smem use.
3. kernels: each hand-written kernel against its plain PyTorch version
   at the shapes its path gives it (the 7b preset's evaluate(), quantized
   evaluates and train step; SAM ViT-B and the small preset for the
   predictor; the audit's shapes for the fused-operand and per-head SAM
   entries; 2048^3 for the matmul probe), in bfloat16, compared in
   float32 (the integer products bit for bit); times the kernel, the
   plain version and one PyTorch library call computing the same function
   (CUDA events, after warm-up). Each SAM record, the three flash
   records and each w8a8 and w4a16 shape also name the kernel path the
   wrapper chose (`path`: wgmma, mma.sync, mma, skinny or scalar; the
   w4a16 shapes also time torch.matmul on the dequantized bf16 weight,
   `bf16_graph_ms`). Among the shapes: the flash forward with MPT-7B's
   ALiBi column bias (2, 575, 32, 128), the decode kernel's ALiBi variant
   (per-head slopes) over the bf16 and int8 caches, and the w8a8 product
   at MPT-7B's shapes (Wqkv N = 12288, up N = 16384, down K = 16384; M =
   2 and 1150) and at a speculative verify step's M = 16; every record but
   the probe's times the kernel and its library yardstick once more as
   CUDA graphs (`graph_ms`, `library_graph_ms`: device time without the
   host's launch cost).
3b. backward: the SAM attention entries' gradients at ViT-H shapes against
   autograd through the plain version, the global entry's rel-pos tables
   exactly zero; then the ViT-H image encoder alone, forward and backward
   at batch 1 in bfloat16 with remat: finite gradients on every parameter
   but the global blocks' tables, exact launch counts, time, peak memory.
4. tiny: evaluate() at the tiny preset in float32 on the card (kernels)
   against the same weights on the CPU (plain versions), three times:
   float weights, int8 weights with the int8 KV cache, and packed-int4
   weights at group 16: identical tokens, masks and taxonomy within 1e-3.
4c. spec small: speculative decode at the small preset with the trained
   weights in float32, three modes (float, W8A8 LLM + int8 cache, W4A16),
   the verify step captured in a CUDA graph on the card, against the CPU
   and against greedy on both: junk, oracle and template corpora and an
   EOS inside an accepted chunk; tokens, lengths and decode steps
   identical, masks within 1e-3, the oracle in <= ceil(T / D) + 1 steps.
4e. moe small (moe_small_vs_cpu): the small preset with MoE MLPs in every
   layer (4 experts, top-2), float32, seeded weights, card against CPU in
   three modes (float, W8A8 LLM + int8 cache, W4A16 at group 16): greedy
   (eager, graphed) and speculative (oracle corpus, graphed verify) with
   identical tokens, lengths and steps, masks within 1e-4 (float) or 1e-3;
   the quantized products launch, routers and experts stay float.
4d. mpt tiny: the MPT decoder at tiny in float32, card (eager and
   graphed) against CPU, float and int8 cache: identical tokens, masks
   within 1e-4, every decode launch on the ALiBi variant.
4b. tiny serving: the Predictor (three calls: the decode graph's capture
   and two replays), one HTTP answer through the MicroBatcher and the
   handler, and StreamingPipeline (5 frames, chunks of 2) at tiny in
   float32 on the card against the CPU from the same weights: identical
   text, logits and taxonomy within 1e-3, the HTTP masks equal but where a
   CPU logit lies within 1e-3 of the threshold's. Then infer/cli.py main
   at small with artifacts/overfit_small_params.npz over a 2-frame
   benchmark folder it writes under runs/, once with --device cuda and
   once with --device cpu: the same PNGs but at pixels whose CPU logit
   lies within 1e-3 of a threshold's logit.
5. tiny train: the LoRA train step (rank 2) at the tiny preset in float32
   on the card against the CPU from the same weights and batch: every
   trainable gradient, 3 steps' metrics and the updated trainable
   parameters within 1e-3, frozen parameters bit-identical.
5b. small: evaluate() at the small preset with the trained weights of
   artifacts/overfit_small_params.npz on the card against the CPU
   (identical tokens, masks within 1e-3), and 3 train steps with the SAM
   encoder unfrozen on the card against the CPU within 1e-3. Then the
   bf16 SAM encoder at small on the card against haff_tpu's bf16 and
   float32 outputs (artifacts/sam_small_encoder_reference.npz): at most
   twice the JAX bf16 output's distance to the float32 one.
6. slice: evaluate() at the full 7b preset (LLaMA-7B, CLIP ViT-L/14,
   SAM ViT-H) in bfloat16 with seeded random weights, 2 batches of 2
   requests (prompt 320, 16 new tokens); checks shapes, finiteness and the
   per-evaluate launch counts of the kernels (decode attention included),
   prints per-batch latency and peak memory; profiles one call.
7. quantized slices: the same model quantized in place, once with int8
   weights (SAM encoder and LLM projections, W8A8) and the int8 KV cache,
   once with packed-int4 LLM projections (W4A16, group 64), each freed
   before the next: the same requests and checks, the exact launch count
   of all six serving kernels per evaluate (the w8a8 and w4a16 counts
   derived from the model), no selected layer left with a float weight;
   prints weight bytes, latency, peak memory; profiles one call.
   In each of the three modes the same requests then go through
   make_jitted_evaluate (the decode loop captured in a CUDA graph): one
   capture call and two replays, tokens equal to the eager call's, masks
   and taxonomy within one bf16 ulp (printed: bit-identical or not), the
   same launches per call as eager and none on a scalar path; prints
   eager and graphed latency and profiles one replayed call.
7c. speculative (evaluate_spec_bf16, evaluate_spec_w8a8): on the bf16 and
   the w8a8 model, make_jitted_evaluate(draft_corpus=...) with 8 tokens a
   verify step, one verify step captured in a CUDA graph and replayed
   while a row is live; the oracle corpus (greedy's tokens) and the
   ByteTokenizer answer templates, a capture call and two replays each:
   launches exactly as derived from the decode steps, the tokens equal to
   greedy's or parting only where greedy's top-2 logit gap is within 2^-6
   of the top logit; latency beside greedy's, steps, tokens a step, one
   profiled replayed call.
7d. MPT-7B (evaluate_mpt_bf16, evaluate_mpt_w8a8): ModelConfig("7b") with
   decoder="mpt", bf16 and W8A8 + int8 cache, each model freed before the
   next: as phase 6-7 (eager and graphed), the prefill's flash launches
   with the ALiBi bias, 480 decode launches an evaluate all on the ALiBi
   variant (`decode_attn/alibi`), the w8a8 count derived from the model;
   weight bytes and peak memory.
7e. MoE-7B (evaluate_moe_bf16, evaluate_spec_moe_bf16): the 7b preset with
   MoE MLPs (MOE_7B: 8 experts, top-2, every other layer, capacity factor
   1.25; ~21.9 B decoder parameters, built on the card), bf16: as phase 6
   (2 eager calls, PER_EVALUATE launches each), then graphed (a capture
   call and two replays, equal to eager) and speculative (oracle and
   template corpora, 8 tokens a verify step: launches derived from the
   decode steps, tokens against greedy's with the 2^-6 top-2-gap rule);
   weight bytes, peak memory, latencies, profiled calls.
7b. serve_bf16 and stream: a 7b bf16 Predictor (seeded weights, 16 new
   tokens, prompt 320) behind MicroBatcher(batch_size=2) and the HTTP
   handler on 127.0.0.1: four concurrent POST /predict with seeded
   720 x 1280 PNG frames in two batches; the JSON keys, masks decoded at
   720 x 1280, taxonomies summing to 1, PER_EVALUATE launches a batch,
   per-request latency. Then StreamingPipeline on the same model over a
   seeded 5-frame 720 x 1280 clip in chunks of 2 (the last padded):
   shapes, finiteness and PER_EVALUATE launches a chunk.
8. train slice: make_train_step at the full 7b preset with LoRA rank 8 on
   q/v, bf16 compute, remat, batch 2 (prompt 320 spliced to 575), 6 steps
   on one batch: finite losses, falling loss, frozen weights unchanged,
   trainable ones changed, per-step launch counts; prints step time and
   peak memory; profiles one step.

8b. train CLI, tiny: haff_tpu_torch.train.cli.main at tiny in float32 on a
   4-frame ReasonSeg folder (the card has no h5py for 2HANDS shards) and
   a 2-frame benchmark folder it writes under runs/, --device cuda against --device cpu from the same initial weights
   in three weight modes (float, --load_in_8bit, --load_in_4bit), 2 epochs
   of one step with a validation after each: per-step losses within 1e-3,
   validation IoU / IoCM equal (or apart only through pixels whose CPU
   logit lies within 1e-3 of 0), checkpointed trainable tensors within
   1e-3; the decode graph captured at the first validation and replayed
   after a training step equal to an eager evaluate on the updated
   weights.
8d. train_moe: make_train_step at 7b widths cut to 4 layers (MoE in layers 1
   and 3, MOE_7B), LoRA r8 + the experts and routers trained in float32,
   bf16 compute, remat, batch 2 at 575 tokens, 4 steps: the Switch aux
   term moves the loss, exact launches (8 flash, 4 dq, 4 dk/dv a step),
   MoE weights updated; step time, samples/s, peak memory.
8e. train_cli_moe_small: the train CLI at small with --moe_experts 4
   --moe_top_k 2 --moe_every 2, bf16: 2 steps, a validation and a
   checkpoint; an auto-resumed run equal bit for bit to an uninterrupted
   one; exact flash and decode launches.
8c. train CLI, 7b: the CLI at the full 7b preset (LoRA r8, bf16, remat,
   batch 2) on a 4-frame 720 x 1280 ReasonSeg folder and a 2-frame
   benchmark folder, --val_batch_size 2, three runs in-process (each model freed
   before the next): --epochs 1 --steps_per_epoch 2; --epochs 2 under the
   same name (auto-resumes at step 2, trains epoch 1); --load_in_8bit
   (QLoRA: the W8A8 kernel under autograd in the train step, skinny in
   the validation's decode). Exact launches a run (PER_TRAIN_STEP a step,
   PER_VALIDATE a validation with 32 new tokens, the w8a8 count derived
   from the model), none on a scalar path, a checkpoint written, the loss
   falling over runs 1-2; prints step, validation and checkpoint times
   and peak memory of each run.

9. predictor slice: SamPredictor over SAM ViT-B at full width and depth
   (bfloat16, seeded random weights) on a seeded 720 x 1280 frame:
   set_image, a point and a box prompt, a 64-point predict_batch and the
   automatic mask generator at 16 points a side; shapes, finiteness,
   masks at the original resolution, exactly 8 windowed and 4 global
   launches per set_image and none in the decodes; prints latencies and
   peak memory, profiles one set_image. The same predictor at tiny on the
   card against the CPU (logits within 1e-3).
10. audit and bench: tools/kernel_audit.py in-process (every check must
   pass) and tools/bench_kernels.py int8probe.
11. pipeline_vit_h: the 2HANDS pipeline (video_records, the records
   run_pipeline_from_video packs; the card has no h5py) on a
   seeded synthetic 32-frame clip at 480 x 854 (textured object and hands
   moving over a textured background, frame-0 seeds): propagation and
   inpainting on the card, object completion through a SamPredictor over
   the 7b preset's SAM ViT-H in bf16 (seeded weights), records filtered
   and their contour JSON written; the propagated (first 8 frames) and
   inpainted results against the CPU, exactly 28 + 4 SAM launches per
   completed frame; stage times, frames/s and the device's busy share of
   a profiled clip (its records only). The ViT-H phases' wall times.
12. export_vit_h: tools/export_model.py's encoder and mask_path of the same
   SAM exported (torch.export), saved, and loaded and run in a fresh
   process: outputs equal to the eager Sam's, no model code imported
   there, 28 + 4 SAM launches an image; export, save, load seconds and
   bytes.
13. tools_small: a small fp32 train-CLI checkpoint through export_params
   and merge_lora; a Predictor on the .npz against one on the checkpoint;
   the native host library; FLOPs and MFU of the ViT-H encoder against a
   bf16 matmul peak measured in the run.

The bf16 full-width paths (evaluate in three modes, speculative in two,
MPT in two, MoE greedy and speculative, serve_bf16, stream, train,
train_moe, train_cli, train_cli_8bit, the ViT-B predictor, the encoder
backward, the pipeline's SAM completion and the exported SAM programs)
must run every SAM,
flash forward, dq and dk/dv launch on the tensor cores, and every w8a8
launch on the tensor cores (M > 16) or the streamed skinny kernel
(decode), and every w4a16 launch on the tensor cores: no `<key>/scalar`
launch count (the first skinny kernels count there).

Prints a {"kernels": [...]} JSON line, the nvidia-smi line, and last
{"ok": true, "device": {...}}. Needs no network; the weights are random.
"""

import collections
import contextlib
import dataclasses
import gc
import json
import subprocess
import sys
import time

import numpy as np
import torch

H100_BF16_FLOPS = 989e12   # dense tensor-core peak, H100 SXM data sheet
H100_INT8_OPS = 1979e12    # dense int8 tensor-core peak, same data sheet
H100_BYTES_PER_S = 3.35e12  # HBM3

# Launches of each kernel per evaluate() call at the 7b preset: 28 windowed
# and 4 global SAM ViT-H blocks, 32 LLaMA layers' prefill, and their 15
# decode forwards (16 new tokens; the last token needs no forward). The
# quantized products' counts are derived from the model (product_launches).
# A graphed evaluate, a served batch and a streamed chunk count the same.
PER_EVALUATE = {"sam_window_relpos_attn": 28, "sam_global_relpos_attn": 4,
                "flash_prefill_fwd": 32, "decode_attn": 480}
# Launches per train step at the 7b preset with remat: the frozen SAM
# encoder's forward, each LLaMA layer's flash forward twice (the forward
# and its recompute in the backward) and its two backward kernels once.
PER_TRAIN_STEP = {"sam_window_relpos_attn": 28, "sam_global_relpos_attn": 4,
                  "flash_prefill_fwd": 64, "flash_bwd_dq": 32,
                  "flash_bwd_dkv": 32}
# Launches per SamPredictor.set_image at SAM ViT-B: 8 windowed and 4 global
# blocks; the prompt decodes launch none of the SAM kernels.
PER_SET_IMAGE = {"sam_window_relpos_attn": 8, "sam_global_relpos_attn": 4}
# Launches of one ViT-H encoder forward + backward with remat: each block's
# forward runs twice.
PER_ENCODER_BACKWARD = {"sam_window_relpos_attn": 56,
                        "sam_global_relpos_attn": 8}
# The paths each kernel is expected on; the first is the one whose count
# the kernels line reports as `launches`.
# The 7b evaluate paths of this slice's speculative decode and MPT decoder.
SPEC_MPT_7B = ("evaluate_spec_bf16", "evaluate_spec_w8a8",
               "evaluate_mpt_bf16", "evaluate_mpt_w8a8")
# The MoE slice's paths: the 7b MoE model greedy (eager and graphed) and
# speculative, and the 7b-width MoE train step.
MOE_7B_PATHS = ("evaluate_moe_bf16", "evaluate_spec_moe_bf16", "train_moe")
# The pipeline slice's paths at SAM ViT-H: the 2HANDS pipeline's mask
# completion and the exported encoder and mask_path programs.
VIT_H_TOOLS = ("pipeline_vit_h", "export_vit_h")
EXPECTED_ON = {
    "sam_window_relpos_attn": ("evaluate_bf16", "evaluate_w8a8",
                               "evaluate_w4a16", "train", "encoder_backward",
                               "serve_bf16", "stream", "train_cli",
                               "train_cli_8bit") + SPEC_MPT_7B + MOE_7B_PATHS
                              + VIT_H_TOOLS,
    "sam_global_relpos_attn": ("evaluate_bf16", "evaluate_w8a8",
                               "evaluate_w4a16", "train", "encoder_backward",
                               "predictor_vit_b", "small", "serve_bf16",
                               "stream", "train_cli", "train_cli_8bit")
                              + SPEC_MPT_7B + MOE_7B_PATHS + VIT_H_TOOLS,
    # The split window entry at the geometries of the TPU head-loop kernel
    # (counted under the split entry's key, on the paths that run it there).
    "sam_window_relpos_attn/vit_b": ("predictor_vit_b", "small"),
    "sam_window_relpos_attn_fused": ("audit", "predictor_tiny"),
    "sam_global_relpos_attn_heads": ("audit",),
    "sam_window_relpos_attn_heads": ("audit",),
    "matmul_probe": ("bench",),
    "flash_prefill_fwd": ("evaluate_bf16", "evaluate_w8a8", "evaluate_w4a16",
                          "train", "serve_bf16", "stream", "train_cli",
                          "train_cli_8bit", "spec_small", "mpt_tiny")
                         + SPEC_MPT_7B + MOE_7B_PATHS
                         + ("moe_small", "train_cli_moe_small"),
    "flash_bwd_dq": ("train", "train_cli", "train_cli_8bit", "train_moe",
                     "train_cli_moe_small"),
    "flash_bwd_dkv": ("train", "train_cli", "train_cli_8bit", "train_moe",
                      "train_cli_moe_small"),
    "decode_attn": ("evaluate_w8a8", "evaluate_bf16", "evaluate_w4a16",
                    "serve_bf16", "stream", "train_cli", "train_cli_8bit",
                    "evaluate_mpt_bf16", "evaluate_mpt_w8a8", "mpt_tiny",
                    "evaluate_moe_bf16", "moe_small", "train_cli_moe_small"),
    # train_cli_8bit: the QLoRA train step (tensor-core path, under grad)
    # and its validation's decode (skinny path); train_cli_tiny: the tiny
    # card-vs-CPU CLI runs (float32: w4a16 on its scalar kernel).
    "w8a8_matmul": ("evaluate_w8a8", "train_cli_8bit", "train_cli_tiny",
                    "evaluate_spec_w8a8", "evaluate_mpt_w8a8", "spec_small",
                    "moe_small"),
    "w4a16_matmul": ("evaluate_w4a16", "train_cli_tiny", "spec_small",
                     "moe_small"),
}

# The MoE configuration at LLaMA-7B widths: Mixtral-8x7B's 8 experts and
# top-2 (arXiv 2401.04088) in every other layer (GLaM's interleave, arXiv
# 2112.06905), capacity factor 1.25 (Switch's, the repo's default).
MOE_7B = dict(moe_num_experts=8, moe_top_k=2, moe_every=2,
              moe_capacity_factor=1.25)


# The card's nvidia-smi name and power limit, printed beside every time.
CARD = "card not read yet"


def log(*a):
    print(*a, flush=True)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters, warmup=2):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters, warmup=2, stream=None):
    """Device time of one call of `fn`: `iters` calls captured in one CUDA
    graph, the graph replayed twice between CUDA events. Unlike `cuda_ms`
    it leaves out the host's time to launch each call, which bounds a
    Python wrapper of a sub-0.1 ms kernel; `fn` must be capturable.
    `stream`: the capture stream (an autograd backward runs its ops on the
    stream of their forward, so a backward is captured on that one)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (2 * iters)


def bound_ms(nbytes, flops, peak=H100_BF16_FLOPS):
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def within_bf16(name, got, ref):
    """The kernel computes in float32 like the plain version run on the
    float32 values of the same inputs; they differ by the kernel's bf16
    output rounding (half an ulp: 2^-8 relative) and float32 summation
    order. Tolerance: |err| <= 1e-3 + 2^-7 |ref| (one bf16 ulp)."""
    err = (got.float() - ref.float()).abs()
    tol = 1e-3 + 2.0 ** -7 * ref.float().abs()
    bad = int((err > tol).sum())
    if bad or not torch.isfinite(got.float()).all():
        raise AssertionError(f"{name}: {bad} elements outside tolerance, "
                             f"max abs err {float(err.max())}")
    return float(err.max())


def check_flash(gen):
    """The flash forward at LLaMA-7B's prefill (2 requests: prompt 320 +
    256 image tokens - 1, causal, row 1 100 tokens short, so its pad
    queries are fully-masked rows), then at MPT-7B's: the same shape with
    the ALiBi column bias (1, 32, 1, 575) as the bias operand, read
    through strides, up to 0.84 x 574 = 482 in magnitude. Library: SDPA
    with a bool mask, and with the bias and mask as one bf16 float mask
    (SDPA takes no float32 mask with bf16 operands). The record's numbers
    are the LLaMA shape's."""
    from haff_tpu_torch.kernels import flash_attention as fa
    from haff_tpu_torch.nn.mpt import alibi_column_bias

    b, l, h, d = 2, 575, 32, 128
    dev, bf = "cuda", torch.bfloat16
    q, k, v = (torch.randn(b, l, h, d, generator=gen, device=dev).to(bf)
               for _ in range(3))
    lengths = torch.tensor([l, l - 100], device=dev)
    seg = (torch.arange(l, device=dev)[None] < lengths[:, None]).to(torch.int32)
    path = fa.PATH_NAMES[fa.kernel_path(q, k, v)]
    if path != "wgmma":
        raise AssertionError(f"flash_prefill_fwd: bf16 phase-3 operands on "
                             f"the {path} path")
    causal = torch.ones(l, l, dtype=torch.bool, device=dev).tril()
    mask = (causal[None] & (seg[:, :, None] == seg[:, None, :])
            & (seg[:, None, :] != 0))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    shapes = []
    for what, bias in (("LLaMA prefill", None),
                       ("MPT prefill, ALiBi bias",
                        alibi_column_bias(h, l, device=dev))):
        out, lse = fa.flash_prefill_kernel(q, k, v, bias, seg, seg, True)
        ref, ref_lse = fa.attention_plain(q.float(), k.float(), v.float(),
                                          bias, seg, seg, True)
        err = within_bf16(f"flash_prefill_fwd {what}", out, ref)
        lse_err = float((lse - ref_lse).abs().max())
        if not lse_err <= 1e-3:  # both float32: summation order only
            raise AssertionError(f"flash_prefill_fwd {what}: lse max abs err "
                                 f"{lse_err}")
        if (out[1, l - 100:].abs().max() != 0
                or lse[1, :, l - 100:].abs().max() != 0):
            raise AssertionError(f"flash_prefill_fwd {what}: fully-masked "
                                 "rows not zero")
        run = lambda: fa.flash_prefill_kernel(  # noqa: E731
            q, k, v, bias, seg, seg, True)
        kern, kern_graph = cuda_ms(run, 20), graph_ms(run, 20)
        plain = cuda_ms(lambda: fa.attention_plain(q, k, v, bias, seg, seg,
                                                   True), 10)
        if bias is None:
            attn_mask = mask[:, None]
        else:
            attn_mask = torch.where(mask[:, None], bias, -torch.inf).to(bf)
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, attn_mask=attn_mask)
        lib, lib_graph = cuda_ms(sdpa, 20), graph_ms(sdpa, 20)
        pairs = int(mask.sum())  # visible (query, key) pairs of this input
        flops = 4 * d * h * pairs
        extra = () if bias is None else (bias,)
        b_ms, by = bound_ms(nbytes(q, k, v, seg, seg, out, lse, *extra), flops)
        shapes.append(dict(
            what=what, shape=f"q/k/v {tuple(q.shape)} bf16 causal, lengths "
            f"{lengths.tolist()}" + ("" if bias is None else
                                     f", bias {tuple(bias.shape)} f32 max "
                                     f"{float(bias.max()):.1f}"),
            path=path, max_abs_err=err, ms=kern, plain_ms=plain,
            bound_ms=b_ms, bound_by=by, library_ms=lib, graph_ms=kern_graph,
            library_graph_ms=lib_graph))
        del attn_mask
    return record("flash_prefill_fwd",
                  "haff_tpu_torch/kernels/csrc/flash_prefill.cu",
                  "haff_tpu/kernels/flash_attention.py:105", shapes)


def check_flash_bwd(gen):
    """Both backward kernels at the train step's shapes. Returns two
    records. Each kernel's plain time is its own plain version's
    (attention_bwd_dq_plain, attention_bwd_dkv_plain); its library time is
    torch.autograd.grad of one SDPA forward (same boolean mask) for q
    alone or for k and v, timed alone, the forward kept (retain_graph).
    SDPA's backward computes dq, dk and dv in either call. The dk/dv
    record and the dq record also name their kernel path and time the
    kernel and its yardstick as CUDA graphs (`graph_ms`,
    `library_graph_ms`; the yardstick's forward runs on the capture
    stream, where its backward then runs)."""
    from haff_tpu_torch.kernels import flash_attention as fa

    # LLaMA-7B train step, batch 2: 575 spliced tokens, row 1 right-padded
    # by 100 (its pad queries see nothing, its pad keys are seen by none).
    b, l, h, d = 2, 575, 32, 128
    dev, bf = "cuda", torch.bfloat16
    q, k, v, do = (torch.randn(b, l, h, d, generator=gen, device=dev).to(bf)
                   for _ in range(4))
    lengths = torch.tensor([l, l - 100], device=dev)
    seg = (torch.arange(l, device=dev)[None] < lengths[:, None]).to(torch.int32)
    out, lse = fa.flash_prefill_kernel(q, k, v, None, seg, seg, True)
    args = (q, k, v, None, seg, seg, out, lse, do, True)
    path_dkv = fa.PATH_NAMES[fa.kernel_path(q, k, v, do)]
    if path_dkv != "wgmma":
        raise AssertionError(f"flash_bwd: bf16 phase-3 operands on the "
                             f"{path_dkv} path")
    dq = fa.flash_bwd_dq_kernel(*args)
    dk, dv = fa.flash_bwd_dkv_kernel(*args)
    ref = fa.attention_bwd_plain(q.float(), k.float(), v.float(), None, seg,
                                 seg, out.float(), lse, do.float(), True)
    err_dq = within_bf16("flash_bwd_dq", dq, ref[0])
    err_dkv = max(within_bf16("flash_bwd_dkv dk", dk, ref[1]),
                  within_bf16("flash_bwd_dkv dv", dv, ref[2]))
    del ref
    if dq[1, l - 100:].abs().max() != 0:
        raise AssertionError("flash_bwd_dq: padded query rows not zero")
    if dk[1, l - 100:].abs().max() != 0 or dv[1, l - 100:].abs().max() != 0:
        raise AssertionError("flash_bwd_dkv: padded key rows not zero")
    run_dq = lambda: fa.flash_bwd_dq_kernel(*args)  # noqa: E731
    ms_dq, graph_dq = cuda_ms(run_dq, 20), graph_ms(run_dq, 20)
    run_dkv = lambda: fa.flash_bwd_dkv_kernel(*args)  # noqa: E731
    ms_dkv, graph_dkv = cuda_ms(run_dkv, 20), graph_ms(run_dkv, 20)
    plain_dq = cuda_ms(lambda: fa.attention_bwd_dq_plain(*args), 10)
    plain_dkv = cuda_ms(lambda: fa.attention_bwd_dkv_plain(*args), 10)
    causal = torch.ones(l, l, dtype=torch.bool, device=dev).tril()
    mask = (causal[None] & (seg[:, :, None] == seg[:, None, :])
            & (seg[:, None, :] != 0))[:, None]
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    ot = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt,
                                                          attn_mask=mask)
    dot = do.transpose(1, 2)
    lib_dq = cuda_ms(lambda: torch.autograd.grad(ot, (qt,), dot,
                                                 retain_graph=True), 20)
    lib_dkv = cuda_ms(lambda: torch.autograd.grad(ot, (kt, vt), dot,
                                                  retain_graph=True), 20)
    # For the graph: fresh leaves and their forward on the capture stream,
    # so that no op of the backward (AccumulateGrad included) belongs to
    # the default stream.
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        ot = torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask)
    lib_dq_graph = graph_ms(lambda: torch.autograd.grad(
        ot, (qt,), dot, retain_graph=True), 20, stream=side)
    lib_dkv_graph = graph_ms(lambda: torch.autograd.grad(
        ot, (kt, vt), dot, retain_graph=True), 20, stream=side)
    del ot
    pairs = int(mask.sum())  # visible (query, key) pairs of this input
    rows = nbytes(seg, seg, lse, lse)  # segment ids, lse and delta
    recs = []
    for name, ms, err, outs, flops, plain, lib, own in (
            ("flash_bwd_dq", ms_dq, err_dq, (dq,), 6 * d * h * pairs,
             plain_dq, lib_dq, dict(path=path_dkv, graph_ms=graph_dq,
                                    library_graph_ms=lib_dq_graph)),
            ("flash_bwd_dkv", ms_dkv, err_dkv, (dk, dv), 8 * d * h * pairs,
             plain_dkv, lib_dkv, dict(path=path_dkv, graph_ms=graph_dkv,
                                      library_graph_ms=lib_dkv_graph))):
        b_ms, by = bound_ms(nbytes(q, k, v, do, *outs) + rows, flops)
        recs.append(dict(
            name=name, route="cuda",
            source="haff_tpu_torch/kernels/csrc/flash_bwd.cu",
            replaces=("haff_tpu/kernels/flash_attention.py:160"
                      if name == "flash_bwd_dq" else
                      "haff_tpu/kernels/flash_attention.py:202"),
            shape=f"q/k/v/dO {tuple(q.shape)} bf16 causal, lengths "
                  f"{lengths.tolist()}",
            max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
            bound_by=by, library_ms=lib, **own))
    return recs


def check_w8a8(gen):
    """The w8a8 product at a prefill, a decode, the lm_head, the down
    projection's prefill, a SAM encoder shape, every other LLaMA-7B decode
    product (gate/up, down, lm_head at M = 2; 4096 x 4096 at the skinny
    path's largest M, 16), and a decode shape with K % 16 != 0, each on the
    path it must take: the int8 tensor cores for M > 16 and the streamed
    skinny kernel at decode where K % 16 == 0, the first port's skinny
    kernel (the scalar path, counted under `w8a8_matmul/scalar`) at odd K;
    the run fails on any other. The float32 output must equal the plain
    version's bit for bit (the int32 sum is exact); the record's numbers
    are the prefill shape's, the others are listed under `shapes`, each
    with its path, the CUDA-graph times and the share of its bound the
    graph time reaches. Library: torch._int_mm on the same int8 operands (M
    padded to 32, N and K to multiples of 8 outside the timed call, as it
    requires) + the rescale."""
    from haff_tpu_torch.kernels import _build
    from haff_tpu_torch.nn import quant

    dev, bf = "cuda", torch.bfloat16
    shapes = []
    for what, m, k, n in (("prefill", 1150, 4096, 4096),
                          ("decode", 2, 4096, 4096),
                          ("lm_head", 1150, 4096, 32004),
                          ("down_proj", 1150, 11008, 4096),
                          ("sam qkv", 9800, 1280, 3840),
                          ("decode gate/up", 2, 4096, 11008),
                          ("decode down", 2, 11008, 4096),
                          ("decode lm_head", 2, 4096, 32004),
                          ("decode M=16", 16, 4096, 4096),
                          ("decode odd K", 2, 4100, 4096),
                          # A speculative verify step: batch 2 x 8 drafts.
                          ("verify M=16 gate/up", 16, 4096, 11008),
                          ("verify M=16 down", 16, 11008, 4096),
                          ("verify M=16 lm_head", 16, 4096, 32004),
                          # MPT-7B: fused Wqkv, up and down at expansion 4.
                          ("MPT Wqkv prefill", 1150, 4096, 12288),
                          ("MPT up prefill", 1150, 4096, 16384),
                          ("MPT down prefill", 1150, 16384, 4096),
                          ("MPT Wqkv decode", 2, 4096, 12288),
                          ("MPT up decode", 2, 4096, 16384),
                          ("MPT down decode", 2, 16384, 4096)):
        x = torch.randn(m, k, generator=gen, device=dev).to(bf)
        w = torch.randn(n, k, generator=gen, device=dev) * k ** -0.5
        q, sw = quant.quantize_kernel(w)
        del w
        xq, sx = quant.quantize_activation(x)
        sx = sx[:, 0].contiguous()
        path = quant.W8A8_PATH_NAMES[quant.w8a8_path(xq, q)]
        want = ("scalar" if k % 16 else
                "skinny" if m <= quant.SKINNY_M else "wgmma")
        if path != want:
            raise AssertionError(f"w8a8_matmul {what}: on the {path} path")
        exact = quant.int8_matmul_plain(xq, q, sx, sw, torch.float32)
        scalar = _build.LAUNCHES["w8a8_matmul/scalar"]
        if not torch.equal(quant.int8_matmul_kernel(xq, q, sx, sw,
                                                    torch.float32), exact):
            raise AssertionError(f"w8a8_matmul {what}: float32 output differs "
                                 "from the exact int32 product")
        scalar = _build.LAUNCHES["w8a8_matmul/scalar"] - scalar
        if scalar != (path == "scalar"):
            raise AssertionError(f"w8a8_matmul {what}: the scalar count "
                                 "does not match the path")
        out = quant.int8_matmul_kernel(xq, q, sx, sw, bf)
        err = within_bf16(f"w8a8_matmul {what}", out, exact)
        del exact
        iters = 20 if m * n * k < 3e10 else 5
        run = lambda: quant.int8_matmul_kernel(xq, q, sx, sw, bf)  # noqa: E731
        kern, kern_graph = cuda_ms(run, iters), graph_ms(run, iters)
        plain = cuda_ms(lambda: quant.int8_matmul_plain(xq, q, sx, sw, bf), 3, 1)
        mp, np_ = max(32, -(-m // 8) * 8), -(-n // 8) * 8
        kp = -(-k // 8) * 8
        xq_p = torch.zeros(mp, kp, dtype=torch.int8, device=dev)
        xq_p[:m, :k] = xq
        q_p = torch.zeros(np_, kp, dtype=torch.int8, device=dev)
        q_p[:n, :k] = q
        sx_p = torch.ones(mp, 1, device=dev)
        sx_p[:m, 0] = sx
        sw_p = torch.ones(np_, device=dev)
        sw_p[:n] = sw
        lib_fn = lambda: (torch._int_mm(xq_p, q_p.T).float() * sx_p  # noqa: E731
                          * sw_p).to(bf)
        lib_err = float((lib_fn()[:m, :n].float() - out.float()).abs().max())
        lib, lib_graph = cuda_ms(lib_fn, iters), graph_ms(lib_fn, iters)
        b_ms, by = bound_ms(nbytes(xq, q, sx, sw, out), 2.0 * m * n * k,
                            H100_INT8_OPS)
        shapes.append(dict(what=what, shape=f"xq ({m}, {k}) int8, w ({n}, {k}) "
                           "int8 -> bf16", path=path, max_abs_err=err, ms=kern,
                           plain_ms=plain, bound_ms=b_ms, bound_by=by,
                           library_ms=lib, graph_ms=kern_graph,
                           library_graph_ms=lib_graph,
                           bound_share=b_ms / kern_graph,
                           library_max_abs_diff=lib_err))
        del x, q, xq, out, xq_p, q_p
        torch.cuda.empty_cache()
    return record("w8a8_matmul", "haff_tpu_torch/kernels/csrc/w8a8_matmul.cu",
                  "haff_tpu/nn/quant.py:68", shapes)


def check_w4a16(gen):
    """The w4a16 product at the LLaMA-7B decode step's four shapes (M = 2:
    gate/up, 4096 x 4096, down, lm_head), at M = 16 and at the largest M
    the kernel takes (256), each on the bf16 mma path, and one float32
    case on the scalar kernel (counted under `w4a16_matmul/scalar`); the
    run fails on any other path. bf16 within one ulp of the product of the
    same rounded weight in float32, float32 within 1e-4 + 1e-4 |ref|. Each
    shape records its path, the CUDA-graph times, the graph time's share
    of its bound, the dequantize + torch.matmul route (library) and
    `bf16_graph_ms` / `bf16_ms`: torch.matmul on the weight already
    dequantized (what the bf16 evaluate runs). The record's numbers are
    the first shape's."""
    from haff_tpu_torch.kernels import _build
    from haff_tpu_torch.nn import quant

    dev, bf, f32, group = "cuda", torch.bfloat16, torch.float32, 64
    shapes = []
    for what, m, k, n, dt in (("decode gate/up", 2, 4096, 11008, bf),
                              ("decode", 2, 4096, 4096, bf),
                              ("decode down", 2, 11008, 4096, bf),
                              ("decode lm_head", 2, 4096, 32004, bf),
                              ("decode M=16", 16, 4096, 4096, bf),
                              ("M=256", 256, 4096, 11008, bf),
                              ("float32", 2, 4096, 11008, f32)):
        w = torch.randn(n, k, generator=gen, device=dev) * k ** -0.5
        packed, sc = quant.quantize_kernel_int4(w, group)
        del w
        x = torch.randn(m, k, generator=gen, device=dev).to(dt)
        wd = quant.dequantize_kernel_int4(packed, sc, group, dt)
        path = quant.W4A16_PATH_NAMES[quant.w4a16_path(x, packed, sc, group)]
        want = "mma" if dt == bf else "scalar"
        if path != want:
            raise AssertionError(f"w4a16_matmul {what}: on the {path} path")
        scalar = _build.LAUNCHES["w4a16_matmul/scalar"]
        out = quant.int4_matmul_kernel(x, packed, sc, group, dt)
        scalar = _build.LAUNCHES["w4a16_matmul/scalar"] - scalar
        if scalar != (path == "scalar"):
            raise AssertionError(f"w4a16_matmul {what}: the scalar count "
                                 "does not match the path")
        # Same rounded weight, float32 accumulation, unrounded sum.
        ref = x.float() @ wd.float().T
        if dt == bf:
            err = within_bf16(f"w4a16_matmul {what}", out, ref)
        else:
            diff = (out - ref).abs()
            err = float(diff.max())
            if not (diff <= 1e-4 + 1e-4 * ref.abs()).all():
                raise AssertionError(f"w4a16_matmul {what}: max abs err {err}")
        del ref
        run = lambda: quant.int4_matmul_kernel(x, packed, sc, group, dt)  # noqa: E731
        kern, kern_graph = cuda_ms(run, 20), graph_ms(run, 20)
        plain = cuda_ms(lambda: quant.int4_matmul_plain(x, packed, sc, group,
                                                        dt), 3, 1)
        lib_fn = lambda: quant.int4_matmul_dequant(x, packed, sc, group, dt)  # noqa: E731
        lib, lib_graph = cuda_ms(lib_fn, 5), graph_ms(lib_fn, 5)
        mm = lambda: torch.matmul(x, wd.T)  # noqa: E731
        b_ms, by = bound_ms(nbytes(x, packed, sc, out), 2.0 * m * n * k)
        shapes.append(dict(what=what, shape=f"x ({m}, {k}) {str(dt)[6:]}, "
                           f"packed ({n}, {k // 2}) uint8, group {group}",
                           path=path, max_abs_err=err, ms=kern,
                           plain_ms=plain, bound_ms=b_ms, bound_by=by,
                           library_ms=lib, graph_ms=kern_graph,
                           library_graph_ms=lib_graph,
                           bound_share=b_ms / kern_graph,
                           bf16_ms=cuda_ms(mm, 20),
                           bf16_graph_ms=graph_ms(mm, 20)))
        del x, packed, sc, wd, out
        torch.cuda.empty_cache()
    return record("w4a16_matmul",
                  "haff_tpu_torch/kernels/csrc/w4a16_matmul.cu",
                  "haff_tpu/nn/quant.py:134", shapes)


def check_decode(gen):
    """Decode attention at LLaMA-7B's shape with 591 cache slots (575
    spliced + 16 new), an int8 and a bf16 cache, ragged live lengths: row
    0 nearly full, row 1 a single live slot; and both rows nearly full
    over the int8 cache; then MPT-7B's decode step, the kernel's ALiBi
    variant (32 per-head slopes: slot j's score gains slope_h * j) over
    the bf16 and the int8 cache. The bound counts the live slots only.
    Library: SDPA over the dequantized cache laid out (B, nh, L, hd) with
    a boolean key mask (with the slopes: the ALiBi columns and the mask
    as one bf16 float mask), prepared outside the timed call. Kernel and
    library are also timed as CUDA graphs; each shape names the split the
    kernel ran (`decode_plan`: splits, slots a split). The record's
    numbers are the first shape's."""
    from haff_tpu_torch.kernels import _build
    from haff_tpu_torch.kernels import decode_attention as da
    from haff_tpu_torch.nn import quant
    from haff_tpu_torch.nn.mpt import alibi_slopes

    b, lmax, nh, hd = 2, 591, 32, 128
    dev, bf = "cuda", torch.bfloat16
    if da.decode_plan(b, nh, nh, lmax)[0] < 2:
        raise AssertionError("decode_attn: the 7b decode step does not split "
                             "its slots over blocks")
    q = (0.5 * torch.randn(b, nh, hd, generator=gen, device=dev)).to(bf)
    kf = 0.5 * torch.randn(b, lmax, nh, hd, generator=gen, device=dev)
    vf = torch.randn(b, lmax, nh, hd, generator=gen, device=dev)
    shapes = []
    slopes = alibi_slopes(nh, device=dev)
    for kind, lengths, alibi in (("int8", (590, 1), None),
                                 ("bf16", (590, 1), None),
                                 ("int8", (590, 590), None),
                                 ("bf16", (590, 1), slopes),
                                 ("int8", (590, 1), slopes)):
        if kind == "int8":
            k, v = quant.quantize_activation(kf), quant.quantize_activation(vf)
            per_slot = 2 * nh * (hd + 4)
        else:
            k, v = kf.to(bf), vf.to(bf)
            per_slot = 2 * nh * hd * 2
        mask = (torch.arange(lmax, device=dev)[None]
                < torch.tensor(lengths, device=dev)[:, None]).to(torch.int32)
        scale = hd ** -0.5
        variant = "" if alibi is None else ", ALiBi slopes"
        alibi_before = _build.LAUNCHES["decode_attn/alibi"]
        out = da.decode_attention_kernel(q, k, v, mask, scale, slopes=alibi)
        if (_build.LAUNCHES["decode_attn/alibi"] - alibi_before
                != (alibi is not None)):
            raise AssertionError("decode_attn: the /alibi count does not "
                                 "match the variant")
        ref = da.decode_attention_plain(q.float(), k, v, mask, scale,
                                        slopes=alibi)
        err = within_bf16(f"decode_attn {kind}{variant}", out, ref)
        run = lambda: da.decode_attention_kernel(  # noqa: E731
            q, k, v, mask, scale, slopes=alibi)
        kern, kern_graph = cuda_ms(run, 50), graph_ms(run, 50)
        plain = cuda_ms(lambda: da.decode_attention_plain(
            q, k, v, mask, scale, slopes=alibi), 10)
        kd, vd = (da.dequantize_cache(c).to(bf).transpose(1, 2) for c in (k, v))
        key_mask = (mask > 0)[:, None, None, :]
        if alibi is not None:
            key_mask = torch.where(
                key_mask, da.alibi_columns(alibi, lmax, dev)[None, :, None],
                -torch.inf).to(bf)
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
            q[:, :, None], kd, vd, attn_mask=key_mask, scale=scale)
        lib, lib_graph = cuda_ms(sdpa, 50), graph_ms(sdpa, 50)
        live = int(mask.sum())
        b_ms, by = bound_ms(live * per_slot + nbytes(q, mask, out)
                            + (0 if alibi is None else nbytes(alibi)),
                            4.0 * hd * nh * live)
        shapes.append(dict(shape=f"q {tuple(q.shape)} bf16, {kind} cache "
                           f"{(b, lmax, nh, hd)}, live {list(lengths)}"
                           f"{variant}",
                           plan=list(da.decode_plan(b, nh, nh, lmax)),
                           max_abs_err=err, ms=kern, plain_ms=plain,
                           bound_ms=b_ms, bound_by=by, library_ms=lib,
                           graph_ms=kern_graph, library_graph_ms=lib_graph))
    # A row with no live slot gives 0, not NaN.
    mask = torch.zeros(b, lmax, dtype=torch.int32, device=dev)
    mask[0, :7] = 1
    out = da.decode_attention_kernel(q, kf.to(bf), vf.to(bf), mask, hd ** -0.5)
    if out[1].abs().max() != 0 or not torch.isfinite(out.float()).all():
        raise AssertionError("decode_attn: a row without live slots is not 0")
    return record("decode_attn", "haff_tpu_torch/kernels/csrc/decode_attn.cu",
                  "haff_tpu/kernels/decode_attention.py:41", shapes)


def sam_case(gen, scope, entry, b, hw, nh, d, iters):
    """One SAM attention entry (`scope` "window" or "global"; `entry`
    "split", "fused" or "heads") at one shape in bf16: error against the
    plain version on the float32 values, the kernel path the wrapper
    chose, kernel, plain and SDPA + bias times by CUDA events (`ms`,
    `plain_ms`, `library_ms`: the host's launch time included where it is
    longer than the call, as on the eager paths), the kernel and SDPA
    again as CUDA graphs (`graph_ms`, `library_graph_ms`: device time
    alone), and the bound. The operands of the split and per-head entries
    are separate contiguous tensors, as their callers hold them."""
    from haff_tpu_torch.kernels import sam_attention as sa

    H, W = hw
    l, c = H * W, nh * d
    dev, bf = "cuda", torch.bfloat16
    qkv = torch.randn(b, l, 3 * c, generator=gen, device=dev).to(bf)
    rh = 0.1 * torch.randn(2 * H - 1, d, generator=gen, device=dev)
    rw = 0.1 * torch.randn(2 * W - 1, d, generator=gen, device=dev)
    q, k, v = (sa.head_view(qkv, 3, i, nh).contiguous() for i in range(3))
    if entry == "fused":
        fn = (sa.sam_window_attention_qkv if scope == "window"
              else sa.sam_global_attention_qkv)
        run, held = (lambda: fn(qkv, rh, rw, hw, nh)), (qkv,)
        views = [sa.head_view(qkv, 3, i, nh) for i in range(3)]
    elif entry == "split":
        q3, kv3 = qkv[..., :c].contiguous(), qkv[..., c:].contiguous()
        run = lambda: sa.sam_window_attention_qkv_split(  # noqa: E731
            q3, kv3, rh, rw, hw, nh)
        held = (q3, kv3)
        views = [sa.head_view(q3, 1, 0, nh), sa.head_view(kv3, 2, 0, nh),
                 sa.head_view(kv3, 2, 1, nh)]
    else:
        fn = (sa.sam_window_attention if scope == "window"
              else sa.sam_global_attention)
        run, held = (lambda: fn(q, k, v, rh, rw, hw)), (q, k, v)
        views = [q, k, v]
    path = sa.PATH_NAMES[sa.kernel_path(scope, *views)]
    name = f"sam {scope} {entry} {(b, l, nh, d)} grid {hw}"
    with torch.no_grad():
        out = run()
        ref = sa.global_attention_plain(qkv.float(), rh, rw, hw, nh, d ** -0.5)
        err = within_bf16(name, out.reshape(b, l, c), ref)
        del ref
        kern, kern_graph = cuda_ms(run, iters), graph_ms(run, iters)
        plain = cuda_ms(lambda: sa.global_attention_plain(
            qkv, rh.to(bf), rw.to(bf), hw, nh, d ** -0.5), max(iters // 2, 2), 1)
        bias = sa.decomposed_rel_pos_bias(q, rh, rw, hw, hw).to(bf)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, attn_mask=bias, scale=d ** -0.5)
        lib, lib_graph = cuda_ms(sdpa, iters), graph_ms(sdpa, iters)
        extra = {}
        if scope == "global":  # the scalar path's band tables, for scale
            extra["band_tables_ms"] = cuda_ms(
                lambda: sa.band_tables(q, rh, rw, hw), iters)
    flops = b * nh * (4 * l * l * d + 2 * l * (H + W) * d)
    b_ms, by = bound_ms(nbytes(*held, rh, rw, out), flops)
    layout = {"fused": f"qkv {(b, l, 3 * c)}", "split": f"q3 {(b, l, c)} kv3 "
              f"{(b, l, 2 * c)}", "heads": f"q/k/v {(b, l, nh, d)}"}[entry]
    return dict(shape=f"{layout} bf16, grid {hw}, {nh} x {d}", path=path,
                max_abs_err=err, ms=kern, plain_ms=plain, bound_ms=b_ms,
                bound_by=by, library_ms=lib, graph_ms=kern_graph,
                library_graph_ms=lib_graph, **extra)


def record(name, source, replaces, shapes, **extra):
    """A kernels-line record whose own numbers are its first shape's
    (`path` and the graph times too, where the shapes have them)."""
    main = shapes[0]
    own = {key: main[key] for key in ("path", "graph_ms", "library_graph_ms")
           if key in main}
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                shape=main["shape"],
                max_abs_err=max(r["max_abs_err"] for r in shapes),
                ms=main["ms"], plain_ms=main["plain_ms"],
                bound_ms=main["bound_ms"], bound_by=main["bound_by"],
                library_ms=main["library_ms"], **own, shapes=shapes, **extra)


# The SAM records' shapes in order, with their kernel ms at PR 4 (scalar
# kernels; PERF.md's table, NVIDIA H100 80GB HBM3, 700 W, CUDA events):
# printed beside this run's times, never part of the kernels line.
PR4_SAM_MS = (("window split ViT-H", 1.6732), ("global fused ViT-H", 16.5093),
              ("window fused ViT-H", 1.6927), ("window fused 14 x 12", 1.2666),
              ("window split ViT-B", 1.1877), ("window split small", 0.1492),
              ("global heads ViT-B", 10.4997), ("window heads ViT-H", 1.6753))


def check_sam_entries(gen):
    """Every SAM attention entry at its path's shapes: the split window
    and fused global entries at ViT-H (evaluate(), batch 1: 5 x 5 windows
    of 14 x 14 and a 64 x 64 grid, 16 heads x 80), the fused-operand
    window entry (the audit's ViT-H shape and a non-square window), the
    split entry at ViT-B's and the small preset's geometry, and the two
    per-head entries. Library: SDPA with the (L, L) bias built outside
    the timed call."""
    win = "haff_tpu_torch/kernels/csrc/sam_window_attn.cu"
    glob = "haff_tpu_torch/kernels/csrc/sam_global_attn.cu"
    jsa = "haff_tpu/kernels/sam_attention.py"
    return [
        record("sam_window_relpos_attn", win, f"{jsa}:558", [
            sam_case(gen, "window", "split", 25, (14, 14), 16, 80, 20)]),
        record("sam_global_relpos_attn", glob, f"{jsa}:1150", [
            sam_case(gen, "global", "fused", 1, (64, 64), 16, 80, 5)]),
        record("sam_window_relpos_attn_fused", win, f"{jsa}:494", [
            sam_case(gen, "window", "fused", 25, (14, 14), 16, 80, 20),
            sam_case(gen, "window", "fused", 25, (14, 12), 16, 80, 20)]),
        record("sam_window_relpos_attn/vit_b", win, f"{jsa}:451", [
            sam_case(gen, "window", "split", 25, (14, 14), 12, 64, 20),
            sam_case(gen, "window", "split", 16, (8, 8), 8, 32, 20)],
            counter="sam_window_relpos_attn"),
        record("sam_global_relpos_attn_heads", glob, f"{jsa}:71", [
            sam_case(gen, "global", "heads", 1, (64, 64), 12, 64, 5)]),
        record("sam_window_relpos_attn_heads", win, f"{jsa}:249", [
            sam_case(gen, "window", "heads", 25, (14, 14), 16, 80, 20)]),
    ]


def check_probe(gen):
    """The bench tool's tiled matmul probe at its 2048^3 shape, int8
    (exact) and bf16. Library: torch._int_mm / torch.matmul."""
    from haff_tpu_torch.tools.bench_kernels import (matmul_probe,
                                                    matmul_probe_plain)

    m = k = n = 2048
    dev = "cuda"
    shapes = []
    for kind, peak in (("int8", H100_INT8_OPS), ("bf16", H100_BF16_FLOPS)):
        if kind == "int8":
            a, b = (torch.randint(-127, 128, (m, k), generator=gen, device=dev,
                                  dtype=torch.int8) for _ in range(2))
            lib_fn = lambda: torch._int_mm(a, b.T)  # noqa: E731
        else:
            a, b = (torch.randn(m, k, generator=gen, device=dev).bfloat16()
                    for _ in range(2))
            lib_fn = lambda: a @ b.T  # noqa: E731
        out, ref = matmul_probe(a, b), matmul_probe_plain(a, b)
        if kind == "int8":
            if not torch.equal(out, ref):
                raise AssertionError("matmul_probe int8: not the exact product")
            err = 0.0
        else:  # float32 sums of 2048 exact products: summation order only
            err = float((out - ref).abs().max())
            if not err <= 1e-4 * k ** 0.5:
                raise AssertionError(f"matmul_probe bf16: max abs err {err}")
        kern = cuda_ms(lambda: matmul_probe(a, b), 10)
        plain = cuda_ms(lambda: matmul_probe_plain(a, b), 3, 1)
        lib = cuda_ms(lib_fn, 10)
        b_ms, by = bound_ms(nbytes(a, b, out), 2.0 * m * n * k, peak)
        shapes.append(dict(shape=f"a ({m}, {k}) @ b ({n}, {k})^T {kind}",
                           max_abs_err=err, ms=kern, plain_ms=plain,
                           bound_ms=b_ms, bound_by=by, library_ms=lib))
    log(f"matmul_probe: int8 / bf16 rate at equal structure "
        f"{shapes[1]['ms'] / shapes[0]['ms']:.2f}x")
    return record("matmul_probe",
                  "haff_tpu_torch/kernels/csrc/matmul_probe.cu",
                  "tools/bench_kernels.py:652", shapes)


def check_sam_backward(gen):
    """The SAM attention entries under autograd at ViT-H shapes in bf16
    (kernel forward, plain-torch backward) against autograd through the
    plain version on the float32 values: q/k/v gradients within one bf16
    ulp of the leaf's scale; the window entry's rel-pos tables get true
    gradients, the global entry's exactly zero."""
    from haff_tpu_torch.kernels import sam_attention as sa

    dev, bf = "cuda", torch.bfloat16
    nh, d = 16, 80
    c = nh * d
    for scope, b, hw in (("window", 25, (14, 14)), ("global", 1, (64, 64))):
        l = hw[0] * hw[1]
        qkv = torch.randn(b, l, 3 * c, generator=gen, device=dev).to(bf)
        rh = 0.1 * torch.randn(2 * hw[0] - 1, d, generator=gen, device=dev)
        rw = 0.1 * torch.randn(2 * hw[1] - 1, d, generator=gen, device=dev)
        go = torch.randn(b, l, c, generator=gen, device=dev).to(bf)
        ins = [t.requires_grad_() for t in (qkv, rh, rw)]
        fn = (sa.sam_window_attention_qkv if scope == "window"
              else sa.sam_global_attention_qkv)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = torch.autograd.grad(fn(*ins, hw, nh), ins, go)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        ref_ins = [t.detach().float().requires_grad_() for t in ins]
        ref = torch.autograd.grad(
            sa.global_attention_plain(*ref_ins, hw, nh, d ** -0.5), ref_ins,
            go.float())
        errs = {}
        for name, a, r in zip(("qkv", "rel_h", "rel_w"), got, ref):
            if scope == "global" and name != "qkv":
                if a.any():
                    raise AssertionError(f"backward global: {name} gradient "
                                         "is not exactly zero")
                errs[name] = 0.0
                continue
            err = float((a.float() - r).abs().max())
            if not err <= 2.0 ** -7 * float(r.abs().max()) + 1e-6:
                raise AssertionError(f"backward {scope}: d{name} max abs err "
                                     f"{err} at scale {float(r.abs().max())}")
            errs[name] = err
        del ref, ref_ins
        log(f"backward {scope}: qkv {tuple(qkv.shape)} bf16 grid {hw}: "
            f"forward + backward {dt * 1e3:.1f} ms (first call); max abs errs "
            + ", ".join(f"d{k} {v:.3g}" for k, v in errs.items()))
    torch.cuda.empty_cache()


def run_encoder_backward(launches):
    """The ViT-H image encoder alone, forward and backward at batch 1 in
    bf16 with remat. Returns the launch counts of one forward + backward."""
    from haff_tpu_torch.core.config import SamEncoderConfig
    from haff_tpu_torch.model.lisa import init_random_
    from haff_tpu_torch.nn.sam_image_encoder import SamImageEncoder

    cfg = SamEncoderConfig.preset("vit_h")
    enc = SamImageEncoder(cfg).to("cuda", torch.bfloat16)
    init_random_(enc, torch.Generator("cuda").manual_seed(0))
    gen = torch.Generator("cuda").manual_seed(1)
    x = torch.randn(1, cfg.image_size, cfg.image_size, 3, generator=gen,
                    device="cuda")
    go = torch.randn(1, cfg.grid_size, cfg.grid_size, cfg.out_chans,
                     generator=gen, device="cuda")
    times = []
    for i in range(2):
        enc.zero_grad(set_to_none=True)
        torch.cuda.reset_peak_memory_stats()
        launches.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (enc(x, remat=True) * go).sum().backward()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        counts = dict(launches)
        if counts != PER_ENCODER_BACKWARD:
            raise AssertionError(f"encoder backward: launches {counts}, "
                                 f"expected {PER_ENCODER_BACKWARD}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    frozen_tables = 0
    for name, p in enc.named_parameters():
        if p.grad is None or not torch.isfinite(p.grad).all():
            raise AssertionError(f"encoder backward: no finite gradient on "
                                 f"{name}")
        table = "rel_pos" in name and int(name.split(".")[1]) in \
            cfg.global_attn_indexes
        if table:
            frozen_tables += 1
        if table == bool(p.grad.any()):
            raise AssertionError(f"encoder backward: {name} gradient is "
                                 f"{'not ' if table else ''}zero")
    nparam = sum(p.numel() for p in enc.parameters())
    log(f"encoder backward: SAM ViT-H ({nparam / 1e9:.3f} B parameters, bf16, "
        f"remat), batch 1: forward + backward "
        f"{[round(t * 1e3, 1) for t in times]} ms (host clock, synchronized), "
        f"peak memory {peak:.2f} GiB; finite nonzero gradients on every "
        f"parameter but the {frozen_tables} global rel-pos tables (exact "
        f"zeros); launches {counts}")
    return counts


def check_small(launches):
    """The small preset with the trained weights of the committed
    artifact, float32, card (kernels) against CPU (plain versions):
    evaluate(), then 3 train steps with the SAM encoder unfrozen. Returns
    the card's launch counts."""
    import os

    from haff_tpu_torch.core.config import ModelConfig, TrainConfig
    from haff_tpu_torch.infer.evaluate import evaluate_fn
    from haff_tpu_torch.model.lisa import LisaModel
    from haff_tpu_torch.tools.bridge import load_jax_params
    from haff_tpu_torch.train import trainer as T

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "artifacts", "overfit_small_params.npz")
    cfg = ModelConfig.preset("small")
    models = {dev: load_jax_params(LisaModel(cfg, torch.float32, device=dev),
                                   path) for dev in ("cuda", "cpu")}
    req = make_requests(cfg, 2, 24, seed=3)
    req[3][1, 20:] = 0
    launches.clear()
    got = evaluate_fn(models["cuda"], *req, max_new_tokens=8, eos_id=2)
    ref = evaluate_fn(models["cpu"], *req, max_new_tokens=8, eos_id=2)
    if not torch.equal(got.output_ids.cpu(), ref.output_ids):
        raise AssertionError(f"small: tokens differ {got.output_ids.tolist()} "
                             f"vs {ref.output_ids.tolist()}")
    worst = 0.0
    for key in ("pred_masks_left", "pred_masks_right", "taxonomies"):
        g, r = getattr(got, key).cpu(), getattr(ref, key)
        torch.testing.assert_close(g, r, rtol=1e-3, atol=1e-3)
        worst = max(worst, float((g - r).abs().max()))
    want = {"sam_window_relpos_attn": 2, "sam_global_relpos_attn": 2}
    sam = {k: launches[k] for k in want}
    if sam != want:
        raise AssertionError(f"small: SAM launches {sam}, expected {want}")
    log(f"small evaluate: trained weights, card (kernels, f32) vs CPU: tokens "
        f"identical {got.output_ids.tolist()}, masks/taxonomy max abs err "
        f"{worst:.3g}; launches {dict(launches)}")

    host_batch = make_train_batch(cfg, 2, 24, seed=5, image_index=[0, 1], pad=5)
    tcfg = TrainConfig(model=cfg, lr=1e-4, warmup_steps=1, total_steps=20,
                       grad_accumulation_steps=1)
    runs = []
    for dev, model in models.items():
        batch = host_batch.to(dev)
        trainable, _ = T.partition_params(model, extra=("image_encoder",))
        state = T.init_train_state(tcfg, trainable)
        step = T.make_train_step(model, tcfg)
        metrics = []
        for _ in range(3):
            state, m = step(state, batch, 0)
            metrics.append({k: float(v) for k, v in m.items()})
        runs.append((metrics, {k: p.detach().cpu()
                               for k, p in trainable.items()}))
    (m_gpu, p_gpu), (m_cpu, p_cpu) = runs
    for a, r in zip(m_gpu, m_cpu):
        for k in r:
            if abs(a[k] - r[k]) > 1e-3 * max(1.0, abs(r[k])):
                raise AssertionError(f"small train: {k} {a[k]} vs {r[k]}")
    for k, r in p_cpu.items():
        torch.testing.assert_close(p_gpu[k], r, rtol=1e-3, atol=1e-3)
    n_enc = sum("image_encoder" in k for k in p_cpu)
    log(f"small train: 3 steps with the SAM encoder unfrozen ({n_enc} encoder "
        f"tensors of {len(p_cpu)} trainable), card vs CPU: losses "
        f"{[round(m['loss'], 5) for m in m_gpu]} vs "
        f"{[round(m['loss'], 5) for m in m_cpu]}, grad norms "
        f"{[round(m['grad_norm'], 4) for m in m_gpu]} vs "
        f"{[round(m['grad_norm'], 4) for m in m_cpu]}")
    return dict(launches)


def check_sam_reference():
    """The port's bf16 SAM encoder at the small preset (trained weights of
    artifacts/overfit_small_params.npz) on the card against haff_tpu's, on
    the seeded image of artifacts/sam_small_encoder_reference.npz (made on
    a CPU host by tests/make_sam_encoder_reference.py: JAX at bfloat16
    with its Pallas kernels in interpret mode, and at float32). The port's
    distance to the JAX float32 output, relative L2 and max abs, must be
    at most twice the JAX bf16 output's own. Returns both distances."""
    import os

    from haff_tpu_torch.core.config import SamDecoderConfig, SamEncoderConfig
    from haff_tpu_torch.nn.sam import Sam
    from haff_tpu_torch.tools.bridge import load_jax_params

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "artifacts")
    with np.load(os.path.join(root, "sam_small_encoder_reference.npz")) as z:
        seed, image_sum = int(z["seed"]), float(z["image_sum"])
        ref, jax_bf16 = z["out_f32"], z["out_bf16"]
    x = np.random.RandomState(seed).randn(1, 512, 512, 3).astype(np.float32)
    if abs(x.astype(np.float64).sum() - image_sum) > 1e-6 * np.abs(x).sum():
        raise AssertionError("sam reference: the seeded image is not the one "
                             "the reference was made from")
    sam = load_jax_params(Sam(SamEncoderConfig.preset("small"),
                              SamDecoderConfig()),
                          os.path.join(root, "overfit_small_params.npz"),
                          scope="visual_model")
    enc = sam.image_encoder.to(device="cuda", dtype=torch.bfloat16)
    with torch.no_grad():
        got = enc(torch.from_numpy(x).cuda()).float().cpu().numpy()

    def dist(a):
        return (float(np.linalg.norm(a - ref) / np.linalg.norm(ref)),
                float(np.abs(a - ref).max()))

    (port_l2, port_max), (jax_l2, jax_max) = dist(got), dist(jax_bf16)
    log(f"sam reference: small encoder, bf16, against haff_tpu's float32 "
        f"output: port (card kernels) relative L2 {port_l2:.6g}, max abs "
        f"{port_max:.6g}; haff_tpu bf16 (Pallas, interpret) relative L2 "
        f"{jax_l2:.6g}, max abs {jax_max:.6g}")
    if (got.shape != ref.shape or not np.isfinite(got).all()
            or port_l2 > 2 * jax_l2 or port_max > 2 * jax_max):
        raise AssertionError("sam reference: the port's bf16 encoder is more "
                             "than twice as far from the float32 output as "
                             "haff_tpu's bf16 encoder")
    return dict(port_rel_l2=port_l2, port_max_abs=port_max,
                jax_rel_l2=jax_l2, jax_max_abs=jax_max)


def sam_launches(launches):
    return {k: v for k, v in launches.items() if k.startswith("sam_")}


def run_predictor_slice(launches):
    """SamPredictor over SAM ViT-B (full width and depth, bf16, seeded
    random weights) on a seeded 720 x 1280 frame. Returns the launch
    counts of the whole path."""
    from haff_tpu_torch.core.config import SamDecoderConfig, SamEncoderConfig
    from haff_tpu_torch.infer.amg import from_predictor
    from haff_tpu_torch.infer.sam_predictor import SamPredictor
    from haff_tpu_torch.model.lisa import init_random_
    from haff_tpu_torch.nn.sam import Sam

    enc_cfg = SamEncoderConfig.preset("vit_b")
    with torch.device("meta"):
        sam = Sam(enc_cfg, SamDecoderConfig())
    sam = sam.to(torch.bfloat16).to_empty(device="cuda")
    init_random_(sam, torch.Generator("cuda").manual_seed(0))
    pred = SamPredictor(sam, image_size=enc_cfg.image_size)
    nparam = sum(p.numel() for p in sam.parameters())
    H, W = 720, 1280
    frame = np.random.RandomState(0).randint(0, 256, (H, W, 3)).astype(np.uint8)
    torch.cuda.reset_peak_memory_stats()
    launches.clear()

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    set_ms = []
    for i in range(3):
        _, ms = timed(lambda: pred.set_image(frame))
        set_ms.append(ms)
        want = {k: v * (i + 1) for k, v in PER_SET_IMAGE.items()}
        if sam_launches(launches) != want:
            raise AssertionError(f"predictor: launches after {i + 1} "
                                 f"set_image calls {sam_launches(launches)}, "
                                 f"expected {want}")
    emb = pred._embedding
    g = enc_cfg.grid_size
    if tuple(emb.shape) != (1, g, g, 256) or not emb.is_cuda or \
            not torch.isfinite(emb).all():
        raise AssertionError(f"predictor: embedding {tuple(emb.shape)} on "
                             f"{emb.device}")
    encoded = sam_launches(launches)

    def check(what, masks, iou, tax, n, n_out, left):
        lead = (n, n_out) if n else (n_out,)
        if masks.shape != lead + (H, W) or iou.shape != lead:
            raise AssertionError(f"predictor {what}: masks {masks.shape}, iou "
                                 f"{iou.shape}")
        if not (np.isfinite(masks).all() and np.isfinite(iou).all()):
            raise AssertionError(f"predictor {what}: non-finite output")
        if left != (tax is not None):
            raise AssertionError(f"predictor {what}: taxonomy {tax}")
        if left and not np.allclose(tax.sum(-1), 1.0, atol=1e-2):
            raise AssertionError(f"predictor {what}: taxonomy does not sum to 1")

    out, point_ms = timed(lambda: pred.predict(
        point_coords=np.array([[640.0, 360.0]]), point_labels=np.array([1]),
        multimask_output=True, return_logits=True, hand="left"))
    check("point", *out, 0, 3, True)
    binary = pred.predict(point_coords=np.array([[640.0, 360.0]]),
                          point_labels=np.array([1]), hand="left")[0]
    if binary.dtype != bool or not np.array_equal(binary, out[0] > 0):
        raise AssertionError("predictor: binary masks are not logits > 0")
    out, box_ms = timed(lambda: pred.predict(
        box=np.array([200.0, 100.0, 900.0, 600.0]), multimask_output=False,
        return_logits=True, hand="right"))
    check("box", *out, 0, 1, False)
    pts = np.random.RandomState(1).rand(64, 2) * np.array([W, H])
    batch_ms = []
    for _ in range(3):
        out, ms = timed(lambda: pred.predict_batch(
            pts, multimask_output=True, return_logits=True, hand="left"))
        batch_ms.append(ms)
    check("batch", *out, 64, 3, True)
    del out
    amg = from_predictor(pred, hand="left", points_per_side=16,
                         pred_iou_thresh=-1e9, stability_thresh=0.0)
    records, amg_ms = timed(lambda: amg.generate((H, W)))
    if not records:
        raise AssertionError("predictor: the mask generator kept no mask")
    for r in records:
        if r["segmentation"]["size"] != [H, W] or r["area"] <= 0 or \
                sum(r["segmentation"]["counts"]) != H * W:
            raise AssertionError(f"predictor: bad record {r['bbox']}")
    if sam_launches(launches) != encoded:
        raise AssertionError(f"predictor: a prompt decode launched a SAM "
                             f"attention kernel: {sam_launches(launches)}")
    counts = dict(launches)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"predictor: SAM ViT-B ({nparam / 1e6:.1f} M parameters, bf16) on a "
        f"{H} x {W} frame: set_image {[round(t, 1) for t in set_ms]} ms, "
        f"point prompt {point_ms:.1f} ms, box prompt {box_ms:.1f} ms, "
        f"64-prompt decode {[round(t, 1) for t in batch_ms]} ms (masks at "
        f"{H} x {W} copied to the host), mask generator 16 x 16 points "
        f"{amg_ms:.1f} ms -> {len(records)} masks after NMS (host clock, "
        f"synchronized); peak memory {peak:.2f} GiB; launches {counts}")
    profile_call("set_image vit_b", lambda: pred.set_image(frame))
    return counts


def check_tiny_predictor(launches):
    """SamPredictor at tiny in float32 on the card (kernels) against the
    CPU (plain versions): point, box and batch logits within 1e-3. The
    tiny encoder's 8 x 8 global grid goes through the fused window entry.
    Returns the card's launch counts."""
    from haff_tpu_torch.core.config import ModelConfig
    from haff_tpu_torch.infer.sam_predictor import SamPredictor
    from haff_tpu_torch.model.lisa import init_random_
    from haff_tpu_torch.nn.sam import Sam

    cfg = ModelConfig.preset("tiny")
    gpu = Sam(cfg.sam_encoder, cfg.sam_decoder).to("cuda")
    init_random_(gpu, torch.Generator("cuda").manual_seed(2))
    cpu = Sam(cfg.sam_encoder, cfg.sam_decoder)
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    S = cfg.sam_encoder.image_size
    frame = np.random.RandomState(3).randint(0, 256, (60, 90, 3)).astype(np.uint8)
    pts = np.array([[10.0, 8.0], [32.0, 24.0], [70.0, 50.0]])
    launches.clear()
    outs = []
    for sam, dev in ((gpu, "cuda"), (cpu, "cpu")):
        pred = SamPredictor(sam, image_size=S, device=dev)
        pred.set_image(frame)
        outs.append((
            pred.predict(point_coords=pts[:1], point_labels=np.array([1]),
                         return_logits=True, hand="left"),
            pred.predict(box=np.array([10.0, 10.0, 70.0, 50.0]),
                         multimask_output=False, return_logits=True,
                         hand="right"),
            pred.predict_batch(pts, return_logits=True, hand="left")))
    counts = dict(launches)
    worst = 0.0
    for got, ref in zip(*outs):
        for g, r in zip(got, ref):
            if (g is None) != (r is None):
                raise AssertionError("tiny predictor: taxonomy presence differs")
            if g is not None:
                np.testing.assert_allclose(g, r, rtol=1e-3, atol=1e-3)
                worst = max(worst, float(np.abs(g - r).max()))
    if counts.get("sam_window_relpos_attn_fused") != 1:
        raise AssertionError(f"tiny predictor: launches {counts}")
    log(f"tiny predictor: card (kernels, f32) vs CPU (plain, f32): point, box "
        f"and batch logits, iou, taxonomy max abs err {worst:.3g}; launches "
        f"{counts}")
    return counts


def run_tools(launches):
    """The kernel audit and the int8 probe bench, in-process. Returns the
    launch counts of each."""
    from haff_tpu_torch.tools import bench_kernels, kernel_audit

    launches.clear()
    if kernel_audit.main([]) != 0:
        raise AssertionError("kernel audit failed")
    audit = dict(launches)
    launches.clear()
    if bench_kernels.main(["int8probe", "--iters", "5"]) != 0:
        raise AssertionError("bench_kernels int8probe failed")
    return audit, dict(launches)


def make_requests(cfg, batch, prompt_len, seed):
    """Seeded, already-preprocessed requests (bench_e2e.py's recipe)."""
    from haff_tpu_torch.core.config import IMAGE_TOKEN_INDEX

    rng = np.random.RandomState(seed)
    S, C = cfg.sam_encoder.image_size, cfg.clip.image_size
    ids = rng.randint(5, min(30000, cfg.llama.vocab_size - 10),
                      (batch, prompt_len)).astype(np.int64)
    ids[:, 0] = 1
    ids[:, 2] = IMAGE_TOKEN_INDEX
    attn = np.ones((batch, prompt_len), np.int64)
    return (rng.randn(batch, S, S, 3).astype(np.float32),
            rng.randn(batch, C, C, 3).astype(np.float32), ids, attn)


def quantize_for(model, mode, group=64):
    """Quantize `model` in place for a serving mode: "w8a8" (the
    whole-model int8 serving set) or "w4a16" (packed-int4 LLM
    projections); "bf16" leaves it as it is. Returns the predicate."""
    from haff_tpu_torch.nn import quant

    if mode == "bf16":
        return None
    pred = (quant.lisa_serving_predicate if mode == "w8a8"
            else quant.default_llm_predicate)
    quant.quantize_model_(model, pred, bits=8 if mode == "w8a8" else 4,
                          group=group)
    return pred


def check_tiny_against_cpu(mode="bf16"):
    """evaluate() at tiny in float32, card (kernels) against CPU (plain
    versions) from the same weights; quantized modes quantize each model
    in place on its own device and must reach identical integers."""
    from haff_tpu_torch.core.config import ModelConfig
    from haff_tpu_torch.infer.evaluate import evaluate_fn
    from haff_tpu_torch.kernels import _build
    from haff_tpu_torch.model.lisa import LisaModel

    cfg = ModelConfig.preset("tiny")
    gpu = LisaModel(cfg, torch.float32, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(1))
    cpu = LisaModel(cfg, torch.float32, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    for model in (gpu, cpu):  # tiny widths divide by 16, not by 64
        quantize_for(model, mode, group=16)
    sd_gpu, sd_cpu = gpu.state_dict(), cpu.state_dict()
    if set(sd_gpu) != set(sd_cpu) or any(
            not torch.equal(v.cpu(), sd_cpu[k]) for k, v in sd_gpu.items()):
        raise AssertionError(f"tiny {mode}: quantizing on the card and on the "
                             "CPU gave different weights")
    req = make_requests(cfg, 2, 24, seed=3)
    req[3][1, 20:] = 0  # right-padded second request
    kw = dict(max_new_tokens=8, eos_id=2, kv_cache_8bit=mode == "w8a8")
    before = dict(_build.LAUNCHES)
    got = evaluate_fn(gpu, *req, **kw)
    ran = {k: v - before.get(k, 0) for k, v in _build.LAUNCHES.items()
           if v != before.get(k, 0)}
    product = {"w8a8": "w8a8_matmul", "w4a16": "w4a16_matmul"}.get(mode)
    if product and not ran.get(product):
        raise AssertionError(f"tiny {mode}: {product} never launched: {ran}")
    ref = evaluate_fn(cpu, *req, **kw)
    if not (torch.equal(got.output_ids.cpu(), ref.output_ids)
            and torch.equal(got.gen_lengths.cpu(), ref.gen_lengths)):
        raise AssertionError(f"tiny {mode}: tokens differ "
                             f"{got.output_ids.tolist()} vs "
                             f"{ref.output_ids.tolist()}")
    worst = 0.0
    for key in ("pred_masks_left", "pred_masks_right", "taxonomies"):
        g, r = getattr(got, key).cpu(), getattr(ref, key)
        torch.testing.assert_close(g, r, rtol=1e-3, atol=1e-3)
        worst = max(worst, float((g - r).abs().max()))
    log(f"tiny {mode}: card (kernels, f32) vs CPU (plain, f32): tokens "
        f"identical {got.output_ids.tolist()}, masks/taxonomy max abs err "
        f"{worst:.3g}; launches {ran}")


def check_spec_small(launches):
    """Speculative decode at the small preset with the trained weights of
    artifacts/overfit_small_params.npz, float32, in three weight modes
    (float; W8A8 on the LLM's projections + the int8 cache; W4A16 at group
    16, float32 so on its scalar kernel): on the card through make_jitted_evaluate (one verify
    step captured in a CUDA graph, a capture call and a replayed call)
    and on the CPU through evaluate_fn, against greedy on each device.
    Corpora: junk (seeded random ids), the oracle (greedy's own tokens),
    the answer templates (what the trained model emits), and the oracle
    with EOS set to a token row 0 emits at its third step (an EOS inside
    an accepted chunk). Tokens, lengths and decode steps identical card
    against CPU and speculative against greedy; masks and taxonomy within
    1e-3; the oracle in at most ceil(T / D) + 1 steps. The SAM encoder
    stays float in the W8A8 mode: speculation never reaches it, and its
    own W8A8 card-against-CPU difference (an activation one int8 step
    apart moves mask logits by up to ~0.35 at small) would hide the
    decoder's. Returns the card's launch counts."""
    import os

    from haff_tpu_torch.core.config import ModelConfig
    from haff_tpu_torch.data.tokenizer import ByteTokenizer
    from haff_tpu_torch.infer.evaluate import evaluate_fn, make_jitted_evaluate
    from haff_tpu_torch.infer.generate import answer_template_corpus
    from haff_tpu_torch.model.lisa import LisaModel
    from haff_tpu_torch.nn import quant
    from haff_tpu_torch.tools.bridge import load_jax_params

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "artifacts", "overfit_small_params.npz")
    cfg = ModelConfig.preset("small")
    T, D = 12, 4
    req = make_requests(cfg, 2, 24, seed=3)
    req[3][1, 20:] = 0
    junk = np.random.RandomState(4).randint(5, 300, (2, 20))
    template = answer_template_corpus(ByteTokenizer())
    launches.clear()
    for mode in ("float", "w8a8", "w4a16"):
        models = {}
        for dev in ("cuda", "cpu"):
            m = load_jax_params(LisaModel(cfg, torch.float32, device=dev), path)
            if mode != "float":
                quant.quantize_model_(m, quant.default_llm_predicate,
                                      bits=8 if mode == "w8a8" else 4,
                                      group=16)
            models[dev] = m
        kv8 = mode == "w8a8"
        greedy = {dev: evaluate_fn(m, *req, T, 2, kv_cache_8bit=kv8)
                  for dev, m in models.items()}
        tokens = greedy["cpu"].output_ids
        eos_mid = int(tokens[0, 2])
        oracle = torch.cat([torch.full((2, 1), -1), tokens], dim=1)
        cases = (("junk", 2, junk, None), ("oracle", 2, oracle, None),
                 ("template", 2, *template), ("eos mid-chunk", eos_mid,
                                              oracle, None))
        summary = []
        for name, eos, corpus, lens in cases:
            kw = dict(kv_cache_8bit=kv8, draft_corpus=corpus,
                      corpus_lengths=lens, draft_len=D)
            ev = make_jitted_evaluate(models["cuda"], T, eos, **kw)
            if eos == 2:
                plain = greedy
            else:
                plain = {dev: evaluate_fn(m, *req, T, eos, kv_cache_8bit=kv8)
                         for dev, m in models.items()}
            ref = evaluate_fn(models["cpu"], *req, T, eos, **kw)
            for call in range(2):  # the capture call, then a replay
                got = ev(*req)
                for other, what in ((ref, "the CPU's speculative"),
                                    (plain["cuda"], "the card's greedy"),
                                    (plain["cpu"], "the CPU's greedy")):
                    if not (torch.equal(got.output_ids.cpu(),
                                        other.output_ids.cpu())
                            and torch.equal(got.gen_lengths.cpu(),
                                            other.gen_lengths.cpu())):
                        raise AssertionError(
                            f"spec small {mode} {name} call {call}: tokens "
                            f"{got.output_ids.tolist()} vs {what} "
                            f"{other.output_ids.tolist()}")
                    for key in ("pred_masks_left", "pred_masks_right",
                                "taxonomies"):
                        torch.testing.assert_close(
                            getattr(got, key).cpu(), getattr(other, key).cpu(),
                            rtol=1e-3, atol=1e-3)
                if int(got.decode_steps) != int(ref.decode_steps):
                    raise AssertionError(
                        f"spec small {mode} {name}: {int(got.decode_steps)} "
                        f"decode steps on the card, {int(ref.decode_steps)} "
                        "on the CPU")
            steps = int(got.decode_steps)
            if name == "oracle" and steps > -(-T // D) + 1:
                raise AssertionError(f"spec small {mode}: the oracle corpus "
                                     f"took {steps} steps")
            if name == "eos mid-chunk" and int(got.gen_lengths[0]) > 3:
                raise AssertionError(f"spec small {mode}: row 0 ran past EOS")
            summary.append(f"{name} {steps} steps")
        log(f"spec small {mode}: card (graphed verify, f32) = CPU = greedy "
            f"in tokens and lengths, masks/taxonomy within 1e-3; greedy "
            f"tokens {tokens.tolist()}; {', '.join(summary)}")
    return dict(launches)


def check_mpt_tiny(launches):
    """The MPT decoder at tiny in float32, card against CPU from the same
    weights, with a float and an int8 cache: evaluate_fn, and on the card
    also make_jitted_evaluate (a capture call and a replay): identical
    tokens, masks and taxonomy within 1e-4; every decode step on the
    decode kernel's ALiBi variant. Returns the card's launch counts."""
    from haff_tpu_torch.core.config import ModelConfig
    from haff_tpu_torch.infer.evaluate import evaluate_fn, make_jitted_evaluate
    from haff_tpu_torch.model.lisa import LisaModel

    cfg = ModelConfig.preset("tiny").replace(decoder="mpt")
    gpu = LisaModel(cfg, torch.float32, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(1))
    cpu = LisaModel(cfg, torch.float32, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    req = make_requests(cfg, 2, 24, seed=3)
    req[3][1, 20:] = 0
    T = 8
    launches.clear()
    worst = 0.0
    for kv8 in (False, True):
        ref = evaluate_fn(cpu, *req, T, 2, kv_cache_8bit=kv8)
        graphed = make_jitted_evaluate(gpu, T, 2, kv_cache_8bit=kv8)
        for got in (evaluate_fn(gpu, *req, T, 2, kv_cache_8bit=kv8),
                    graphed(*req), graphed(*req)):
            if not (torch.equal(got.output_ids.cpu(), ref.output_ids)
                    and torch.equal(got.gen_lengths.cpu(), ref.gen_lengths)):
                raise AssertionError(f"mpt tiny (int8 cache {kv8}): tokens "
                                     f"{got.output_ids.tolist()} vs "
                                     f"{ref.output_ids.tolist()}")
            for key in ("pred_masks_left", "pred_masks_right", "taxonomies"):
                g, r = getattr(got, key).cpu(), getattr(ref, key)
                torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-4)
                worst = max(worst, float((g - r).abs().max()))
    counts = dict(launches)
    # 3 calls x 2 caches x (T - 1) steps x 2 layers, every one with slopes.
    want = 3 * 2 * (T - 1) * cfg.llama.num_layers
    if counts.get("decode_attn") != want or counts.get(
            "decode_attn/alibi") != want:
        raise AssertionError(f"mpt tiny: launches {counts}, expected {want} "
                             "decode_attn, all ALiBi")
    log(f"mpt tiny: card (kernels, f32; eager, capture, replay) vs CPU, "
        f"float and int8 cache: tokens identical {ref.output_ids.tolist()}, "
        f"masks/taxonomy max abs err {worst:.3g}; launches {counts}")
    return counts


def check_moe_small(launches):
    """moe_small_vs_cpu: the small preset with MoE MLPs in every layer (4
    experts, top-2), float32, seeded weights, in three weight modes (float;
    W8A8 on the LLM's projections + the int8 cache; W4A16 at group 16), the
    card against the CPU from the same weights: greedy through evaluate_fn
    and make_jitted_evaluate (a capture call and a replay) and speculative
    (the oracle corpus, 4 tokens a verify step, the verify step graphed on
    the card): identical tokens, lengths and decode steps, speculative
    equal to greedy; masks and taxonomy within 1e-4 (float) or 1e-3 (the
    quantized modes, as spec_small). The quantized products must launch,
    and the routers and experts stay float. Returns the card's launches."""
    from haff_tpu_torch.core.config import ModelConfig
    from haff_tpu_torch.infer.evaluate import evaluate_fn, make_jitted_evaluate
    from haff_tpu_torch.kernels import _build
    from haff_tpu_torch.model.lisa import LisaModel
    from haff_tpu_torch.nn import quant
    from haff_tpu_torch.nn.moe import MoEMLP

    base = ModelConfig.preset("small")
    cfg = base.replace(llama=dataclasses.replace(
        base.llama, moe_num_experts=4, moe_top_k=2, moe_every=1))
    sd = {k: v.cpu() for k, v in LisaModel(
        cfg, torch.float32, device="cuda",
        generator=torch.Generator("cuda").manual_seed(1)).state_dict().items()}
    T, D = 12, 4
    req = make_requests(cfg, 2, 24, seed=3)
    req[3][1, 20:] = 0
    launches.clear()
    for mode in ("float", "w8a8", "w4a16"):
        models = {}
        for dev in ("cuda", "cpu"):
            m = LisaModel(cfg, torch.float32, device=dev)
            m.load_state_dict(sd)
            if mode != "float":
                quant.quantize_model_(m, quant.default_llm_predicate,
                                      bits=8 if mode == "w8a8" else 4,
                                      group=16)
            moes = [x for x in m.modules() if isinstance(x, MoEMLP)]
            if len(moes) != cfg.llama.num_layers or any(
                    x.router.quantized or any(
                        p.dtype != torch.float32 for p in x.parameters())
                    for x in moes):
                raise AssertionError(f"moe small {mode}: MoE layers "
                                     "quantized or missing")
            models[dev] = m
        kv8 = mode == "w8a8"
        tol = 1e-4 if mode == "float" else 1e-3
        before = collections.Counter(_build.LAUNCHES)
        ref = evaluate_fn(models["cpu"], *req, T, 2, kv_cache_8bit=kv8)
        graphed = make_jitted_evaluate(models["cuda"], T, 2, kv_cache_8bit=kv8)
        oracle = torch.cat([torch.full((2, 1), -1), ref.output_ids], dim=1)
        kw = dict(kv_cache_8bit=kv8, draft_corpus=oracle, draft_len=D)
        spec_ref = evaluate_fn(models["cpu"], *req, T, 2, **kw)
        spec = make_jitted_evaluate(models["cuda"], T, 2, **kw)
        worst = 0.0
        for what, got, want in (
                ("eager", evaluate_fn(models["cuda"], *req, T, 2,
                                      kv_cache_8bit=kv8), ref),
                ("graphed capture", graphed(*req), ref),
                ("graphed replay", graphed(*req), ref),
                ("speculative capture", spec(*req), spec_ref),
                ("speculative replay", spec(*req), spec_ref),
                ("speculative (CPU) against greedy", spec_ref, ref)):
            if not (torch.equal(got.output_ids.cpu(), want.output_ids)
                    and torch.equal(got.gen_lengths.cpu(), want.gen_lengths)):
                raise AssertionError(
                    f"moe small {mode} {what}: tokens {got.output_ids.tolist()}"
                    f" vs {want.output_ids.tolist()}")
            if "speculative" in what and want is spec_ref and int(
                    got.decode_steps) != int(want.decode_steps):
                raise AssertionError(f"moe small {mode} {what}: "
                                     f"{int(got.decode_steps)} decode steps, "
                                     f"{int(want.decode_steps)} on the CPU")
            for key in ("pred_masks_left", "pred_masks_right", "taxonomies"):
                g, r = getattr(got, key).cpu(), getattr(want, key)
                torch.testing.assert_close(g, r, rtol=tol, atol=tol)
                worst = max(worst, float((g - r).abs().max()))
        ran = collections.Counter(_build.LAUNCHES)
        ran.subtract(before)
        product = {"w8a8": "w8a8_matmul", "w4a16": "w4a16_matmul"}.get(mode)
        if product and not ran[product]:
            raise AssertionError(f"moe small {mode}: {product} never "
                                 f"launched: {dict(+ran)}")
        log(f"moe small {mode}: card (kernels, f32; eager, graphed, "
            f"speculative graphed) = CPU in tokens, lengths and steps, "
            f"speculative = greedy; masks/taxonomy max abs err {worst:.3g}; "
            f"greedy tokens {ref.output_ids.tolist()}; speculative "
            f"{int(spec_ref.decode_steps)} steps for {T} tokens; routers and "
            f"experts float; launches {dict(+ran)}")
        del models
    return dict(launches)


def product_launches(model, mode, new_tokens):
    """Launches of the quantized product's kernel in one evaluate(),
    derived from the model: each quantized LLM layer runs once a forward
    (prefill + new_tokens - 1 decode steps; the w4a16 kernel takes the
    decode steps only, prefill dequantizes), each quantized SAM layer once,
    a windowed block's qkv twice (column-split into q and kv)."""
    from haff_tpu_torch.nn.layers import QDense

    def count(root):
        return sum(isinstance(m, QDense) and m.quantized
                   for m in root.modules())

    llm = count(model.llm)
    if mode == "w4a16":
        return llm * (new_tokens - 1)
    sam = 0
    for blk in model.visual_model.image_encoder.blocks:
        sam += count(blk) + (blk.window_size > 0 and blk.attn.qkv.quantized)
    return llm * new_tokens + sam


def run_slice(launches, mode="bf16", decoder="llama", moe=False):
    """evaluate() at the full 7b preset in one serving mode: "bf16", "w8a8"
    (int8 weights + int8 KV cache) or "w4a16" (packed-int4 LLM), with the
    LLaMA decoder or (`decoder="mpt"`, MPT-7B at the preset's widths: its
    decode steps on the decode kernel's ALiBi variant, counted under
    `decode_attn/alibi` too) the MPT one; `moe` gives the LLaMA decoder
    MoE MLPs (MOE_7B: 16 MoE layers of 8 experts, ~21.9 B decoder
    parameters). Returns {path: launch counts}: `evaluate_{mode}`
    (`evaluate_mpt_{mode}`, `evaluate_moe_{mode}`) over its 2 eager
    evaluate calls, and for LLaMA in bf16 and w8a8 `evaluate_spec_{mode}`
    (`evaluate_spec_moe_{mode}`), the speculative phase on the same model
    (run_speculative)."""
    from haff_tpu_torch.core.config import ModelConfig
    from haff_tpu_torch.infer.evaluate import evaluate_fn
    from haff_tpu_torch.model.lisa import LisaModel
    from haff_tpu_torch.nn.layers import QDense
    from haff_tpu_torch.nn.moe import MoEMLP

    mpt = decoder == "mpt"
    cfg = ModelConfig.preset("7b").replace(decoder=decoder)
    if moe:
        cfg = cfg.replace(llama=dataclasses.replace(cfg.llama, **MOE_7B))
    kind = "mpt " if mpt else "moe " if moe else ""
    label = f"{kind}{mode}"
    path = f"evaluate_{kind.strip()}_{mode}" if kind else f"evaluate_{mode}"
    t0 = time.perf_counter()
    model = LisaModel(cfg, torch.bfloat16, device="cuda",
                      generator=torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    nparam = sum(p.numel() for p in model.parameters())
    llm = sum(p.numel() for p in model.llm.parameters())
    experts = sum(p.numel() for m in model.modules() if isinstance(m, MoEMLP)
                  for p in m.parameters())
    log(f"slice {label}: 7b preset ({type(model.llm).__name__}"
        f"{', MoE layers ' + str(model.moe_layers) if moe else ''}) built in "
        f"{time.perf_counter() - t0:.1f} s, {nparam / 1e9:.3f} B parameters "
        f"bf16 ({llm / 1e9:.3f} B in the decoder, {experts / 1e9:.3f} B in "
        f"MoE layers), {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    B, P, T, S = 2, 320, 16, cfg.sam_encoder.image_size
    expected = dict(PER_EVALUATE, w8a8_matmul=0, w4a16_matmul=0)
    expected["decode_attn/alibi"] = PER_EVALUATE["decode_attn"] if mpt else 0
    if mode != "bf16":
        t0 = time.perf_counter()
        pred = quantize_for(model, mode)
        torch.cuda.synchronize()
        want = torch.int8 if mode == "w8a8" else torch.uint8
        layers = {n: m for n, m in model.named_modules()
                  if isinstance(m, QDense)
                  and pred(tuple(n.split(".")) + ("weight",))}
        wrong = [n for n, m in layers.items() if m.weight.dtype != want
                 or m.scale.dtype != torch.float32]
        stray = [n for n, m in model.named_modules()
                 if isinstance(m, QDense) and m.quantized and n not in layers]
        if not layers or wrong or stray:
            raise AssertionError(f"slice {mode}: {len(layers)} selected "
                                 f"layers, not quantized {wrong[:5]}, "
                                 f"quantized unselected {stray[:5]}")
        gc.collect()
        torch.cuda.empty_cache()
        held = sum(t.numel() * t.element_size() for t in
                   list(model.parameters()) + list(model.buffers()))
        product = "w8a8_matmul" if mode == "w8a8" else "w4a16_matmul"
        expected[product] = product_launches(model, mode, T)
        log(f"slice {label}: {len(layers)} layers quantized in place in "
            f"{time.perf_counter() - t0:.1f} s; weights {held / 2**30:.2f} "
            f"GiB, allocated {torch.cuda.memory_allocated() / 2**30:.2f} GiB; "
            f"expecting {expected[product]} {product} launches an evaluate")
    run = lambda req: evaluate_fn(model, *req, max_new_tokens=T,  # noqa: E731
                                  eos_id=2, kv_cache_8bit=mode == "w8a8")
    torch.cuda.reset_peak_memory_stats()
    launches.clear()  # count the main path's launches only
    eager, eager_ms = [], []
    for i in range(2):
        req = make_requests(cfg, B, P, seed=i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run(req)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        eager.append(res)
        eager_ms.append(dt * 1e3)
        shapes = {"output_ids": (B, T), "gen_lengths": (B,),
                  "pred_masks_left": (B, S, S), "pred_masks_right": (B, S, S),
                  "taxonomies": (B, 4), "seg_found": (B,)}
        for key, shape in shapes.items():
            t = getattr(res, key)
            if tuple(t.shape) != shape:
                raise AssertionError(f"{key} shape {tuple(t.shape)} != {shape}")
            if t.is_floating_point() and not torch.isfinite(t).all():
                raise AssertionError(f"{key} has non-finite values")
        for name, per in expected.items():
            if launches[name] != per * (i + 1):
                raise AssertionError(f"{label}: {name}: {launches[name]} "
                                     f"launches after {i + 1} evaluate calls, "
                                     f"expected {per * (i + 1)}")
        log(f"slice {label} batch {i}: {B} requests, latency {dt * 1e3:.1f} ms "
            f"(host clock, synchronized), tokens generated "
            f"{int(res.gen_lengths.sum())}, seg_found "
            f"{res.seg_found.tolist()}, taxonomy[0] "
            f"{[round(x, 4) for x in res.taxonomies[0].tolist()]}")
    counts = dict(launches)
    held = sum(t.numel() * t.element_size() for t in
               list(model.parameters()) + list(model.buffers()))
    log(f"slice {label}: launches over 2 evaluate calls {counts}; weights "
        f"{held / 2**30:.2f} GiB, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB | {CARD}")
    req = make_requests(cfg, B, P, seed=2)
    profile_call(f"evaluate {label}", lambda: run(req))
    greedy, greedy_ms = run_graphed(model, label, mode == "w8a8", cfg, eager,
                                    eager_ms, expected)
    paths = {path: counts}
    if not mpt and mode != "w4a16":
        paths[f"evaluate_spec_{kind}{mode}".replace(" ", "_")] = \
            run_speculative(model, mode, cfg, launches, greedy, greedy_ms,
                            label)
    return paths


def run_graphed(model, mode, kv8, cfg, eager, eager_ms, expected):
    """The eager slice's requests through make_jitted_evaluate (the decode
    loop captured in a CUDA graph): one capture call and two replays
    (requests 0, 1, 0), each against the eager call on the same request:
    identical tokens, masks and taxonomy within one bf16 ulp, the same
    launches per call and none on a scalar path. Prints both latencies
    and profiles one replayed call."""
    from haff_tpu_torch.infer.evaluate import make_jitted_evaluate
    from haff_tpu_torch.kernels import _build

    B, P, T = 2, 320, 16
    graphed = make_jitted_evaluate(model, T, 2, kv_cache_8bit=kv8)
    graph_ms, identical, results = [], [], []
    for i, seed in enumerate((0, 1, 0)):
        req = make_requests(cfg, B, P, seed=seed)
        before = collections.Counter(_build.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = graphed(*req)
        torch.cuda.synchronize()
        graph_ms.append((time.perf_counter() - t0) * 1e3)
        ran = collections.Counter(_build.LAUNCHES)
        ran.subtract(before)
        ran = +ran
        want = {k: v for k, v in expected.items() if v}
        if ran != want:
            raise AssertionError(f"graphed {mode} call {i}: launches "
                                 f"{dict(ran)}, expected {want}")
        results.append(got)
        ref = eager[seed]
        if not (torch.equal(got.output_ids, ref.output_ids)
                and torch.equal(got.gen_lengths, ref.gen_lengths)):
            raise AssertionError(f"graphed {mode} call {i}: tokens "
                                 f"{got.output_ids.tolist()} vs eager "
                                 f"{ref.output_ids.tolist()}")
        same = True
        for key in ("pred_masks_left", "pred_masks_right", "taxonomies"):
            within_bf16(f"graphed {mode} {key}", getattr(got, key),
                        getattr(ref, key))
            same &= torch.equal(getattr(got, key), getattr(ref, key))
        identical.append(same)
    if (graphed.captures, graphed.replays) != (1, 2):
        raise AssertionError(f"graphed {mode}: {graphed.captures} captures, "
                             f"{graphed.replays} replays")
    log(f"graphed {mode}: tokens equal to eager in 3 calls (1 capture, 2 "
        f"replays), masks/taxonomy bit-identical {identical}, launches per "
        f"call as eager; decode graph adds {graphed.decode_launches()} a "
        f"replay | latency eager {[round(t, 1) for t in eager_ms]} ms, "
        f"graphed {[round(t, 1) for t in graph_ms]} ms (first captures; host "
        f"clock, synchronized) | {CARD}")
    req = make_requests(cfg, B, P, seed=1)
    profile_call(f"graphed evaluate {mode}", lambda: graphed(*req))
    return results, graph_ms


# The 7b bf16 speculative token check: where the speculative stream parts
# from greedy's, greedy's top-2 logit gap at that step must be within
# 2^-6 of the top logit's magnitude (a near tie that bf16 rounding of a
# verify chunk can flip); a larger gap is a bug, not rounding. With MoE
# layers a second near tie can flip it: a router's top-k choice, after
# which the token's MLP sums other experts. So a parting with a larger
# logit gap passes only where the token's experts differ between greedy's
# forward and the verify forward, and at the first MoE layer where they
# do, greedy's k-th and (k+1)-th router probabilities lie within 2^-6 of
# the k-th (the same rule, on the router's decision).
TOP2_GAP_LIMIT = 2.0 ** -6


@contextlib.contextmanager
def uncounted():
    """Launches inside the block are left out of _build.LAUNCHES: a
    check's recomputation is not a launch of the path it checks."""
    from haff_tpu_torch.kernels import _build

    saved = collections.Counter(_build.LAUNCHES)
    try:
        yield
    finally:
        _build.LAUNCHES.clear()
        _build.LAUNCHES.update(saved)


class RoutingTrace:
    """While active, every decoder forward of `model` is recorded as
    (router probabilities of each MoE layer, (tokens, E) float32; logits,
    float32) in `calls` (forward hooks; eager calls only)."""

    def __init__(self, model):
        self.model, self.calls, self._probs, self._hooks = model, [], [], []

    def __enter__(self):
        from haff_tpu_torch.nn.moe import MoEMLP

        for m in self.model.modules():
            if isinstance(m, MoEMLP):
                self._hooks.append(m.router.register_forward_hook(
                    lambda mod, a, out: self._probs.append(
                        torch.softmax(out.float(), dim=-1))))
        llm = self.model.llm
        self._hooks.append(llm.register_forward_pre_hook(
            lambda mod, a: self._probs.clear()))
        self._hooks.append(llm.register_forward_hook(
            lambda mod, a, out: self.calls.append((list(self._probs),
                                                   out[0].float()))))
        return self

    def __exit__(self, *exc):
        for h in self._hooks:
            h.remove()


def greedy_top2(model, req, tokens, row, step, eos_id, kv8=False):
    """Greedy's two largest logits at decode `step` of `row`, recomputed
    eagerly through generate's own prefill and decode_loop, into caches of
    greedy's size and kind (`kv8`: int8); the recomputed tokens must equal
    greedy's `tokens` up to `step`. Returns (gap, top, the token's router
    probabilities at each MoE layer: (E,) tensors, none without MoE
    layers)."""
    from haff_tpu_torch.infer.evaluate import _inputs, _prompt
    from haff_tpu_torch.infer.generate import DecodeState, decode_loop, prefill

    _, images_clip, ids, att = _inputs(model, *req)
    tokens = tokens.long().to(model.device)
    b = ids.shape[0]
    with torch.inference_mode(), RoutingTrace(model) as trace:
        sp = _prompt(model, images_clip, ids, att)
        state = DecodeState(model.llm.cfg, b, sp.embeds.shape[1],
                            tokens.shape[1], model.device, kv_cache_8bit=kv8)
        prefill(state, model.llm_forward, sp.embeds, sp.positions,
                sp.segment_ids, sp.segment_ids.sum(dim=1))
        decode_loop(state, model.embed_tokens, model.llm_forward, step + 1,
                    eos_id)
    if not torch.equal(state.tokens[:, :step + 1], tokens[:, :step + 1]):
        raise AssertionError(f"greedy's eager recomputation parts from its "
                             f"tokens before step {step}")
    top = state.last_logits[row].float().topk(2).values
    # The forward that chose token `step`: the prefill at the row's last
    # prompt position, or decode forward `step`.
    probs, _ = trace.calls[step]
    pos = int(sp.segment_ids[row].sum()) - 1 if step == 0 else 0
    routing = [x.reshape(b, -1, x.shape[-1])[row, pos] for x in probs]
    return float(top[0] - top[1]), float(top[0].abs()), routing


def router_near_tie(model, req, spec_kw, got, row, step, greedy_routing):
    """The MoE clause of the near-tie rule for a parting at (row, step):
    runs the same speculative evaluate eagerly (its tokens must equal the
    graphed call's, `got`), recording each verify step's emitted counts
    and each forward's routing, finds the verify forward that chose token
    `step` and compares the token's top-k experts there with greedy's
    (`greedy_routing`, from greedy_top2). Returns a description of the
    first MoE layer where they differ, whose greedy k-th and (k+1)-th
    probabilities must lie within TOP2_GAP_LIMIT of the k-th; raises
    otherwise."""
    from haff_tpu_torch.infer import generate as G
    from haff_tpu_torch.infer.evaluate import evaluate_fn

    k = min(model.cfg.llama.moe_top_k, model.cfg.llama.moe_num_experts)
    real, counts = G.verify_step, []

    def verify_step(state, *a):
        before = int(state.emitted[row])
        real(state, *a)
        counts.append((before, int(state.emitted[row])))

    G.verify_step = verify_step
    try:
        with RoutingTrace(model) as trace:
            eager = evaluate_fn(model, *req, **spec_kw)
    finally:
        G.verify_step = real
    if not torch.equal(eager.output_ids, got.output_ids):
        raise AssertionError("speculative: the eager rerun's tokens differ "
                             "from the graphed call's")
    for v, (before, after) in enumerate(counts):
        p = step - 1 - before
        if 0 <= p < after - before:
            probs, _ = trace.calls[1 + v]  # calls[0] is the prefill
            b = got.output_ids.shape[0]
            verify = [x.reshape(b, -1, x.shape[-1])[row, p] for x in probs]
            break
    else:
        raise AssertionError(f"speculative: no verify step chose token {step}")
    for layer, (g, v) in enumerate(zip(greedy_routing, verify)):
        top_g, idx_g = g.topk(k + 1)
        if set(idx_g[:k].tolist()) == set(v.topk(k).indices.tolist()):
            continue
        gap = float(top_g[k - 1] - top_g[k])
        what = (f"router near tie at MoE layer {layer} (model layer "
                f"{model.moe_layers[layer]}): greedy's experts "
                f"{idx_g[:k].tolist()}, the verify step's "
                f"{v.topk(k).indices.tolist()}; greedy's k-th and (k+1)-th "
                f"probabilities {float(top_g[k - 1]):.5f}, "
                f"{float(top_g[k]):.5f}")
        if gap > TOP2_GAP_LIMIT * float(top_g[k - 1]):
            raise AssertionError(f"speculative: tokens part from greedy's at "
                                 f"row {row} step {step}, first routing "
                                 f"difference not a near tie: {what}")
        return what
    raise AssertionError(f"speculative: tokens part from greedy's at row "
                         f"{row} step {step} with the same experts in every "
                         "MoE layer")


def run_speculative(model, mode, cfg, launches, greedy, greedy_ms,
                    label=None):
    """Speculative decode through make_jitted_evaluate(draft_corpus=...) on
    the 7b model run_slice built ("bf16", or "w8a8" with the int8 cache):
    batch 2, prompt 320, 16 new tokens, 8 tokens a verify step, the verify
    step captured in a CUDA graph (a capture call, then two replayed
    calls: requests 0, 1, 0 as the greedy graphed calls `greedy`). Two
    corpora: the oracle (each row's greedy tokens of requests 0 and 1, the
    best case) and answer_template_corpus(ByteTokenizer) (which a random
    model mostly rejects: the worst case). Each call: launches exactly as
    derived from its decode steps (the prefill's 32 flash launches, the
    SAM encoder's, no decode_attn, and at 8 bits each quantized layer
    once a forward: the prefill and every verify step, M = 16 on the
    skinny kernel), decode steps equal to the graph's replays, and the
    tokens against greedy's: equal, or else the first step where they
    part must be a near tie of greedy's (TOP2_GAP_LIMIT), of its logits
    or, with MoE layers, of a router's choice (router_near_tie). Prints
    latency beside greedy's, steps and tokens a step; profiles a replayed call.
    `label` names the model in the log (default `mode`). Returns the
    launch counts of its calls (the profiled ones included; the near-tie
    checks' recomputations left out)."""
    from haff_tpu_torch.data.tokenizer import ByteTokenizer
    from haff_tpu_torch.infer.evaluate import make_jitted_evaluate
    from haff_tpu_torch.infer.generate import answer_template_corpus
    from haff_tpu_torch.kernels import _build

    B, P, T, D = 2, 320, 16, 8
    label = label or mode
    oracle = torch.cat([greedy[0].output_ids, greedy[1].output_ids], dim=1)
    template, template_len = answer_template_corpus(ByteTokenizer())
    base = {k: v for k, v in PER_EVALUATE.items() if k != "decode_attn"}
    launches.clear()
    for name, corpus, lens in (("oracle", oracle, None),
                               ("template", template, template_len)):
        ev = make_jitted_evaluate(model, T, 2, kv_cache_8bit=mode == "w8a8",
                                  draft_corpus=corpus, corpus_lengths=lens,
                                  draft_len=D)
        lat, steps, per_step, verdicts = [], [], [], []
        replays = router_ties = 0
        for i, seed in enumerate((0, 1, 0)):
            req = make_requests(cfg, B, P, seed=seed)
            before = collections.Counter(_build.LAUNCHES)
            replays_before = ev.replays
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = ev(*req)
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t0) * 1e3)
            ran = collections.Counter(_build.LAUNCHES)
            ran.subtract(before)
            ran = +ran
            n = int(got.decode_steps)
            if i and ev.replays - replays_before != n:
                raise AssertionError(f"speculative {label} {name} call {i}: "
                                     f"{n} decode steps, "
                                     f"{ev.replays - replays_before} replays")
            replays += ev.replays - replays_before
            want = dict(base)
            if mode == "w8a8":
                want["w8a8_matmul"] = product_launches(model, "w8a8", 1 + n)
            if ran != want:
                raise AssertionError(f"speculative {label} {name} call {i}: "
                                     f"launches {dict(ran)}, expected {want} "
                                     f"({n} decode steps)")
            steps.append(n)
            per_step.append(round(float(got.gen_lengths.float().mean()) / n, 3))
            ref = greedy[i]
            for key, t in (("pred_masks_left", (B, 1024, 1024)),
                           ("taxonomies", (B, 4))):
                out = getattr(got, key)
                if tuple(out.shape) != t or not torch.isfinite(out).all():
                    raise AssertionError(f"speculative {label} {name}: {key}")
            if (torch.equal(got.output_ids, ref.output_ids)
                    and torch.equal(got.gen_lengths, ref.gen_lengths)):
                verdicts.append("tokens equal")
                continue
            diff = (got.output_ids != ref.output_ids).int()
            row = int(diff.any(dim=1).int().argmax())
            step = int(diff[row].argmax())
            with uncounted():
                gap, top, routing = greedy_top2(model, req, ref.output_ids,
                                                row, step, 2, mode == "w8a8")
            verdicts.append(f"row {row} parts at step {step}: greedy top-2 "
                            f"gap {gap:.4g}, top |logit| {top:.4g}")
            if gap > TOP2_GAP_LIMIT * top and routing:
                with uncounted():
                    verdicts[-1] += "; " + router_near_tie(
                        model, req, dict(max_new_tokens=T, eos_id=2,
                                         kv_cache_8bit=mode == "w8a8",
                                         draft_corpus=corpus,
                                         corpus_lengths=lens, draft_len=D),
                        got, row, step, routing)
                router_ties += 1
            elif gap > TOP2_GAP_LIMIT * top:
                raise AssertionError(
                    f"speculative {label} {name} call {i}: tokens part from "
                    f"greedy's at row {row} step {step} where greedy's top-2 "
                    f"gap {gap} exceeds 2^-6 of |top logit| {top}")
        if ev.captures != 1:
            raise AssertionError(f"speculative {label} {name}: {ev.captures} "
                                 "captures")
        log(f"speculative {label} {name}: decode steps {steps} (16 tokens; "
            f"tokens a step {per_step}), {replays} replays of the verify "
            f"graph in calls 2-3; {verdicts}; router near-tie clause passed "
            f"{router_ties} of {len(verdicts)} calls; launches as derived "
            f"| latency "
            f"{[round(t, 1) for t in lat]} ms (first captures) against greedy "
            f"graphed {[round(t, 1) for t in greedy_ms]} ms (host clock, "
            f"synchronized) | {CARD}")
        req = make_requests(cfg, B, P, seed=1)
        profile_call(f"graphed speculative {label} {name}", lambda: ev(*req))
    return dict(launches)


def png_b64(frame):
    import base64

    import cv2

    ok, buf = cv2.imencode(".png", frame[:, :, ::-1])
    if not ok:
        raise AssertionError("PNG encoding failed")
    return base64.b64encode(buf.tobytes()).decode()


def png_mask(b64):
    import base64

    import cv2

    return cv2.imdecode(np.frombuffer(base64.b64decode(b64), np.uint8),
                        cv2.IMREAD_GRAYSCALE)


def post_predict(url, frame, prompt, timeout=600):
    """POST /predict; returns (answer JSON, latency ms on the host clock)."""
    import urllib.request

    body = json.dumps({"image": png_b64(frame), "prompt": prompt}).encode()
    req = urllib.request.Request(f"{url}/predict", data=body, headers={
        "Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=timeout) as r:
        out = json.loads(r.read())
    return out, (time.perf_counter() - t0) * 1e3


def serve(predictor, batch_size, max_wait_ms):
    """The port's MicroBatcher and HTTP handler on 127.0.0.1, an ephemeral
    port. Returns (server, batcher, url); stop with stop_serving."""
    import threading
    from http.server import ThreadingHTTPServer

    from haff_tpu_torch.infer.server import MicroBatcher, make_handler

    batcher = MicroBatcher(predictor.predict_batch, batch_size=batch_size,
                           max_wait_ms=max_wait_ms)
    srv = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(batcher))
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, batcher, f"http://127.0.0.1:{srv.server_address[1]}"


def stop_serving(srv, batcher):
    srv.shutdown()
    srv.server_close()
    batcher.close()


def check_tiny_serving():
    """The serving front door at tiny in float32, card (kernels, the
    decode loop in a CUDA graph) against the CPU (plain versions, eager)
    from the same weights: Predictor.predict_batch, one HTTP answer
    through the MicroBatcher and the handler, and StreamingPipeline over a
    5-frame clip in chunks of 2. Identical text, logits and taxonomy
    within 1e-3, the HTTP masks equal but where a CPU logit lies within
    1e-3 of the threshold's."""
    from haff_tpu_torch.infer.predictor import Predictor
    from haff_tpu_torch.infer.streaming import StreamingPipeline

    kw = dict(model_preset="tiny", precision="fp32", max_new_tokens=6,
              max_text_len=448)
    gpu = Predictor(**kw, device="cuda")
    cpu = Predictor(**kw, device="cpu")
    cpu.model.load_state_dict({k: v.cpu() for k, v in
                               gpu.model.state_dict().items()})
    rng = np.random.RandomState(21)
    frames = [rng.randint(0, 256, hw + (3,)).astype(np.uint8)
              for hw in ((60, 90), (72, 40))]
    prompts = ["open the drawer", "grab the cup"]
    worst = 0.0
    for call in range(3):  # a capture and two replays on the card
        got = gpu.predict_batch(frames, prompts)
        ref = cpu.predict_batch(frames, prompts)
        texts = [g[0] for g in got]
        for g, r in zip(got, ref):
            if g[0] != r[0]:
                raise AssertionError(f"tiny serving: text {g[0]!r} vs "
                                     f"{r[0]!r}")
            for a, b in zip(g[1:], r[1:]):
                np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-3)
                worst = max(worst, float(np.abs(a - b).max()))
    answers = []
    for pred in (gpu, cpu):
        srv, batcher, url = serve(pred, batch_size=1, max_wait_ms=5.0)
        try:
            answers.append(post_predict(url, frames[0], prompts[0])[0])
        finally:
            stop_serving(srv, batcher)
    got, ref = answers
    logits = cpu(frames[0], prompts[0])
    if got["answer"] != ref["answer"]:
        raise AssertionError("tiny serving: HTTP answers differ")
    np.testing.assert_allclose(got["taxonomy"], ref["taxonomy"], rtol=1e-3,
                               atol=1e-3)
    for key, lg in (("mask_left", logits[1]), ("mask_right", logits[2])):
        diff = png_mask(got[key]) != png_mask(ref[key])
        if (diff & (np.abs(lg) >= 1e-3)).any():  # threshold 0.5: logit 0
            raise AssertionError(f"tiny serving: HTTP {key} differs")
    clip = np.random.RandomState(22).randint(0, 256, (5, 48, 64, 3)).astype(
        np.uint8)
    runs = [list(StreamingPipeline(p.model, p.tok, "open drawer", chunk=2,
                                   max_new_tokens=6, max_text_len=160)
                 .run(clip)) for p in (gpu, cpu)]
    for g, r in zip(*runs):
        for key in ("masks_left", "masks_right", "taxonomies"):
            np.testing.assert_allclose(g[key], r[key], rtol=1e-3, atol=1e-3)
            worst = max(worst, float(np.abs(g[key] - r[key]).max()))
    if len(runs[0]) != 3:
        raise AssertionError(f"tiny stream: {len(runs[0])} chunks")
    log(f"tiny serving: card (kernels, decode graph, f32) vs CPU (plain, "
        f"eager): Predictor text identical {texts} in 3 calls, HTTP answer "
        f"identical, stream 3 chunks; max abs err {worst:.3g}")


def check_small_cli():
    """infer/cli.py main at the small preset with the trained weights of
    artifacts/overfit_small_params.npz, float32, over a 2-frame benchmark
    folder written under runs/: once with --device cuda, once with
    --device cpu. The same files; the PNGs equal but at pixels whose CPU
    logit lies within 1e-3 of a threshold's logit."""
    import os
    import shutil

    import cv2

    from haff_tpu_torch.infer import cli

    root = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(root, "runs", "chip_smoke_cli")
    shutil.rmtree(work, ignore_errors=True)
    rng = np.random.RandomState(31)
    for i, narration in enumerate(("Open Drawer", "cut onion")):
        fdir = os.path.join(work, "bench", "vid", f"{i:07d}")
        os.makedirs(fdir)
        cv2.imwrite(os.path.join(fdir, "inpainting.png"),
                    rng.randint(0, 256, (360, 640, 3)).astype(np.uint8))
        with open(os.path.join(fdir, "annotation.json"), "w") as f:
            json.dump({"narration": narration}, f)
    cpu_logits = {}
    real = cli.write_threshold_masks

    def keep(base, vid, frame, left, right, tax, ths):
        if base.endswith("cpu/vis"):
            cpu_logits[frame] = (left, right)
        real(base, vid, frame, left, right, tax, ths)

    args = ["--benchmark_dir", os.path.join(work, "bench"), "--model_preset",
            "small", "--precision", "fp32", "--batch", "2",
            "--max_new_tokens", "8", "--checkpoint",
            os.path.join(root, "artifacts", "overfit_small_params.npz")]
    cli.write_threshold_masks = keep
    try:
        for dev in ("cuda", "cpu"):
            cli.main(args + ["--vis_save_path", os.path.join(work, dev, "vis"),
                             "--device", dev])
    finally:
        cli.write_threshold_masks = real
    files = {}
    for dev in ("cuda", "cpu"):
        base = os.path.join(work, dev)
        files[dev] = sorted(os.path.relpath(os.path.join(d, f), base)
                            for d, _, fs in os.walk(base) for f in fs)
    if files["cuda"] != files["cpu"] or len(files["cpu"]) < 10:
        raise AssertionError(f"small cli: files differ {files}")
    off = 0
    for rel in files["cpu"]:
        th = float(rel.split(os.sep)[0][len("vis"):])
        frame = rel.split(os.sep)[2]
        side = 0 if rel.endswith("aff_left.png") else 1
        lg = cpu_logits[frame][side]
        got = cv2.imread(os.path.join(work, "cuda", rel), cv2.IMREAD_GRAYSCALE)
        ref = cv2.imread(os.path.join(work, "cpu", rel), cv2.IMREAD_GRAYSCALE)
        near = np.abs(lg - np.log(th / (1 - th))) < 1e-3
        if got.shape != ref.shape or ((got != ref) & ~near).any():
            raise AssertionError(f"small cli: {rel} differs")
        off += int((got != ref).sum())
    shutil.rmtree(work, ignore_errors=True)
    log(f"small cli: trained weights, --device cuda vs --device cpu: "
        f"{len(files['cpu'])} PNGs equal but {off} pixels within 1e-3 of a "
        "threshold")


def run_serve(launches):
    """The serving front door at the full 7b preset in bf16: a Predictor
    (seeded random weights) behind the MicroBatcher (batch 2) and the HTTP
    handler; four concurrent POST /predict with seeded 720 x 1280 PNG
    frames make two batches. Then StreamingPipeline on the same model over
    a seeded 5-frame 720 x 1280 clip in chunks of 2. Returns the launch
    counts of the two paths."""
    from concurrent.futures import ThreadPoolExecutor

    from haff_tpu_torch.infer.predictor import Predictor
    from haff_tpu_torch.infer.streaming import StreamingPipeline

    t0 = time.perf_counter()
    pred = Predictor(model_preset="7b", precision="bf16", max_new_tokens=16,
                     max_text_len=320, device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    H, W = 720, 1280
    rng = np.random.RandomState(11)
    frames = [rng.randint(0, 256, (H, W, 3)).astype(np.uint8)
              for _ in range(4)]
    prompts = ["open the drawer", "cut the onion", "pour the water",
               "hold the cup"]
    t0 = time.perf_counter()  # the server's warm-up: the graph's capture
    pred.predict_batch(frames[:2], ["warmup"] * 2)
    warm_ms = (time.perf_counter() - t0) * 1e3
    srv, batcher, url = serve(pred, batch_size=2, max_wait_ms=2000.0)
    try:
        launches.clear()
        with ThreadPoolExecutor(4) as pool:
            answers = list(pool.map(lambda a: post_predict(url, *a),
                                    zip(frames, prompts)))
        torch.cuda.synchronize()
        serve_counts = dict(launches)
        sizes = list(batcher.batch_sizes)
    finally:
        stop_serving(srv, batcher)
    if sizes != [2, 2]:
        raise AssertionError(f"serve_bf16: batch sizes {sizes}, expected "
                             "[2, 2]")
    for name, per in PER_EVALUATE.items():
        if serve_counts.get(name) != per * 2:
            raise AssertionError(f"serve_bf16: {name}: "
                                 f"{serve_counts.get(name)} launches in 2 "
                                 f"batches, expected {per * 2}")
    for out, _ in answers:
        if set(out) != {"answer", "taxonomy", "mask_left", "mask_right"}:
            raise AssertionError(f"serve_bf16: answer keys {sorted(out)}")
        for key in ("mask_left", "mask_right"):
            m = png_mask(out[key])
            if m is None or m.shape != (H, W) or not set(
                    np.unique(m)) <= {0, 255}:
                raise AssertionError(f"serve_bf16: {key} decodes to "
                                     f"{None if m is None else m.shape}")
        tax = np.asarray(out["taxonomy"])
        if tax.shape != (4,) or not np.isfinite(tax).all() or \
                abs(float(tax.sum()) - 1.0) > 1e-2:
            raise AssertionError(f"serve_bf16: taxonomy {tax}")
    log(f"serve_bf16: 7b Predictor built in {build_s:.1f} s, warm-up batch "
        f"(decode graph capture) {warm_ms:.1f} ms; 4 concurrent POST "
        f"/predict of {H} x {W} PNG frames in batches {sizes}: per-request "
        f"latency {[round(ms, 1) for _, ms in answers]} ms (host clock, "
        f"client side); launches {serve_counts} | {CARD}")

    clip = np.random.RandomState(12).randint(0, 256, (5, H, W, 3)).astype(
        np.uint8)
    pipe = StreamingPipeline(pred.model, pred.tok, "open the drawer", chunk=2,
                             max_new_tokens=16, max_text_len=320)
    launches.clear()
    chunk_ms, seen = [], collections.Counter()
    t0 = time.perf_counter()
    for out in pipe.run(clip):
        n = min(2, 5 - out["start"])
        chunk_ms.append((time.perf_counter() - t0) * 1e3)
        S = pred.cfg.sam_encoder.image_size
        for key, shape in (("masks_left", (n, S, S)),
                           ("masks_right", (n, S, S)),
                           ("taxonomies", (n, 4))):
            if out[key].shape != shape or not np.isfinite(out[key]).all():
                raise AssertionError(f"stream chunk {out['start']}: {key} "
                                     f"{out[key].shape}")
        seen[out["start"]] += 1
        for name, per in PER_EVALUATE.items():
            if launches[name] != per * len(seen):
                raise AssertionError(f"stream: {name}: {launches[name]} "
                                     f"launches after {len(seen)} chunks")
        t0 = time.perf_counter()
    if sorted(seen) != [0, 2, 4]:
        raise AssertionError(f"stream: chunks {sorted(seen)}")
    stream_counts = dict(launches)
    log(f"stream: 7b bf16 StreamingPipeline, 5 frames of {H} x {W} in chunks "
        f"of 2 (last padded): per-chunk latency "
        f"{[round(t, 1) for t in chunk_ms]} ms (first captures; host clock); "
        f"launches {stream_counts} | {CARD}")
    del pipe, pred
    return serve_counts, stream_counts


def profile_call(what, fn):
    """One call of `fn` under torch.profiler: device time by kernel and
    the device's idle share of the call's wall time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev_us = lambda e: getattr(e, "self_device_time_total",  # noqa: E731
                               getattr(e, "self_cuda_time_total", 0))
    # Device-side events only (kernels, copies): an operator's own row, or
    # a user annotation's range on the device timeline (AdamW.step), would
    # count its kernels' time a second time.
    rows = sorted(((dev_us(e), e.count, e.key) for e in prof.key_averages()
                   if str(e.device_type).endswith("CUDA") and dev_us(e) > 0
                   and not getattr(e, "is_user_annotation", False)),
                  reverse=True)
    busy = sum(r[0] for r in rows)
    log(f"profile: {what} wall {wall_us / 1e3:.1f} ms (profiled), device "
        f"busy {busy / 1e3:.1f} ms, idle share {1 - busy / wall_us:.3f} | "
        f"{CARD}")
    for us, count, key in rows[:15]:
        log(f"  {us / 1e3:9.3f} ms  {count:6d}x  {key[:90]}")


def make_train_batch(cfg, batch, prompt_len, seed, image_index, pad):
    """Seeded TrainBatch as bench_train.py:58-80 builds it: random ids with
    the image token at 2 and one [SEG], labels ignoring the first 20,
    random masks, taxonomy class 2; row 1's attention mask right-padded by
    `pad` tokens. Images are shared through `image_index`."""
    from haff_tpu_torch.core.config import IGNORE_INDEX, IMAGE_TOKEN_INDEX
    from haff_tpu_torch.model.lisa import TrainBatch

    rng = np.random.RandomState(seed)
    S, C = cfg.sam_encoder.image_size, cfg.clip.image_size
    n_img = max(image_index) + 1
    ids = rng.randint(5, min(30000, cfg.llama.vocab_size - 10),
                      (batch, prompt_len)).astype(np.int64)
    ids[:, 0] = 1
    ids[:, 2] = IMAGE_TOKEN_INDEX
    ids[:, min(40, prompt_len - 2)] = cfg.seg_token_idx
    labels = ids.copy()
    labels[:, :20] = IGNORE_INDEX
    attn = np.ones((batch, prompt_len), np.int64)
    attn[1, prompt_len - pad:] = 0
    return TrainBatch(
        images_sam=rng.randn(n_img, S, S, 3).astype(np.float32),
        images_clip=rng.randn(n_img, C, C, 3).astype(np.float32),
        image_index=np.asarray(image_index, np.int64), input_ids=ids,
        labels=labels, attention_mask=attn,
        masks_left=(rng.rand(batch, S, S) > 0.9).astype(np.float32),
        masks_right=(rng.rand(batch, S, S) > 0.9).astype(np.float32),
        taxonomies=np.tile([[0, 0, 1, 0]], (batch, 1)).astype(np.float32),
        valid_region=np.ones((batch, S, S), np.float32),
        sample_weight=np.ones((batch,), np.float32))


def fingerprint(p):
    """Two integer checksums of a tensor's bit patterns (exact: any
    changed element changes them, bar a compensating change)."""
    bits = p.detach().reshape(-1).view(
        torch.int32 if p.element_size() == 4 else torch.int16).long()
    return int(bits.sum()), int((bits * bits).sum())


def check_tiny_train():
    """3 train steps at tiny, LoRA rank 2, float32: card (kernels) against
    CPU (plain versions) from the same weights and batch. LoRA dropout is
    0 here: its masks come from per-device generators, which draw
    different bits on the card and the CPU."""
    from haff_tpu_torch.core.config import ModelConfig, TrainConfig
    from haff_tpu_torch.model.lisa import LisaModel
    from haff_tpu_torch.train import trainer as T

    base = ModelConfig.preset("tiny")
    cfg = base.replace(llama=dataclasses.replace(
        base.llama, lora_rank=2, lora_dropout=0.0))
    gpu = LisaModel(cfg, torch.float32, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(1))
    with torch.no_grad():  # nonzero adapters, so lora_a gets gradient too
        for name, p in gpu.named_parameters():
            if name.endswith("lora_b"):
                p.normal_(0.0, 0.02)
    cpu = LisaModel(cfg, torch.float32, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    host_batch = make_train_batch(cfg, 3, 24, seed=5, image_index=[0, 0, 1],
                                  pad=5)
    tcfg = TrainConfig(model=cfg, lr=1e-4, warmup_steps=1, total_steps=20,
                       grad_accumulation_steps=1)
    runs = []
    for model in (gpu, cpu):
        batch = host_batch.to(model.device)
        trainable, frozen = T.partition_params(model)
        start = {k: fingerprint(p) for k, p in frozen.items()}
        out = model(batch, remat=True)
        out.loss.backward()
        grads = {k: p.grad.cpu().clone() for k, p in trainable.items()
                 if p.grad is not None}
        state = T.init_train_state(tcfg, trainable)
        step = T.make_train_step(model, tcfg)
        metrics = []
        for _ in range(3):
            state, m = step(state, batch, 0)
            metrics.append({k: float(v) for k, v in m.items()})
        if any(fingerprint(p) != start[k] for k, p in frozen.items()):
            raise AssertionError("tiny train: a frozen parameter changed")
        runs.append((grads, metrics,
                     {k: p.detach().cpu() for k, p in trainable.items()}))
    (g_gpu, m_gpu, p_gpu), (g_cpu, m_cpu, p_cpu) = runs
    if set(g_gpu) != set(g_cpu):
        raise AssertionError("tiny train: different parameters got gradient")
    worst = 0.0
    for k, r in g_cpu.items():
        err = float((g_gpu[k] - r).abs().max())
        if err > 1e-3 * float(r.abs().max()) + 1e-6:
            raise AssertionError(f"tiny train: grad {k} max abs err {err}")
        worst = max(worst, err)
    for a, r in zip(m_gpu, m_cpu):
        for k in r:
            if abs(a[k] - r[k]) > 1e-3 * max(1.0, abs(r[k])):
                raise AssertionError(f"tiny train: {k} {a[k]} vs {r[k]}")
    for k, r in p_cpu.items():
        torch.testing.assert_close(p_gpu[k], r, rtol=1e-3, atol=1e-3)
    log(f"tiny train: card (kernels, f32) vs CPU (plain, f32): gradients of "
        f"{len(g_cpu)} trainable tensors max abs err {worst:.3g}; losses "
        f"{[round(m['loss'], 5) for m in m_gpu]} vs "
        f"{[round(m['loss'], 5) for m in m_cpu]}; frozen unchanged")


def run_train_slice(launches):
    """6 train steps at the 7b preset, LoRA rank 8, bf16, remat, on one
    batch (bench_train.py's recipe at batch 2). Returns the launch counts
    over the 6 steps."""
    from haff_tpu_torch.core.config import ModelConfig, TrainConfig
    from haff_tpu_torch.model.lisa import LisaModel
    from haff_tpu_torch.train import trainer as T

    base = ModelConfig.preset("7b")
    cfg = base.replace(llama=dataclasses.replace(base.llama, lora_rank=8))
    t0 = time.perf_counter()
    model = LisaModel(cfg, torch.bfloat16, device="cuda",
                      generator=torch.Generator("cuda").manual_seed(0))
    trainable, frozen = T.partition_params(model)
    torch.cuda.synchronize()
    log(f"train: 7b + LoRA r8 built in {time.perf_counter() - t0:.1f} s: "
        f"{T.count_params(trainable) / 1e9:.4f} B trainable (f32), "
        f"{T.count_params(frozen) / 1e9:.3f} B frozen (bf16), "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    tcfg = TrainConfig(model=cfg, lr=3e-4, warmup_steps=1, total_steps=1000,
                       grad_accumulation_steps=1)
    assert tcfg.remat
    state = T.init_train_state(tcfg, trainable)
    step = T.make_train_step(model, tcfg)
    batch = make_train_batch(cfg, 2, 320, seed=0, image_index=[0, 1],
                             pad=100).to("cuda")
    frozen0 = {k: fingerprint(p) for k, p in frozen.items()}
    train0 = {k: fingerprint(p) for k, p in trainable.items()}
    torch.cuda.reset_peak_memory_stats()
    launches.clear()  # count the train path's launches only
    losses, times = [], []
    for i in range(6):
        before = dict(launches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch, 0)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        m = {k: float(v) for k, v in m.items()}
        if not all(np.isfinite(v) for v in m.values()):
            raise AssertionError(f"train step {i}: non-finite metrics {m}")
        for name, per in PER_TRAIN_STEP.items():
            got = launches[name] - before.get(name, 0)
            if got != per:
                raise AssertionError(f"train step {i}: {name} launched {got} "
                                     f"times, expected {per}")
        losses.append(m["loss"])
        log(f"train step {i}: {times[-1] * 1e3:.1f} ms (host clock, "
            f"synchronized); " + ", ".join(f"{k} {v:.5f}" for k, v in m.items()))
    counts = dict(launches)
    peak = torch.cuda.max_memory_allocated() / 2**30
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train: loss did not fall {losses}")
    if any(fingerprint(p) != frozen0[k] for k, p in frozen.items()):
        raise AssertionError("train: a frozen weight changed")
    changed = {k for k, p in trainable.items() if fingerprint(p) != train0[k]}
    must = [k for k in trainable if k.endswith(("lora_a", "lora_b"))
            or k in ("llm.embed_tokens.weight", "llm.lm_head.weight",
                     "text_fc1.weight", "text_fc2.weight")]
    missing = [k for k in must if k not in changed]
    for dec in ("mask_decoder_left", "mask_decoder_right"):
        if not any(dec in k for k in changed):
            missing.append(dec)
    if missing:
        raise AssertionError(f"train: trainable weights unchanged: {missing}")
    steady = times[1:]
    log(f"train: losses {[round(x, 5) for x in losses]}; step time "
        f"{[round(t * 1e3, 1) for t in times]} ms, steady mean "
        f"{np.mean(steady) * 1e3:.1f} ms = {2 / np.mean(steady):.3f} "
        f"samples/s; peak memory {peak:.2f} GiB; {len(changed)} of "
        f"{len(trainable)} trainable tensors changed; launches over 6 "
        f"steps {counts}")
    profile_call("train step", lambda: step(state, batch, 0))
    return counts


# Launches per train step of the train_moe model (4 LLaMA layers, remat):
# the frozen SAM encoder's forward, each layer's flash forward twice and
# its two backward kernels once.
TRAIN_MOE_LAYERS = 4
PER_TRAIN_MOE_STEP = dict(PER_TRAIN_STEP,
                          flash_prefill_fwd=2 * TRAIN_MOE_LAYERS,
                          flash_bwd_dq=TRAIN_MOE_LAYERS,
                          flash_bwd_dkv=TRAIN_MOE_LAYERS)


def run_train_moe(launches):
    """train_moe: make_train_step at LLaMA-7B widths cut to 4 layers, MoE
    MLPs in layers 1 and 3 (MOE_7B: 8 experts, top-2, 2.16 B expert
    parameters), with CLIP ViT-L and SAM ViT-H; LoRA r8 on q/v, the
    experts and routers trained (`extra=("moe",)`, float32 with AdamW
    moments), bf16 compute, remat, batch 2 (prompt 320 spliced to 575), 4
    steps on one batch. The depth is cut because the 32-layer model's 16
    MoE layers hold 17.3 B expert parameters: trained in float32 with
    AdamW that is ~277 GB, more than one card. Checks: the loss with
    moe_aux_weight 0.01 differs from the loss without the term on the same
    batch, finite metrics, exact launches a step (PER_TRAIN_MOE_STEP), the
    experts and routers changed, frozen weights unchanged. Prints the aux
    term, step times, samples/s and peak memory; profiles one step.
    Returns the launch counts over the 4 steps."""
    from haff_tpu_torch.core.config import ModelConfig, TrainConfig
    from haff_tpu_torch.model.lisa import LisaModel
    from haff_tpu_torch.train import trainer as T

    base = ModelConfig.preset("7b")
    cfg = base.replace(llama=dataclasses.replace(
        base.llama, lora_rank=8, num_layers=TRAIN_MOE_LAYERS, **MOE_7B))
    t0 = time.perf_counter()
    model = LisaModel(cfg, torch.bfloat16, device="cuda",
                      generator=torch.Generator("cuda").manual_seed(0))
    trainable, frozen = T.partition_params(model, extra=("moe",))
    torch.cuda.synchronize()
    experts = {k: p for k, p in trainable.items() if ".moe." in k}
    log(f"train moe: 7b widths, {TRAIN_MOE_LAYERS} layers (depth cut from "
        f"32), MoE layers {model.moe_layers}, LoRA r8, built in "
        f"{time.perf_counter() - t0:.1f} s: "
        f"{T.count_params(trainable) / 1e9:.4f} B trainable (f32; "
        f"{T.count_params(experts) / 1e9:.4f} B in the MoE layers), "
        f"{T.count_params(frozen) / 1e9:.3f} B frozen (bf16), "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    tcfg = TrainConfig(model=cfg, lr=3e-4, warmup_steps=1, total_steps=1000,
                       grad_accumulation_steps=1)
    assert tcfg.remat and cfg.llama.moe_aux_weight == 0.01
    state = T.init_train_state(tcfg, trainable)
    step = T.make_train_step(model, tcfg)
    batch = make_train_batch(cfg, 2, 320, seed=0, image_index=[0, 1],
                             pad=100).to("cuda")
    with torch.no_grad():
        out = model(batch)
        weighted = T.with_moe_aux(model, out)
    aux, plain, total = (float(out.moe_aux), float(out.loss),
                         float(weighted.loss))
    if not (np.isfinite(aux) and np.isfinite(total)) or total == plain:
        raise AssertionError(f"train moe: loss {plain} without the aux term, "
                             f"{total} with it (aux {aux})")
    frozen0 = {k: fingerprint(p) for k, p in frozen.items()}
    train0 = {k: fingerprint(p) for k, p in trainable.items()}
    torch.cuda.reset_peak_memory_stats()
    launches.clear()  # count the train path's launches only
    losses, times = [], []
    for i in range(4):
        before = dict(launches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch, 0)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        m = {k: float(v) for k, v in m.items()}
        if not all(np.isfinite(v) for v in m.values()):
            raise AssertionError(f"train moe step {i}: non-finite {m}")
        for name, per in PER_TRAIN_MOE_STEP.items():
            got = launches[name] - before.get(name, 0)
            if got != per:
                raise AssertionError(f"train moe step {i}: {name} launched "
                                     f"{got} times, expected {per}")
        losses.append(m["loss"])
    counts = dict(launches)
    peak = torch.cuda.max_memory_allocated() / 2**30
    if any(fingerprint(p) != frozen0[k] for k, p in frozen.items()):
        raise AssertionError("train moe: a frozen weight changed")
    unchanged = [k for k in experts if fingerprint(trainable[k]) == train0[k]]
    if unchanged:
        raise AssertionError(f"train moe: MoE weights unchanged {unchanged}")
    steady = times[1:]
    log(f"train moe: aux term (sum over {len(model.moe_layers)} MoE layers) "
        f"{aux:.6f}, loss {plain:.6f} without it, {total:.6f} with weight "
        f"0.01; losses {[round(x, 5) for x in losses]}; step time "
        f"{[round(t * 1e3, 1) for t in times]} ms (host clock, synchronized),"
        f" steady mean {np.mean(steady) * 1e3:.1f} ms = "
        f"{2 / np.mean(steady):.3f} samples/s; peak memory {peak:.2f} GiB; "
        f"launches over 4 steps {counts} | {CARD}")
    profile_call("train step moe", lambda: step(state, batch, 0))
    return counts


# The train CLI's validation is an evaluate with 32 new tokens
# (infer/evaluate.py validate_on_benchmark): 31 decode forwards of the 32
# LLaMA layers after the prefill; the SAM and prefill counts as evaluate's.
VALIDATE_NEW_TOKENS = 32
PER_VALIDATE = dict(PER_EVALUATE,
                    decode_attn=(VALIDATE_NEW_TOKENS - 1) * 32)
TRAIN_CLI_WORK = "chip_smoke_train_cli"


def write_train_data(work, n_frames, hw, seed):
    """Training data for the train CLI phases, and a 2-frame benchmark
    folder beside it. The GPU machine has no h5py, so the
    phases train on a ReasonSeg folder (`--dataset reason_seg`: <name>.jpg
    + <name>.json polygons, data/extra_datasets.py), not on 2HANDS h5
    shards (AffDataset is held against JAX on the CPU only). `n_frames`
    frames of size `hw`, all the same image and target, so the batches of
    a run differ only in their prompt templates. Benchmark frame 0 has
    both hands' GT, frame 1 the right hand missing and its GT on a canvas
    half the frame's size. Returns (data dir, benchmark dir)."""
    import os

    import cv2

    rng = np.random.RandomState(seed)
    H, W = hw
    data = os.path.join(work, "reason")
    os.makedirs(os.path.join(data, "train"))
    image = rng.randint(0, 256, (H, W, 3)).astype(np.uint8)
    target = [[W // 8, H // 4], [W // 3, H // 4], [W // 3, H // 2],
              [W // 8, H // 2]]
    for k in range(n_frames):
        cv2.imwrite(os.path.join(data, "train", f"{k:04d}.jpg"), image)
        with open(os.path.join(data, "train", f"{k:04d}.json"), "w") as f:
            json.dump({"text": "Drawer Handle", "is_sentence": False,
                       "shapes": [{"label": "target", "points": target}]}, f)
    bench = os.path.join(work, "bench")
    for k in range(2):
        fdir = os.path.join(bench, "P01_101", f"{k:07d}")
        os.makedirs(fdir)
        cv2.imwrite(os.path.join(fdir, "inpainting.png"),
                    rng.randint(0, 256, (H, W, 3)).astype(np.uint8))
        gh, gw = (H, W) if k == 0 else (H // 2, W // 2)
        gt = np.zeros((gh, gw), np.uint8)
        gt[gh // 4:gh // 2, gw // 8:gw // 3] = 255
        cv2.imwrite(os.path.join(fdir, "aff_left.png"), gt)
        if k == 0:
            cv2.imwrite(os.path.join(fdir, "aff_right.png"),
                        np.roll(gt, gw // 3, 1))
        with open(os.path.join(fdir, "annotation.json"), "w") as f:
            json.dump({"narration": "open drawer",
                       "taxonomy": [0, 0, 1, 0]}, f)
    return data, bench


def data_flags(data, bench):
    """The train CLI's data flags for write_train_data's folders."""
    return ["--dataset", "reason_seg", "--reason_seg_data", data,
            "--dataset_dir", data, "--val_benchmark_dir", bench]


class RecordingEvaluate:
    """Wraps the evaluate callable the train CLI makes (via
    infer.evaluate.make_jitted_evaluate, replaced for the run): each call's
    inputs and its result's tokens, canvas logits and taxonomy, on the
    host. `inner` is the wrapped callable (a GraphedEvaluate on the card)."""

    def __init__(self, inner):
        self.inner, self.calls = inner, []

    def __call__(self, *inputs):
        res = self.inner(*inputs)
        self.calls.append((inputs, {
            k: getattr(res, k).cpu() for k in (
                "output_ids", "gen_lengths", "pred_masks_left",
                "pred_masks_right", "taxonomies")}))
        return res


def run_train_cli(argv, init_weights=None):
    """haff_tpu_torch.train.cli.main(argv) in-process with its evaluate
    recorded (RecordingEvaluate). `init_weights`: a dict; when it holds
    "sd", the run's model loads those weights right after it is built
    (the seeded init draws differently on the card and on the CPU), else
    the built model's weights are stored there. Returns the TrainRun."""
    from haff_tpu_torch.infer import evaluate as E
    from haff_tpu_torch.train import cli

    real_make, real_build = E.make_jitted_evaluate, cli.build_model

    def make(*a, **kw):
        return RecordingEvaluate(real_make(*a, **kw))

    def build(cfg, precision, device, seed, *a, **kw):
        model = real_build(cfg, precision, device, seed, *a, **kw)
        if init_weights is not None:
            if "sd" in init_weights:
                model.load_state_dict({k: v.to(device) for k, v in
                                       init_weights["sd"].items()})
            else:
                init_weights["sd"] = {k: v.detach().cpu().clone()
                                      for k, v in model.state_dict().items()}
        return model

    E.make_jitted_evaluate, cli.build_model = make, build
    try:
        return cli.main(argv)
    finally:
        E.make_jitted_evaluate, cli.build_model = real_make, real_build


def saved_trainable(run_dir):
    """(step, trainable tensors) of the newest checkpoint of a CLI run."""
    import os

    from haff_tpu_torch.train import checkpoints as C

    d = C.step_dir(os.path.join(run_dir, "ckpt_model"))
    if d is None:
        raise AssertionError(f"{run_dir}: no checkpoint written")
    snap = torch.load(os.path.join(d, C.STATE), map_location="cpu",
                      weights_only=True)
    return snap["step"], snap["trainable"]


def check_graphed_after_training(run, what):
    """The card run's decode graph, captured at the first validation, was
    replayed at a later one after training steps: one more replay on the
    last validation's inputs against an eager evaluate on the updated
    weights (identical tokens, masks and taxonomy within 1e-5)."""
    from haff_tpu_torch.infer.evaluate import evaluate_fn

    graphed = run.evaluate.inner
    inputs = run.evaluate.calls[-1][0]
    got = run.evaluate(*inputs)
    want = evaluate_fn(run.model, *inputs,
                       max_new_tokens=VALIDATE_NEW_TOKENS,
                       eos_id=run.tok.eos_token_id)
    if not torch.equal(got.output_ids, want.output_ids):
        raise AssertionError(f"{what}: graphed tokens {got.output_ids.tolist()}"
                             f" vs eager {want.output_ids.tolist()}")
    same = True
    for key in ("pred_masks_left", "pred_masks_right", "taxonomies"):
        g, w = getattr(got, key).float(), getattr(want, key).float()
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
        same &= torch.equal(g, w)
    return graphed.captures, graphed.replays, same


def check_tiny_train_cli():
    """haff_tpu_torch.train.cli.main at tiny in float32 on a 4-frame
    ReasonSeg folder and a 2-frame benchmark folder (runs/;
    write_train_data), --device cuda against
    --device cpu from the same initial weights, LoRA dropout 0, in three
    weight modes (float, --load_in_8bit, --load_in_4bit), 2 epochs of one
    step with a validation after each: per-step losses within 1e-3,
    validation IoU and IoCM equal (or differing only through pixels whose
    CPU logit lies within 1e-3 of 0; 2e-2 at 8 bits, whose activation
    rounding moves a step on a 1e-6 difference), taxonomies within the
    same, the tokens up to the first [SEG] equal, the
    checkpointed trainable tensors within 1e-3; on the card the decode
    graph captured at the first validation and replayed at the second,
    after a training step, equal to an eager evaluate on the updated
    weights. Returns the card runs' launch counts."""
    import os
    import shutil

    from haff_tpu_torch.kernels import _build

    root = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(root, "runs", TRAIN_CLI_WORK, "tiny")
    shutil.rmtree(work, ignore_errors=True)
    data, bench = write_train_data(work, 4, (96, 128), seed=41)
    init = {}
    counts = collections.Counter()
    # AdamW moves each element by about lr whatever its gradient's size, so
    # an element whose gradient lies near 0 (its sign apart on the two
    # devices) ends up to 2 lr apart a step: lr 1e-4 over the 2 steps keeps
    # that inside the checkpoints' 1e-3.
    for mode in ("float", "8bit", "4bit"):
        runs = {}
        for dev in ("cuda", "cpu"):
            argv = data_flags(data, bench) + [
                    "--model_preset", "tiny", "--precision", "fp32",
                    "--epochs", "2", "--steps_per_epoch", "1",
                    "--batch_size", "2", "--grad_accum", "1",
                    "--warmup_steps", "0", "--lr", "1e-4",
                    "--lora_dropout", "0", "--model_max_length", "448",
                    "--val_batch_size", "2", "--workers", "2",
                    "--print_freq", "1", "--device", dev,
                    "--log_base_dir", os.path.join(work, "runs"),
                    "--exp_name", f"{mode}_{dev}"]
            if mode != "float":
                argv.append(f"--load_in_{mode}")
            before = collections.Counter(_build.LAUNCHES)
            runs[dev] = run_train_cli(argv, init)
            ran = collections.Counter(_build.LAUNCHES)
            ran.subtract(before)
            if dev == "cuda":
                counts.update(+ran)
                product = {"8bit": "w8a8_matmul",
                           "4bit": "w4a16_matmul"}.get(mode)
                if product and not ran[product]:
                    raise AssertionError(f"tiny train cli {mode}: {product} "
                                         f"never launched: {dict(+ran)}")
            elif +ran:
                raise AssertionError(f"tiny train cli {mode} on the CPU "
                                     f"launched kernels: {dict(+ran)}")
        gpu, cpu = runs["cuda"], runs["cpu"]
        la = [s["loss"] for s in gpu.steps]
        lb = [s["loss"] for s in cpu.steps]
        if len(la) != 2 or any(abs(a - b) > 1e-3 * max(1.0, abs(b))
                               for a, b in zip(la, lb)):
            raise AssertionError(f"tiny train cli {mode}: losses {la} vs {lb}")
        near = tail = 0
        worst = 0.0
        # The W8A8 product rounds its activations: a 1e-6 difference before
        # the round moves one int8 step (the 8-bit evaluate's tolerance,
        # 2e-2, tests/test_torch_quant_evaluate.py); elsewhere 1e-3.
        tol = 2e-2 if mode == "8bit" else 1e-3
        seg = gpu.model.cfg.seg_token_idx
        for (_, g), (_, c) in zip(gpu.evaluate.calls, cpu.evaluate.calls):
            # The masks read the hidden state of the first [SEG] alone (a
            # row without one prompts the decoders with zeros): the tokens
            # up to it must agree, and whether there is one. Elsewhere a
            # W8A8 activation rounding one step apart may pick another
            # token, which changes no output of the validation.
            for row in range(len(c["output_ids"])):
                a, b = g["output_ids"][row], c["output_ids"][row]
                ha = (a[:int(g["gen_lengths"][row])] == seg).nonzero()
                hb = (b[:int(c["gen_lengths"][row])] == seg).nonzero()
                upto = int(hb[0]) + 1 if len(hb) else 0
                if (len(ha) > 0) != (len(hb) > 0) or not torch.equal(
                        a[:upto], b[:upto]):
                    raise AssertionError(
                        f"tiny train cli {mode}: validation tokens differ "
                        f"up to the first [SEG]: {a.tolist()} vs "
                        f"{b.tolist()}")
                tail += int(not torch.equal(a, b))
            torch.testing.assert_close(g["taxonomies"], c["taxonomies"],
                                       rtol=tol, atol=tol)
            worst = max(worst, float((g["taxonomies"]
                                      - c["taxonomies"]).abs().max()))
            for key in ("pred_masks_left", "pred_masks_right"):
                differ = (g[key] > 0) != (c[key] > 0)
                if (differ & (c[key].abs() >= tol)).any():
                    raise AssertionError(f"tiny train cli {mode}: {key} "
                                         "binarizes differently")
                near += int(differ.sum())
                worst = max(worst, float((g[key] - c[key]).abs().max()))
        va = [v[1:3] for v in gpu.validations]
        vb = [v[1:3] for v in cpu.validations]
        if len(va) != 2 or (va != vb and not near):
            raise AssertionError(f"tiny train cli {mode}: validation {va} vs "
                                 f"{vb}")
        (sa, ta), (sb, tb) = (saved_trainable(os.path.join(work, "runs",
                                                           f"{mode}_{d}"))
                              for d in ("cuda", "cpu"))
        if sa != sb or set(ta) != set(tb):
            raise AssertionError(f"tiny train cli {mode}: checkpoints differ")
        for k, v in tb.items():
            torch.testing.assert_close(ta[k], v, rtol=1e-3, atol=1e-3)
        caps, reps, same = check_graphed_after_training(
            gpu, f"tiny train cli {mode}")
        if (caps, reps) != (1, 2):
            raise AssertionError(f"tiny train cli {mode}: {caps} captures, "
                                 f"{reps} replays")
        log(f"tiny train cli {mode}: --device cuda vs cpu: losses {la} vs "
            f"{lb}; validation (IoU, IoCM) {va} vs {vb} (masks and "
            f"taxonomy max abs err {worst:.3g}; {near} pixels within {tol} "
            f"of 0 binarize apart; {tail} rows with tokens apart "
            f"after the first [SEG] or without one); checkpoint step {sa}, "
            f"{len(ta)} trainable tensors within 1e-3; graph captured at "
            f"epoch 0 and replayed after a train step equal to eager "
            f"(bit-identical {same})")
        del gpu, cpu, runs
        gc.collect()
    shutil.rmtree(work, ignore_errors=True)
    return dict(counts)


def qlora_launches(model, remat):
    """w8a8 launches of one 8-bit QLoRA train step: each quantized layer
    once in the forward and once more in the remat recompute (the
    straight-through backward is a plain product, no launch)."""
    from haff_tpu_torch.nn.layers import QDense

    n = sum(isinstance(m, QDense) and m.quantized for m in model.modules())
    return n * (2 if remat else 1)


def run_train_cli_7b(launches):
    """The train CLI at the full 7b preset (LoRA r8 on q/v, bf16, remat,
    batch 2) on a 4-frame 720 x 1280 ReasonSeg folder and a 2-frame
    benchmark folder, --val_batch_size 2, three runs in-process, each model freed
    before the next: (1) --epochs 1 --steps_per_epoch 2; (2) --epochs 2
    under the same --exp_name, which auto-resumes at step 2 and trains
    epoch 1; (3) --load_in_8bit --epochs 1 --steps_per_epoch 2. Each: finite
    losses, one validation (IoU, IoCM in [0, 1]), a checkpoint written,
    exact launches (PER_TRAIN_STEP a step, PER_VALIDATE a validation, and
    for (3) the w8a8 count derived from the model), none on a scalar path;
    the loss of run 2's last step under run 1's first; the graphed
    validation equal to an eager evaluate. Returns the launch counts of
    runs 1 + 2 and of run 3."""
    import os
    import shutil

    root = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(root, "runs", TRAIN_CLI_WORK, "7b")
    shutil.rmtree(work, ignore_errors=True)
    data, bench = write_train_data(work, 4, (720, 1280), seed=43)
    base = data_flags(data, bench) + [
            "--model_preset", "7b", "--precision", "bf16",
            "--batch_size", "2", "--grad_accum", "1", "--warmup_steps", "0",
            "--lr", "3e-4", "--val_batch_size", "2", "--workers", "2",
            "--print_freq", "1", "--log_base_dir", os.path.join(work, "runs")]
    plan = (("train", ["--exp_name", "lora", "--epochs", "1",
                       "--steps_per_epoch", "2"]),
            ("train", ["--exp_name", "lora", "--epochs", "2",
                       "--steps_per_epoch", "2"]),
            ("train_8bit", ["--exp_name", "qlora8", "--epochs", "1",
                            "--steps_per_epoch", "2", "--load_in_8bit"]))
    paths = {"train_cli": collections.Counter(),
             "train_cli_8bit": collections.Counter()}
    losses, peaks = [], {"train": []}
    for i, (kind, extra) in enumerate(plan):
        launches.clear()  # count this run's launches only
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run = run_train_cli(base + extra)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = dict(launches)
        steps = len(run.steps)
        if steps != 2 or not all(np.isfinite(s["loss"]) for s in run.steps):
            raise AssertionError(f"train cli 7b run {i + 1}: steps {run.steps}")
        if i == 1 and (run.start_step != 2
                       or [s["step"] for s in run.steps] != [3, 4]):
            raise AssertionError(f"train cli 7b run 2 did not resume at step 2:"
                                 f" start {run.start_step}, steps "
                                 f"{[s['step'] for s in run.steps]}")
        (epoch, iou, iocm, frames, val_s), = run.validations
        if not (0 <= iou <= 1 and 0 <= iocm <= 1 and len(frames) == 2):
            raise AssertionError(f"train cli 7b run {i + 1}: validation "
                                 f"{run.validations}")
        step, trained = saved_trainable(os.path.join(work, "runs",
                                                     extra[1]))
        if step != run.steps[-1]["step"]:
            raise AssertionError(f"train cli 7b run {i + 1}: checkpoint at "
                                 f"step {step}")
        want = collections.Counter()
        for name, per in PER_TRAIN_STEP.items():
            want[name] += per * steps
        for name, per in PER_VALIDATE.items():
            want[name] += per
        if kind == "train_8bit":
            from haff_tpu_torch.nn.layers import QDense

            quantized = [n for n, m in run.model.named_modules()
                         if isinstance(m, QDense) and m.quantized]
            if not quantized or any("lm_head" in n for n in quantized):
                raise AssertionError(f"train cli 7b 8-bit: quantized "
                                     f"{len(quantized)} layers, lm_head "
                                     "among them or none")
            want["w8a8_matmul"] = (
                qlora_launches(run.model, remat=True) * steps
                + product_launches(run.model, "w8a8", VALIDATE_NEW_TOKENS))
        if {k: v for k, v in got.items() if v} != dict(want):
            raise AssertionError(f"train cli 7b run {i + 1}: launches {got}, "
                                 f"expected {dict(want)}")
        scalar = {k: n for k, n in got.items() if k.endswith("/scalar") and n}
        if scalar:
            raise AssertionError(f"train cli 7b run {i + 1}: scalar launches "
                                 f"{scalar}")
        paths["train_cli" if kind == "train" else "train_cli_8bit"].update(got)
        losses += [s["loss"] for s in run.steps] if kind == "train" else []
        if kind == "train":
            peaks["train"].append(run.peak_bytes)
        else:
            peaks["train_8bit"] = run.peak_bytes
        extra_check = ""
        if i == 1:
            caps, reps, same = check_graphed_after_training(run,
                                                            "train cli 7b")
            extra_check = (f"; graphed validation replay = eager (bit-"
                           f"identical {same})")
        ck = run.checkpoints[-1]
        log(f"train cli 7b run {i + 1} ({' '.join(extra)}): step time "
            f"{[round(s['secs'] * 1e3, 1) for s in run.steps]} ms, losses "
            f"{[round(s['loss'], 5) for s in run.steps]}; validation "
            f"{val_s * 1e3:.1f} ms (IoU {iou:.4f}, IoCM {iocm:.4f}, capture "
            f"call); checkpoint step {step}: host copy "
            f"{ck['copy_s'] * 1e3:.1f} ms, written after "
            f"{ck['written_s'] * 1e3:.1f} ms, "
            f"{sum(t.numel() * 4 for t in trained.values()) / 2**30:.2f} GiB "
            f"trainable f32; peak memory {run.peak_bytes / 2**30:.2f} GiB; "
            f"wall {wall:.1f} s (build and data included); launches {got}"
            f"{extra_check} | {CARD}")
        del run, trained
        gc.collect()
        torch.cuda.empty_cache()
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train cli 7b: loss did not fall {losses}")
    # The QLoRA run holds the LLM projections in int8 and no float copy of
    # them (6.4 GiB less than bf16): its peak stays under the bf16 run's.
    if not peaks["train_8bit"] < min(peaks["train"]):
        raise AssertionError(f"train cli 7b: QLoRA peak memory {peaks} not "
                             "under the bf16 runs'")
    shutil.rmtree(work, ignore_errors=True)
    return dict(paths["train_cli"]), dict(paths["train_cli_8bit"])


def run_train_cli_moe_small(launches):
    """train_cli_moe_small: the train CLI at the small preset with MoE MLPs
    (`--moe_experts 4 --moe_top_k 2 --moe_every 2`: layers 1 and 3), bf16,
    remat, --epochs 2 --steps_per_epoch 2, on a 4-frame ReasonSeg folder
    and a 2-frame benchmark folder: (1) stopped after 2 steps by the CLI's
    preemption hook (HAFF_TEST_PREEMPT_STEP), which writes a checkpoint;
    (2) the same --exp_name again, which auto-resumes at step 2, trains
    epoch 1, validates and checkpoints; (3) uninterrupted under another
    name, validating after each epoch. Run 1's checkpoint holds its trained
    tensors, the experts and routers among them; run 2's losses and final
    trainable tensors equal run 3's bit for bit
    (deterministic algorithms for the phase). Launches of the flash
    forward, dq, dk/dv and decode kernels exact: per step 2, 1 and 1 a
    layer (remat), per validation 1 flash a layer and (32 - 1) decode
    steps a layer. Returns the launch counts of the three runs."""
    import os
    import shutil

    from haff_tpu_torch.core.config import ModelConfig

    layers = ModelConfig.preset("small").llama.num_layers
    root = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(root, "runs", TRAIN_CLI_WORK, "moe_small")
    shutil.rmtree(work, ignore_errors=True)
    data, bench = write_train_data(work, 4, (180, 320), seed=47)
    base = data_flags(data, bench) + [
            "--model_preset", "small", "--moe_experts", "4", "--moe_top_k",
            "2", "--moe_every", "2", "--batch_size", "2", "--grad_accum", "1",
            "--warmup_steps", "0", "--lr", "1e-3", "--val_batch_size", "2",
            "--workers", "2", "--print_freq", "1",
            "--log_base_dir", os.path.join(work, "runs")]
    base += ["--epochs", "2", "--steps_per_epoch", "2"]
    plan = (("moe", "1"), ("moe", None), ("moe_once", None))
    total = collections.Counter()
    runs = []
    deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for i, (name, preempt) in enumerate(plan):
            launches.clear()  # count this run's launches only
            if preempt:
                os.environ["HAFF_TEST_PREEMPT_STEP"] = preempt
            t0 = time.perf_counter()
            try:
                run = run_train_cli(base + ["--exp_name", name])
            finally:
                os.environ.pop("HAFF_TEST_PREEMPT_STEP", None)
            wall = time.perf_counter() - t0
            got = dict(launches)
            total.update(got)
            steps, vals = len(run.steps), len(run.validations)
            if not all(np.isfinite(s["loss"]) for s in run.steps):
                raise AssertionError(f"train cli moe small run {i + 1}: "
                                     f"{run.steps}")
            want = {"flash_prefill_fwd": 2 * layers * steps + layers * vals,
                    "flash_bwd_dq": layers * steps,
                    "flash_bwd_dkv": layers * steps,
                    "decode_attn": (VALIDATE_NEW_TOKENS - 1) * layers * vals}
            if {k: got.get(k, 0) for k in want} != want:
                raise AssertionError(f"train cli moe small run {i + 1}: "
                                     f"launches {got}, expected {want}")
            trained = {k: p.detach().cpu().clone()
                       for k, p in run.model.named_parameters()
                       if p.requires_grad}
            moe = sorted(k for k in trained if ".moe." in k)
            if len(moe) != 8:
                raise AssertionError(f"train cli moe small run {i + 1}: "
                                     f"trainable MoE tensors {moe}")
            if [s["step"] for s in run.steps] != [[1, 2], [3, 4],
                                                  [1, 2, 3, 4]][i]:
                raise AssertionError(f"train cli moe small run {i + 1}: "
                                     f"steps {run.steps}")
            step, saved = saved_trainable(os.path.join(work, "runs", name))
            if i == 0 and (step != 2 or set(saved) != set(trained) or any(
                    not torch.equal(saved[k], t) for k, t in trained.items())):
                raise AssertionError(f"train cli moe small run 1: checkpoint "
                                     f"step {step} not the trained tensors")
            runs.append(([s["loss"] for s in run.steps], trained,
                         [v[1:3] for v in run.validations]))
            what = f"{name}, preempted after step 2" if preempt else name
            log(f"train cli moe small run {i + 1} ({what}):"
                f" steps {[s['step'] for s in run.steps]}, losses "
                f"{[round(s['loss'], 5) for s in run.steps]}, validations "
                f"{[(round(v[1], 4), round(v[2], 4)) for v in run.validations]}"
                f", newest checkpoint step {step}; {len(moe)} MoE tensors "
                f"trained; wall {wall:.1f} s; launches {got} | {CARD}")
            del run
            gc.collect()
    finally:
        torch.use_deterministic_algorithms(deterministic)
    _, (resumed, last, val), (once, full, vals) = runs
    if resumed != once[2:] or set(last) != set(full) or any(
            not torch.equal(last[k], full[k]) for k in full):
        raise AssertionError(f"train cli moe small: the resumed run differs "
                             f"from the uninterrupted one: losses {resumed} "
                             f"vs {once[2:]}")
    log(f"train cli moe small: resumed run = uninterrupted run bit for bit "
        f"(losses {resumed}, {len(full)} trainable tensors); epoch 1 "
        f"validation (IoU, IoCM) {val} resumed, {vals[1:]} uninterrupted")
    shutil.rmtree(work, ignore_errors=True)
    return dict(total)


# ---------------------------------------------------------------------------
# The 2HANDS pipeline and the deployment tools (pipeline_vit_h,
# export_vit_h, tools_small)
# ---------------------------------------------------------------------------

PIPELINE_HW = (480, 854)      # VISOR's frame size
PIPELINE_FRAMES = 32
# Frames of the clip the CPU re-runs propagation on (host time).
PIPELINE_CPU_FRAMES = 8
# Share of a frame's pixels on which card and CPU masks may differ
# (window sums in another order can flip a near-tie shift).
PIPELINE_PIXEL_TOL = 1e-3
PER_SAM_IMAGE = {"sam_window_relpos_attn": 28, "sam_global_relpos_attn": 4}


def pipeline_clip(seed=0):
    """A seeded synthetic clip at VISOR's frame size, built as haff_tpu's
    pipeline quality clips are (textured patches moving over a textured
    background): an object translating (1, 2) px/frame, a left hand
    (2, 1) and a right hand (-1, -2) moving over its edges, drawn on top.
    Returns (frames (N, H, W, 3) uint8, seed masks on frame 0: left,
    right, object (its visible part))."""
    rng = np.random.RandomState(seed)
    H, W = PIPELINE_HW
    bg = rng.randint(0, 120, (H, W, 3)).astype(np.uint8)
    size = {"obj": (H * 5 // 16, W // 4), "left": (H * 3 // 16, W // 8),
            "right": (H * 3 // 16, W // 8)}
    tex = {"obj": (140, 256), "left": (60, 200), "right": (30, 170)}
    tex = {k: rng.randint(*tex[k], size[k] + (3,)).astype(np.uint8)
           for k in size}
    start = {"obj": (H // 3, W * 3 // 8), "left": (H * 5 // 12, W * 9 // 32),
             "right": (H * 23 // 48, W * 9 // 16)}
    step = {"obj": (1, 2), "left": (2, 1), "right": (-1, -2)}
    frames = np.zeros((PIPELINE_FRAMES, H, W, 3), np.uint8)
    seeds = {}
    for t in range(PIPELINE_FRAMES):
        f = bg.copy()
        for name in ("obj", "left", "right"):
            y = start[name][0] + step[name][0] * t
            x = start[name][1] + step[name][1] * t
            h, w = tex[name].shape[:2]
            f[y:y + h, x:x + w] = tex[name]
            if t == 0:
                m = np.zeros((H, W), np.uint8)
                m[y:y + h, x:x + w] = 1
                seeds[name] = m
        frames[t] = f
    seeds["obj"] = seeds["obj"] & ~(seeds["left"] | seeds["right"])
    return frames, seeds["left"], seeds["right"], seeds["obj"]


def run_pipeline_vit_h(launches, sam, cfg):
    """pipeline_vit_h: video_records (run_pipeline_from_video up to its
    packing: this host has no h5py) on pipeline_clip() with the default
    propagation and inpainting on the card and stage 5 through a
    SamPredictor over `sam` (ViT-H, bf16): each frame's partial object
    mask's centroid, in frame pixels, as one point prompt; the left
    decoder's single-mask logits. The filtered records' JSON contours
    written with the shard's writer. Held: the propagated masks of the
    first PIPELINE_CPU_FRAMES frames and the inpainted clip against the
    same functions on the CPU (PIPELINE_PIXEL_TOL of a frame's pixels;
    the inpainted frames within 1 of 255); SAM launches exactly 28 + 4 per
    completed frame. Then video_records over the clip's first
    PIPELINE_CPU_FRAMES frames once more under torch.profiler
    (`profile_call`: device time by kernel, idle share; no JSON). Returns
    the launch counts of the first run."""
    import os
    import shutil

    from haff_tpu_torch.infer.sam_predictor import SamPredictor
    from haff_tpu_torch.pipeline import defaults as D
    from haff_tpu_torch.pipeline import orchestrate as R

    frames, seed_l, seed_r, seed_obj = pipeline_clip()
    n = len(frames)
    pred = SamPredictor(sam, image_size=cfg.sam_encoder.image_size)
    times, kept = collections.defaultdict(float), {}

    def timed(name, fn):
        def call(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            times[name] += time.perf_counter() - t0
            kept[name] = out
            return out
        return call

    completed = []

    def sam_apply(images, pts, labels):
        out = []
        for img, p, lab in zip(images, pts, labels):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pred.set_image(img)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            masks, _, _ = pred.predict(point_coords=p, point_labels=lab,
                                       multimask_output=False,
                                       return_logits=True, hand="left")
            out.append(masks)
            completed.append((t1 - t0, time.perf_counter() - t1))
        return np.stack(out)

    def complete(f, o):
        return R.sam_mask_completion(sam_apply, f, o)

    stages = R.PipelineStages(propagate_masks=timed("propagate",
                                                    D.default_propagate),
                              complete_masks=timed("complete", complete))
    real_inpaint = D.default_inpaint
    D.default_inpaint = timed("inpaint", real_inpaint)
    clip = (seed_l, seed_r, seed_obj, "stir the pot", [0.0, 0.0, 1.0])
    try:
        launches.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        records = R.video_records(frames, *clip, stages=stages)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(launches)
    finally:
        D.default_inpaint = real_inpaint
    want = {k: v * len(completed) for k, v in PER_SAM_IMAGE.items()}
    if len(completed) != n or sam_launches(counts) != want:
        raise AssertionError(f"pipeline: {len(completed)} frames completed, "
                             f"SAM launches {sam_launches(counts)}, expected "
                             f"{want}")
    root = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(root, "runs", "chip_smoke_pipeline")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    json_path = os.path.join(work, f"0-{len(records) - 1}_P00.json")
    t0 = time.perf_counter()
    R.write_contours_json(records, json_path)
    json_s = time.perf_counter() - t0
    json_bytes = os.path.getsize(json_path)
    with open(json_path) as f:
        entries = json.load(f)
    if not records or len(entries) != len(records):
        raise AssertionError(f"pipeline: {len(records)} records, "
                             f"{len(entries)} JSON entries")
    for e in entries.values():
        if e["original_size"] != list(PIPELINE_HW) or not (
                e["aff_left"] or e["aff_right"]):
            raise AssertionError(f"pipeline: bad record {e.keys()}")

    left, right, obj = kept["propagate"]
    m = PIPELINE_CPU_FRAMES
    cpu = D.default_propagate(frames[:m], seed_l, seed_r, seed_obj,
                              device="cpu")
    worst = 0.0
    for card_m, cpu_m in zip((left, right, obj), cpu):
        off = (card_m[:m] != cpu_m).reshape(m, -1).mean(-1)
        worst = max(worst, float(off.max()))
    if worst > PIPELINE_PIXEL_TOL:
        raise AssertionError(f"pipeline: propagated masks differ on "
                             f"{worst:.5f} of a frame's pixels")
    hands = ((left != 0) | (right != 0)).astype(np.uint8)
    cpu_inp = D.default_inpaint(frames, hands, device="cpu")
    diff = np.abs(kept["inpaint"].astype(int) - cpu_inp.astype(int))
    off_inp = (diff > 0).reshape(n, -1).mean(-1)
    if diff.max() > 1 or off_inp.max() > PIPELINE_PIXEL_TOL:
        raise AssertionError(f"pipeline: inpainted frames differ by up to "
                             f"{diff.max()} on {off_inp.max():.5f} of a frame")
    rest = wall - sum(times.values())
    set_ms = [1e3 * a for a, _ in completed]
    pred_ms = [1e3 * b for _, b in completed]
    log(f"pipeline_vit_h: {n} frames at {PIPELINE_HW[0]} x {PIPELINE_HW[1]}, "
        f"SAM ViT-H bf16 completion: records in {wall:.3f} s ({n / wall:.2f} "
        f"frames/s); propagate {times['propagate']:.3f} s, inpaint "
        f"{times['inpaint']:.3f} s, SAM completion {times['complete']:.3f} s "
        f"({n / times['complete']:.2f} frames/s; set_image median "
        f"{np.median(set_ms):.1f} ms (first {set_ms[0]:.1f}), point decode + "
        f"logits to the host median {np.median(pred_ms):.1f} ms), dilate + "
        f"affordance + filter {rest:.3f} s (host clock, synchronized); "
        f"{len(records)} records, contour JSON {json_s:.3f} s ({json_bytes} "
        f"bytes); card vs CPU: propagated masks (first {m} frames) differ on "
        f"at most {worst:.6f} of a frame's pixels, inpainted frames by at "
        f"most {diff.max()} on {off_inp.max():.6f} of a frame; launches "
        f"{counts} | {CARD}")

    k = PIPELINE_CPU_FRAMES
    profile_call(f"pipeline_vit_h video_records (the clip's first {k} "
                 f"frames)", lambda: R.video_records(
                     frames[:k], *clip,
                     stages=R.PipelineStages(complete_masks=complete)))
    shutil.rmtree(work, ignore_errors=True)
    return counts


EXPORT_CHILD = r"""
import json, sys, time
import torch
from haff_tpu_torch.kernels import _build
from haff_tpu_torch.tools.export_model import load_exported
work = sys.argv[1]
inputs = torch.load(work + "/inputs.pt")
res, outs = {}, {}
for comp, args in (("encoder", inputs[:1]), ("mask_path", inputs)):
    t0 = time.perf_counter()
    m = load_exported(work + "/" + comp + ".pt2")
    load_s = time.perf_counter() - t0
    _build.LAUNCHES.clear()
    with torch.no_grad():
        y = m(*[a.cuda() for a in args])
    y = y if isinstance(y, (tuple, list)) else (y,)
    outs[comp] = [t.cpu() for t in y]
    res[comp] = {"load_s": load_s, "launches": dict(_build.LAUNCHES)}
torch.save(outs, work + "/outputs.pt")
res["nn_imported"] = sorted(k for k in sys.modules
                            if k.startswith("haff_tpu_torch.nn"))
print(json.dumps(res))
"""


def run_export_vit_h(sam, cfg):
    """export_vit_h: the encoder and mask_path components of `sam` (7b,
    bf16) exported with torch.export and saved as .pt2 (plus manifests),
    then loaded and run in a fresh process on a seeded image and text;
    held: the outputs equal the eager Sam's bit for bit, the loading
    process never imported haff_tpu_torch.nn, and each program launched
    28 + 4 SAM kernels an image. Returns the fresh process's launch counts
    (both programs)."""
    import os
    import shutil

    from haff_tpu_torch.data.transforms import sam_preprocess
    from haff_tpu_torch.tools import export_model as X

    root = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(root, "runs", "chip_smoke_export")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    frame = np.random.RandomState(5).randint(0, 256, (720, 1280, 3)).astype(
        np.uint8)
    image = torch.as_tensor(sam_preprocess(frame, cfg.sam_encoder.image_size)[0])[None]
    text = torch.randn((1, 1, cfg.sam_decoder.prompt_embed_dim),
                       generator=torch.Generator().manual_seed(6))
    torch.save((image, text), os.path.join(work, "inputs.pt"))
    timing = {}
    for comp in ("encoder", "mask_path"):
        t0 = time.perf_counter()
        program = X.export_sam_component(sam, cfg, comp)
        t1 = time.perf_counter()
        size = X.save_exported(program, os.path.join(work, comp + ".pt2"), {
            "component": comp, "model_preset": "7b", "batch": 1,
            "precision": "bf16", "device": "cuda"})
        timing[comp] = (t1 - t0, time.perf_counter() - t1, size)
        del program
    gc.collect()
    with torch.no_grad():
        eager = {"encoder": [sam.encode_image(image.to("cuda"))],
                 "mask_path": list(X._Component(
                     sam, "mask_path", cfg.sam_encoder.image_size)(
                         image.to("cuda"), text.to("cuda")))}
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", EXPORT_CHILD, work],
                          capture_output=True, text=True, cwd=root,
                          env=dict(os.environ, PYTHONPATH=root))
    child_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"export: the loading process failed:\n"
                             f"{proc.stderr[-4000:]}")
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    if res["nn_imported"]:
        raise AssertionError(f"export: the loading process imported "
                             f"{res['nn_imported']}")
    outs = torch.load(os.path.join(work, "outputs.pt"))
    worst, total = 0.0, collections.Counter()
    for comp in ("encoder", "mask_path"):
        got, want = outs[comp], eager[comp]
        if len(got) != len(want):
            raise AssertionError(f"export {comp}: {len(got)} outputs")
        for g, w in zip(got, want):
            w = w.cpu()
            if g.shape != w.shape or g.dtype != w.dtype:
                raise AssertionError(f"export {comp}: {g.shape} {g.dtype} "
                                     f"vs {w.shape} {w.dtype}")
            worst = max(worst, float((g.float() - w.float()).abs().max()))
            if not torch.equal(g, w):
                raise AssertionError(f"export {comp}: loaded output differs "
                                     f"from eager by {worst}")
        got_l = res[comp]["launches"]
        if sam_launches(got_l) != PER_SAM_IMAGE:
            raise AssertionError(f"export {comp}: launches {got_l}, expected "
                                 f"{PER_SAM_IMAGE}")
        total.update(got_l)
    log("export_vit_h: " + "; ".join(
        f"{c}: export {timing[c][0]:.2f} s, save {timing[c][1]:.2f} s, "
        f"{timing[c][2]} bytes ({timing[c][2] / 2**30:.3f} GiB), load "
        f"{res[c]['load_s']:.2f} s in a fresh process" for c in timing)
        + f"; loading process {child_s:.1f} s wall; loaded outputs = eager "
        f"(max abs diff {worst}); haff_tpu_torch.nn not imported there; "
        f"launches per image {PER_SAM_IMAGE} | {CARD}")
    shutil.rmtree(work, ignore_errors=True)
    return dict(total)


def run_tools_small(sam, cfg):
    """tools_small: a small-preset train-CLI checkpoint (float32, LoRA r 8,
    one step, --no_eval) through export_params (LoRA folded) and
    merge_lora; a Predictor serving the .npz against one serving the
    checkpoint directory (tokens equal, masks and taxonomy within 1e-3:
    the folded product rounds differently); merge_lora over the unfolded
    export equal to export_params' fold bit for bit. Then the native host
    library (available, against the Python path) and the FLOPs and MFU of
    the 7b SAM encoder (`sam`) against a bf16 matmul peak measured here.
    Returns the launch counts of the two Predictors' calls."""
    import os
    import shutil

    from haff_tpu_torch.data import native
    from haff_tpu_torch.data.transforms import sam_preprocess
    from haff_tpu_torch.infer.predictor import Predictor
    from haff_tpu_torch.kernels import _build
    from haff_tpu_torch.nn.sam import PIXEL_MEAN, PIXEL_STD
    from haff_tpu_torch.tools import merge_lora
    from haff_tpu_torch.tools.bridge import load_npz
    from haff_tpu_torch.tools.export_params import export_params
    from haff_tpu_torch.utils import flops as FL

    root = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(root, "runs", "chip_smoke_tools")
    shutil.rmtree(work, ignore_errors=True)
    data, bench = write_train_data(work, 2, (180, 320), seed=53)
    t0 = time.perf_counter()
    run = run_train_cli(data_flags(data, bench) + [
        "--model_preset", "small", "--precision", "fp32", "--batch_size", "2",
        "--grad_accum", "1", "--epochs", "1", "--steps_per_epoch", "1",
        "--lr", "1e-2", "--warmup_steps", "0", "--lora_dropout", "0",
        "--no_eval", "--workers", "1", "--exp_name", "tools", "--device", "cuda",
        "--log_base_dir", os.path.join(work, "runs")])
    train_s = time.perf_counter() - t0
    del run
    gc.collect()
    ckpt = os.path.join(work, "runs", "tools", "ckpt_model")
    t0 = time.perf_counter()
    npz = export_params(ckpt, os.path.join(work, "p.npz"), "small",
                        "float32")
    export_s = time.perf_counter() - t0
    raw = export_params(ckpt, os.path.join(work, "raw.npz"), dtype="float32",
                        merge_lora=False)
    t0 = time.perf_counter()
    merge_lora.main(["--checkpoint", raw, "--out",
                     os.path.join(work, "merged.npz"), "--dtype", "float32",
                     "--keep_vision_tower"])
    merge_s = time.perf_counter() - t0
    a, b = load_npz(npz), load_npz(os.path.join(work, "merged.npz"))
    from haff_tpu_torch.tools.bridge import flatten_tree

    a, b = flatten_tree(a), flatten_tree(b)
    if sorted(a) != sorted(b) or any(not np.array_equal(a[k], b[k]) for k in a):
        raise AssertionError("tools: merge_lora over the unfolded export "
                             "differs from export_params' fold")
    folded = sum(k.endswith("lora_a") for k in flatten_tree(load_npz(raw)))

    rng = np.random.RandomState(8)
    frames = [rng.randint(0, 256, (240, 320, 3)).astype(np.uint8)
              for _ in range(2)]
    prompts = ["open the drawer", "where would you grab the cup?"]
    kw = dict(model_preset="small", precision="fp32", max_new_tokens=8,
              max_text_len=448)
    _build.LAUNCHES.clear()
    pred_npz = Predictor(checkpoint=npz, **kw)
    pred_dir = Predictor(checkpoint=ckpt, **kw)
    got = pred_npz.predict_batch(frames, prompts)
    want = pred_dir.predict_batch(frames, prompts)
    counts = dict(_build.LAUNCHES)
    worst = 0.0
    for (t, ml, mr, tax), (rt, rml, rmr, rtax) in zip(got, want):
        if t != rt:
            raise AssertionError(f"tools: tokens {t!r} vs {rt!r}")
        for x, y in ((ml, rml), (mr, rmr), (tax, rtax)):
            worst = max(worst, float(np.abs(x - y).max()))
    if worst > 1e-3:
        raise AssertionError(f"tools: .npz serving differs from the "
                             f"checkpoint's by {worst}")
    # Each folded projection against the adapter's: the same outputs, and
    # a LoRA delta that is not zero.
    served = {k: m for k, m in pred_npz.model.named_modules()}
    fold_err, delta = 0.0, 0.0
    with torch.no_grad():
        for name, mod in pred_dir.model.named_modules():
            if getattr(mod, "rank", 0):
                x = torch.randn((4, mod.base.in_features), device="cuda",
                                generator=torch.Generator("cuda").manual_seed(1))
                y = mod(x)
                fold_err = max(fold_err, float((served[name](x) - y).abs().max()))
                delta = max(delta, float((mod.base(x) - y).abs().max()))
    if not delta or fold_err > 1e-4 * max(delta, 1.0) + 1e-5:
        raise AssertionError(f"tools: folded projections off by {fold_err} "
                             f"(LoRA delta {delta})")
    log(f"tools_small: train CLI small fp32 1 step {train_s:.1f} s; "
        f"export_params {export_s:.2f} s ({folded} LoRA pairs folded, "
        f"{os.path.getsize(npz)} bytes); merge_lora {merge_s:.2f} s, = the "
        f"fold bit for bit; Predictor on the .npz = on the checkpoint: "
        f"answers {[g[0] for g in got]}, masks and taxonomy max abs diff "
        f"{worst:.3g}; folded q/v projections vs base + adapter: max abs "
        f"diff {fold_err:.3g} (the adapters' delta up to {delta:.3g}) | "
        f"{CARD}")
    del pred_npz, pred_dir

    if not native.available():
        raise AssertionError("tools: the native host library did not load")
    frame = np.random.RandomState(9).randint(0, 256, PIPELINE_HW + (3,)).astype(
        np.uint8)   # upscaled to 1024 (the native resize has no antialias)
    t0 = time.perf_counter()
    nat, hw = native.sam_preprocess_native(frame, 1024, PIXEL_MEAN, PIXEL_STD)
    nat_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    ref, hw2 = sam_preprocess(frame, 1024)
    py_ms = (time.perf_counter() - t0) * 1e3
    if tuple(hw) != tuple(hw2) or np.abs(nat - ref).max() > 2.5 / 57.0:
        raise AssertionError("tools: native SAM preprocess off the Python path")

    S = cfg.sam_encoder.image_size
    x = torch.as_tensor(sam_preprocess(frame, S)[0], device="cuda")[None]
    with torch.no_grad():
        enc_flops = FL.count_flops(sam.encode_image, x)
        enc_ms = cuda_ms(lambda: sam.encode_image(x), 5)
    peak = FL.measure_peak_tflops()
    mfu = FL.mfu_fields(enc_flops, 1e3 / enc_ms, peak)
    log(f"tools_small: native library {native.library_path()} loaded; SAM "
        f"preprocess of a {PIPELINE_HW[0]} x {PIPELINE_HW[1]} frame native "
        f"{nat_ms:.1f} ms vs Python "
        f"{py_ms:.1f} ms (host), max abs diff {np.abs(nat - ref).max():.4f}; "
        f"SAM ViT-H encoder (bf16, batch 1): {enc_flops / 1e12:.4f} TFLOP "
        f"(FlopCounterMode), {enc_ms:.3f} ms (events), {mfu['tflops']:.1f} "
        f"TFLOP/s = {mfu['mfu_pct']:.1f}% of the bf16 matmul peak measured "
        f"here ({peak:.1f} TFLOP/s, 8192^3 torch.matmul chain) | {CARD}")
    shutil.rmtree(work, ignore_errors=True)
    return counts


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the "
              "card", file=sys.stderr)
        return 2
    from haff_tpu_torch.kernels import _build  # fails outside a checkout

    start = time.perf_counter()
    global CARD
    card = CARD = card_line()
    log(f"device: {card} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}")

    t0 = time.perf_counter()
    info = _build.build_all()
    log(f"build: {time.perf_counter() - t0:.1f} s wall for "
        f"{len(info)} kernels")
    for name, rec in info.items():
        log(f"build {name}: {rec['seconds']:.1f} s")
        for line in rec["ptxas"].splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log("  " + line.strip())

    gen = torch.Generator("cuda").manual_seed(0)
    kernels = []
    for check in (check_sam_entries, check_flash, check_flash_bwd,
                  check_decode, check_w8a8, check_w4a16, check_probe):
        recs = check(gen)
        for rec in recs if isinstance(recs, list) else [recs]:
            kernels.append(rec)
            for r in rec.get("shapes", [rec]):
                graph = (f" (path {r.get('path', '-')}; graph "
                         f"{r['graph_ms']:.4f} ms, library graph "
                         f"{r['library_graph_ms']:.4f} ms)"
                         if "graph_ms" in r else "")
                log(f"kernel {rec['name']}: {r['shape']}: max abs err "
                    f"{r['max_abs_err']:.3g}; kernel {r['ms']:.4f} ms, plain "
                    f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} "
                    f"ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']})"
                    f"{graph}")
        torch.cuda.empty_cache()
    log("SAM kernel ms at PR 4, for comparison (copied from PERF.md, "
        "events, not measured in this run): " + "; ".join(
            f"{name} {ms}" for name, ms in PR4_SAM_MS))

    check_sam_backward(gen)
    for mode in ("bf16", "w8a8", "w4a16"):
        check_tiny_against_cpu(mode)
    paths_spec_small = check_spec_small(_build.LAUNCHES)
    paths_mpt_tiny = check_mpt_tiny(_build.LAUNCHES)
    paths_moe_small = check_moe_small(_build.LAUNCHES)
    check_tiny_serving()
    check_small_cli()
    check_tiny_train()
    torch.cuda.empty_cache()
    _build.LAUNCHES.clear()
    paths_tiny = check_tiny_train_cli()
    torch.cuda.empty_cache()
    paths_cli_moe = run_train_cli_moe_small(_build.LAUNCHES)
    torch.cuda.empty_cache()

    # Each path is driven with the counts set to 0 just before it and read
    # just after; each model is freed before the next is built.
    paths = {"train_cli_tiny": paths_tiny, "spec_small": paths_spec_small,
             "mpt_tiny": paths_mpt_tiny, "moe_small": paths_moe_small,
             "train_cli_moe_small": paths_cli_moe,
             "encoder_backward": run_encoder_backward(_build.LAUNCHES)}
    gc.collect()
    torch.cuda.empty_cache()
    paths["small"] = check_small(_build.LAUNCHES)
    check_sam_reference()
    paths["predictor_tiny"] = check_tiny_predictor(_build.LAUNCHES)
    paths["predictor_vit_b"] = run_predictor_slice(_build.LAUNCHES)
    paths["audit"], paths["bench"] = run_tools(_build.LAUNCHES)
    gc.collect()
    torch.cuda.empty_cache()
    # The 2HANDS pipeline and the deployment tools over one SAM ViT-H.
    from haff_tpu_torch.tools.export_model import build_sam

    marks = [("", time.perf_counter())]
    cfg_h, sam_h = build_sam("7b", None, "bf16")
    marks.append(("build_sam", time.perf_counter()))
    paths["pipeline_vit_h"] = run_pipeline_vit_h(_build.LAUNCHES, sam_h, cfg_h)
    marks.append(("pipeline_vit_h", time.perf_counter()))
    paths["export_vit_h"] = run_export_vit_h(sam_h, cfg_h)
    marks.append(("export_vit_h", time.perf_counter()))
    paths["tools_small"] = run_tools_small(sam_h, cfg_h)
    marks.append(("tools_small", time.perf_counter()))
    log("ViT-H phases, wall s: " + ", ".join(
        f"{name} {t - marks[i][1]:.1f}" for i, (name, t) in enumerate(
            marks[1:])) + f"; total {marks[-1][1] - marks[0][1]:.1f}")
    del sam_h
    gc.collect()
    torch.cuda.empty_cache()
    # LLaMA-7B in three modes (speculative on the bf16 and w8a8 models),
    # then MPT-7B in two, then the 7b MoE model in bf16 (greedy and
    # speculative); each model is freed before the next is built.
    for decoder, mode, moe in (("llama", "bf16", False),
                               ("llama", "w8a8", False),
                               ("llama", "w4a16", False),
                               ("mpt", "bf16", False), ("mpt", "w8a8", False),
                               ("llama", "bf16", True)):
        paths.update(run_slice(_build.LAUNCHES, mode, decoder, moe))
        gc.collect()
        torch.cuda.empty_cache()
    paths["serve_bf16"], paths["stream"] = run_serve(_build.LAUNCHES)
    gc.collect()
    torch.cuda.empty_cache()
    paths["train"] = run_train_slice(_build.LAUNCHES)
    gc.collect()
    torch.cuda.empty_cache()
    paths["train_moe"] = run_train_moe(_build.LAUNCHES)
    gc.collect()
    torch.cuda.empty_cache()
    paths["train_cli"], paths["train_cli_8bit"] = run_train_cli_7b(
        _build.LAUNCHES)
    # The bf16 full-width paths run every SAM and flash launch, every w8a8
    # launch and every w4a16 launch on the tensor cores or (w8a8 decode)
    # the streamed skinny kernel: the first skinny kernels and the tile
    # count under /scalar.
    for p in ("encoder_backward", "predictor_vit_b", "pipeline_vit_h",
              "export_vit_h", "evaluate_bf16",
              "evaluate_w8a8", "evaluate_w4a16", "evaluate_spec_bf16",
              "evaluate_spec_w8a8", "evaluate_mpt_bf16", "evaluate_mpt_w8a8",
              "serve_bf16", "stream", "train", "train_cli", "train_cli_8bit",
              "evaluate_moe_bf16", "evaluate_spec_moe_bf16", "train_moe"):
        scalar = {k: n for k, n in paths[p].items() if k.endswith("/scalar") and n}
        if scalar:
            raise AssertionError(f"{p}: launches on the scalar path {scalar}")
    log("scalar SAM, flash_prefill_fwd, flash_bwd_dq, flash_bwd_dkv, "
        "w8a8_matmul and w4a16_matmul launches on the bf16 full-width "
        "paths: none")
    log("launches by path: " + json.dumps(
        {p: {k: n for k, n in sorted(c.items()) if n}
         for p, c in paths.items()}))
    for rec in kernels:
        name = rec["name"]
        counter = rec.get("counter", name)
        rec["launches_by_path"] = {p: paths[p].get(counter, 0)
                                   for p in EXPECTED_ON[name]}
        rec["launches"] = rec["launches_by_path"][EXPECTED_ON[name][0]]
        if not all(rec["launches_by_path"].values()):
            raise AssertionError(f"{name} did not launch on every path it is "
                                 f"expected on: {rec['launches_by_path']}")
    log(f"chip_smoke: {time.perf_counter() - start:.1f} s wall in all, the "
        f"kernels' build included | {card}")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
