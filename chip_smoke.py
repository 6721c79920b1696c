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
   `bf16_graph_ms`); every record but
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

The bf16 full-width paths (evaluate in three modes, serve_bf16, stream,
train, train_cli, train_cli_8bit, the ViT-B predictor, the encoder
backward) must run every SAM,
flash forward, dq and dk/dv launch on the tensor cores, and every w8a8
launch on the tensor cores (M > 16) or the streamed skinny kernel
(decode), and every w4a16 launch on the tensor cores: no `<key>/scalar`
launch count (the first skinny kernels count there).

Prints a {"kernels": [...]} JSON line, the nvidia-smi line, and last
{"ok": true, "device": {...}}. Needs no network; the weights are random.
"""

import collections
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
EXPECTED_ON = {
    "sam_window_relpos_attn": ("evaluate_bf16", "evaluate_w8a8",
                               "evaluate_w4a16", "train", "encoder_backward",
                               "serve_bf16", "stream", "train_cli",
                               "train_cli_8bit"),
    "sam_global_relpos_attn": ("evaluate_bf16", "evaluate_w8a8",
                               "evaluate_w4a16", "train", "encoder_backward",
                               "predictor_vit_b", "small", "serve_bf16",
                               "stream", "train_cli", "train_cli_8bit"),
    # The split window entry at the geometries of the TPU head-loop kernel
    # (counted under the split entry's key, on the paths that run it there).
    "sam_window_relpos_attn/vit_b": ("predictor_vit_b", "small"),
    "sam_window_relpos_attn_fused": ("audit", "predictor_tiny"),
    "sam_global_relpos_attn_heads": ("audit",),
    "sam_window_relpos_attn_heads": ("audit",),
    "matmul_probe": ("bench",),
    "flash_prefill_fwd": ("evaluate_bf16", "evaluate_w8a8", "evaluate_w4a16",
                          "train", "serve_bf16", "stream", "train_cli",
                          "train_cli_8bit"),
    "flash_bwd_dq": ("train", "train_cli", "train_cli_8bit"),
    "flash_bwd_dkv": ("train", "train_cli", "train_cli_8bit"),
    "decode_attn": ("evaluate_w8a8", "evaluate_bf16", "evaluate_w4a16",
                    "serve_bf16", "stream", "train_cli", "train_cli_8bit"),
    # train_cli_8bit: the QLoRA train step (tensor-core path, under grad)
    # and its validation's decode (skinny path); train_cli_tiny: the tiny
    # card-vs-CPU CLI runs (float32: w4a16 on its scalar kernel).
    "w8a8_matmul": ("evaluate_w8a8", "train_cli_8bit", "train_cli_tiny"),
    "w4a16_matmul": ("evaluate_w4a16", "train_cli_tiny"),
}


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
    from haff_tpu_torch.kernels import flash_attention as fa

    # LLaMA-7B prefill of 2 requests: prompt 320 + 256 image tokens - 1.
    b, l, h, d = 2, 575, 32, 128
    dev, bf = "cuda", torch.bfloat16
    q, k, v = (torch.randn(b, l, h, d, generator=gen, device=dev).to(bf)
               for _ in range(3))
    # Right padding: row 1 is 100 tokens short (more than a 64-row tile);
    # its pad queries are fully-masked rows.
    lengths = torch.tensor([l, l - 100], device=dev)
    seg = (torch.arange(l, device=dev)[None] < lengths[:, None]).to(torch.int32)
    path = fa.PATH_NAMES[fa.kernel_path(q, k, v)]
    if path != "wgmma":
        raise AssertionError(f"flash_prefill_fwd: bf16 phase-3 operands on "
                             f"the {path} path")
    out, lse = fa.flash_prefill_kernel(q, k, v, None, seg, seg, True)
    ref, ref_lse = fa.attention_plain(q.float(), k.float(), v.float(), None,
                                      seg, seg, True)
    err = within_bf16("flash_prefill_fwd", out, ref)
    lse_err = float((lse - ref_lse).abs().max())
    if not lse_err <= 1e-3:  # both float32: summation order only
        raise AssertionError(f"flash_prefill_fwd: lse max abs err {lse_err}")
    if out[1, l - 100:].abs().max() != 0 or lse[1, :, l - 100:].abs().max() != 0:
        raise AssertionError("flash_prefill_fwd: fully-masked rows not zero")
    run = lambda: fa.flash_prefill_kernel(q, k, v, None, seg, seg, True)  # noqa: E731
    kern, kern_graph = cuda_ms(run, 20), graph_ms(run, 20)
    plain = cuda_ms(lambda: fa.attention_plain(q, k, v, None, seg, seg, True),
                    10)
    causal = torch.ones(l, l, dtype=torch.bool, device=dev).tril()
    mask = (causal[None] & (seg[:, :, None] == seg[:, None, :])
            & (seg[:, None, :] != 0))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, attn_mask=mask[:, None])
    lib, lib_graph = cuda_ms(sdpa, 20), graph_ms(sdpa, 20)
    pairs = int(mask.sum())  # visible (query, key) pairs of this input
    flops = 4 * d * h * pairs
    b_ms, by = bound_ms(nbytes(q, k, v, seg, seg, out, lse), flops)
    return dict(name="flash_prefill_fwd", route="cuda",
                source="haff_tpu_torch/kernels/csrc/flash_prefill.cu",
                replaces="haff_tpu/kernels/flash_attention.py:105",
                shape=f"q/k/v {tuple(q.shape)} bf16 causal, lengths "
                      f"{lengths.tolist()}", path=path,
                max_abs_err=err, ms=kern, plain_ms=plain, bound_ms=b_ms,
                bound_by=by, library_ms=lib, graph_ms=kern_graph,
                library_graph_ms=lib_graph)


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
                          ("decode odd K", 2, 4100, 4096)):
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
    over the int8 cache. The bound counts the live slots only. Library:
    SDPA over the dequantized cache laid out (B, nh, L, hd) with a boolean
    key mask, prepared outside the timed call. Kernel and library are
    also timed as CUDA graphs; each shape names the split the kernel ran
    (`decode_plan`: splits, slots a split). The record's numbers are the
    first shape's."""
    from haff_tpu_torch.kernels import decode_attention as da
    from haff_tpu_torch.nn import quant

    b, lmax, nh, hd = 2, 591, 32, 128
    dev, bf = "cuda", torch.bfloat16
    if da.decode_plan(b, nh, nh, lmax)[0] < 2:
        raise AssertionError("decode_attn: the 7b decode step does not split "
                             "its slots over blocks")
    q = (0.5 * torch.randn(b, nh, hd, generator=gen, device=dev)).to(bf)
    kf = 0.5 * torch.randn(b, lmax, nh, hd, generator=gen, device=dev)
    vf = torch.randn(b, lmax, nh, hd, generator=gen, device=dev)
    shapes = []
    for kind, lengths in (("int8", (590, 1)), ("bf16", (590, 1)),
                          ("int8", (590, 590))):
        if kind == "int8":
            k, v = quant.quantize_activation(kf), quant.quantize_activation(vf)
            per_slot = 2 * nh * (hd + 4)
        else:
            k, v = kf.to(bf), vf.to(bf)
            per_slot = 2 * nh * hd * 2
        mask = (torch.arange(lmax, device=dev)[None]
                < torch.tensor(lengths, device=dev)[:, None]).to(torch.int32)
        scale = hd ** -0.5
        out = da.decode_attention_kernel(q, k, v, mask, scale)
        ref = da.decode_attention_plain(q.float(), k, v, mask, scale)
        err = within_bf16(f"decode_attn {kind}", out, ref)
        run = lambda: da.decode_attention_kernel(q, k, v, mask, scale)  # noqa: E731
        kern, kern_graph = cuda_ms(run, 50), graph_ms(run, 50)
        plain = cuda_ms(lambda: da.decode_attention_plain(q, k, v, mask,
                                                          scale), 10)
        kd, vd = (da.dequantize_cache(c).to(bf).transpose(1, 2) for c in (k, v))
        key_mask = (mask > 0)[:, None, None, :]
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
            q[:, :, None], kd, vd, attn_mask=key_mask, scale=scale)
        lib, lib_graph = cuda_ms(sdpa, 50), graph_ms(sdpa, 50)
        live = int(mask.sum())
        b_ms, by = bound_ms(live * per_slot + nbytes(q, mask, out),
                            4.0 * hd * nh * live)
        shapes.append(dict(shape=f"q {tuple(q.shape)} bf16, {kind} cache "
                           f"{(b, lmax, nh, hd)}, live {list(lengths)}",
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


def run_slice(launches, mode="bf16"):
    """evaluate() at the full 7b preset in one serving mode: "bf16", "w8a8"
    (int8 weights + int8 KV cache) or "w4a16" (packed-int4 LLM). Returns
    the launch counts over its 2 evaluate calls."""
    from haff_tpu_torch.core.config import ModelConfig
    from haff_tpu_torch.infer.evaluate import evaluate_fn
    from haff_tpu_torch.model.lisa import LisaModel
    from haff_tpu_torch.nn.layers import QDense

    cfg = ModelConfig.preset("7b")
    t0 = time.perf_counter()
    model = LisaModel(cfg, torch.bfloat16, device="cuda",
                      generator=torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    nparam = sum(p.numel() for p in model.parameters())
    log(f"slice {mode}: 7b preset built in {time.perf_counter() - t0:.1f} s, "
        f"{nparam / 1e9:.3f} B parameters bf16, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    B, P, T, S = 2, 320, 16, cfg.sam_encoder.image_size
    expected = dict(PER_EVALUATE, w8a8_matmul=0, w4a16_matmul=0)
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
        log(f"slice {mode}: {len(layers)} layers quantized in place in "
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
                raise AssertionError(f"{mode}: {name}: {launches[name]} "
                                     f"launches after {i + 1} evaluate calls, "
                                     f"expected {per * (i + 1)}")
        log(f"slice {mode} batch {i}: {B} requests, latency {dt * 1e3:.1f} ms "
            f"(host clock, synchronized), tokens generated "
            f"{int(res.gen_lengths.sum())}, seg_found "
            f"{res.seg_found.tolist()}, taxonomy[0] "
            f"{[round(x, 4) for x in res.taxonomies[0].tolist()]}")
    counts = dict(launches)
    log(f"slice {mode}: launches over 2 evaluate calls {counts}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    req = make_requests(cfg, B, P, seed=2)
    profile_call(f"evaluate {mode}", lambda: run(req))
    run_graphed(model, mode, cfg, eager, eager_ms, expected)
    return counts


def run_graphed(model, mode, cfg, eager, eager_ms, expected):
    """The eager slice's requests through make_jitted_evaluate (the decode
    loop captured in a CUDA graph): one capture call and two replays
    (requests 0, 1, 0), each against the eager call on the same request:
    identical tokens, masks and taxonomy within one bf16 ulp, the same
    launches per call and none on a scalar path. Prints both latencies
    and profiles one replayed call."""
    from haff_tpu_torch.infer.evaluate import make_jitted_evaluate
    from haff_tpu_torch.kernels import _build

    B, P, T = 2, 320, 16
    graphed = make_jitted_evaluate(model, T, 2, kv_cache_8bit=mode == "w8a8")
    graph_ms, identical = [], []
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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the "
              "card", file=sys.stderr)
        return 2
    from haff_tpu_torch.kernels import _build  # fails outside a checkout

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
    check_tiny_serving()
    check_small_cli()
    check_tiny_train()
    torch.cuda.empty_cache()
    _build.LAUNCHES.clear()
    paths_tiny = check_tiny_train_cli()
    torch.cuda.empty_cache()

    # Each path is driven with the counts set to 0 just before it and read
    # just after; each model is freed before the next is built.
    paths = {"train_cli_tiny": paths_tiny,
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
    for mode in ("bf16", "w8a8", "w4a16"):
        paths[f"evaluate_{mode}"] = run_slice(_build.LAUNCHES, mode)
        gc.collect()
        torch.cuda.empty_cache()
    paths["serve_bf16"], paths["stream"] = run_serve(_build.LAUNCHES)
    gc.collect()
    torch.cuda.empty_cache()
    paths["train"] = run_train_slice(_build.LAUNCHES)
    gc.collect()
    torch.cuda.empty_cache()
    paths["train_cli"], paths["train_cli_8bit"] = run_train_cli_7b(
        _build.LAUNCHES)
    # The bf16 full-width paths run every SAM and flash launch, every w8a8
    # launch and every w4a16 launch on the tensor cores or (w8a8 decode)
    # the streamed skinny kernel: the first skinny kernels and the tile
    # count under /scalar.
    for p in ("encoder_backward", "predictor_vit_b", "evaluate_bf16",
              "evaluate_w8a8", "evaluate_w4a16", "serve_bf16", "stream",
              "train", "train_cli", "train_cli_8bit"):
        scalar = {k: n for k, n in paths[p].items() if k.endswith("/scalar") and n}
        if scalar:
            raise AssertionError(f"{p}: launches on the scalar path {scalar}")
    log("scalar SAM, flash_prefill_fwd, flash_bwd_dq, flash_bwd_dkv, "
        "w8a8_matmul and w4a16_matmul launches on the bf16 full-width "
        "paths: none")
    for rec in kernels:
        name = rec["name"]
        counter = rec.get("counter", name)
        rec["launches_by_path"] = {p: paths[p].get(counter, 0)
                                   for p in EXPECTED_ON[name]}
        rec["launches"] = rec["launches_by_path"][EXPECTED_ON[name][0]]
        if not all(rec["launches_by_path"].values()):
            raise AssertionError(f"{name} did not launch on every path it is "
                                 f"expected on: {rec['launches_by_path']}")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
