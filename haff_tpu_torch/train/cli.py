"""Training CLI, the train_ds.py analog (port of haff_tpu/train/cli.py).

Capability parity with reference 2Haff/train_ds.py: flag surface
(SURVEY.md section 5.6), tokenizer + [SEG] token, LoRA config, dataset
selection (local shards or HF hub) and mixing, per-epoch validation
against the benchmark dir with IoU/IoCM, best-IoU checkpointing with
auto-resume, meters + TensorBoard scalars, SIGTERM preemption.

One card (`--device`, default cuda; `--device cpu` runs the plain
versions): the train step of train/trainer.py (AdamW + WarmupDecayLR,
gradient accumulation, remat), batches built ahead by a thread pool
(data/loader.py), checkpoints written by a background thread
(train/checkpoints.py), validation through the decode graph
(infer/evaluate.py `validate_on_benchmark`, one `make_jitted_evaluate`
kept for the run, so later epochs replay the first epoch's graph against
the updated weights). `--load_in_8bit` / `--load_in_4bit` quantize the
frozen set in place (QLoRA): the products' straight-through backward
carries the gradient to the adapters.

Batch i of epoch e draws its samples from the datasets' generators
reseeded from (seed, e, i), so a run's batches do not depend on the
number of workers, and a resumed run trains on the batches the
uninterrupted run would have.

Usage: python -m haff_tpu_torch.train.cli --dataset_dir D
       [--val_benchmark_dir B] [--model_preset tiny|1b|7b|13b]
       [--lora_r 8] [--epochs 10] [--steps_per_epoch 500] [--batch_size 2]
       [--grad_accum 10] [--lr 3e-4] [--log_base_dir runs] [--exp_name E]
       [--device cuda|cpu] ...
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import threading
import time

import numpy as np

# The mesh, pipeline and expert-parallel flags parse as in the JAX CLI and
# raise here until the multi-GPU and MoE modules are ported.
_NOT_PORTED = ("not ported yet: one card only (ROADMAP Queue 1 item 9, "
               "MoE, and item 10, multi-GPU)")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    # model
    p.add_argument("--model_preset", default="7b")
    p.add_argument("--decoder", default="llama", choices=["llama", "mpt"])
    p.add_argument("--tokenizer", default=None)
    p.add_argument("--precision", default="bf16", choices=["bf16", "fp32"])
    p.add_argument("--image_size", type=int, default=1024)
    # Reference default (train_ds.py:52). Long 2HANDS narrations +
    # template + 255 image-token slots truncate identically this way.
    p.add_argument("--model_max_length", type=int, default=575)
    # lora
    p.add_argument("--lora_r", type=int, default=8)
    p.add_argument("--lora_alpha", type=float, default=16)
    p.add_argument("--lora_dropout", type=float, default=0.05)
    p.add_argument("--lora_target_modules", default="q_proj,v_proj",
                   help="comma-separated attention projections to adapt "
                        "(q_proj,k_proj,v_proj,o_proj)")
    # data
    p.add_argument("--dataset_dir", required=True,
                   help="2HANDS shards dir or HF repo id")
    p.add_argument("--dataset", default="affordance",
                   help='"||"-separated mix of affordance|sem_seg|'
                        'refer_seg|reason_seg|vqa')
    p.add_argument("--sample_rates", default="",
                   help="comma-separated weights per --dataset entry "
                        "(default: uniform)")
    p.add_argument("--sem_seg_data", default=None,
                   help="ADE20K-style dir (images/ + annotations/)")
    p.add_argument("--sem_seg_classes", default=None,
                   help="txt file with one class name per line")
    p.add_argument("--refer_seg_data", default=None,
                   help="dir with refs.json, instances.json, images/")
    p.add_argument("--reason_seg_data", default=None,
                   help="ReasonSeg dir (<split>/*.jpg + .json)")
    p.add_argument("--explanatory", type=float, default=-1.0,
                   help="ReasonSeg explanation-answer probability "
                        "(-1 = off, reference default 0.1)")
    p.add_argument("--vqa_data", default=None,
                   help="llava_instruct json path")
    p.add_argument("--vqa_image_dir", default=None)
    p.add_argument("--val_benchmark_dir", default=None)
    p.add_argument("--val_batch_size", type=int, default=1)
    p.add_argument("--samples_per_epoch", type=int, default=10000)
    # optimization (reference defaults: train_ds.py:34-122)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--workers", type=int, default=4,
                   help="batch-building threads (reference train_ds.py "
                        "--workers)")
    p.add_argument("--steps_per_epoch", type=int, default=500)
    p.add_argument("--batch_size", type=int, default=2)
    p.add_argument("--grad_accum", type=int, default=10)
    p.add_argument("--lr", type=float, default=1e-3)  # train_ds.py:92
    p.add_argument("--beta1", type=float, default=0.9)
    p.add_argument("--beta2", type=float, default=0.95)
    p.add_argument("--warmup_steps", type=int, default=100)
    p.add_argument("--grad_clip", type=float, default=1.0)
    p.add_argument("--ce_loss_weight", type=float, default=1.0)
    p.add_argument("--dice_loss_weight", type=float, default=0.5)
    p.add_argument("--bce_loss_weight", type=float, default=2.0)
    p.add_argument("--taxonomy_logit_ce", action="store_true",
                   help="Single-softmax taxonomy CE (on pre-softmax "
                   "logits). Default off = reference-faithful "
                   "double-softmax (mask_decoder.py:172-178 + "
                   "LISA.py:415), which is a gradient trap for rare "
                   "taxonomy classes.")
    p.add_argument("--no_remat", action="store_true")
    p.add_argument("--load_in_8bit", action="store_true",
                   help="QLoRA-style: the frozen LLM projections int8 on "
                        "the device (W8A8 forward, straight-through "
                        "backward)")
    p.add_argument("--load_in_4bit", action="store_true",
                   help="QLoRA-style packed-int4 frozen LLM projections")
    # mesh (one card here; see _NOT_PORTED)
    p.add_argument("--fsdp", type=int, default=1)
    p.add_argument("--tensor", type=int, default=1)
    p.add_argument("--sp", type=int, default=1,
                   help="sequence-parallel axis size (not ported)")
    p.add_argument("--pp", type=int, default=1,
                   help="pipeline-parallel axis size (not ported)")
    p.add_argument("--pp_microbatches", type=int, default=0,
                   help="GPipe microbatches per step (0 = auto, the "
                        "largest batch divisor <= 2*pp)")
    p.add_argument("--ep", type=int, default=1,
                   help="expert-parallel axis size (not ported)")
    p.add_argument("--moe_experts", type=int, default=0,
                   help="Mixture-of-Experts decoder MLPs (not ported; 0 = "
                        "dense, the reference architecture)")
    p.add_argument("--moe_top_k", type=int, default=2)
    p.add_argument("--moe_every", type=int, default=1,
                   help="MoE layer interleave (1 = every layer, 2 = "
                        "every other)")
    # logging / ckpt
    p.add_argument("--exp_name", default="haff_tpu")
    p.add_argument("--log_base_dir", default="./runs")
    p.add_argument("--conv_type", default="llava_v1",
                   choices=["llava_v1", "llava_llama_2"])
    p.add_argument("--use_mm_start_end", action="store_true", default=True)
    p.add_argument("--no_mm_start_end", dest="use_mm_start_end",
                   action="store_false")
    p.add_argument("--train_mask_decoder", action="store_true",
                   default=True)
    p.add_argument("--no_train_mask_decoder", dest="train_mask_decoder",
                   action="store_false")
    p.add_argument("--train_vision_encoder", action="store_true",
                   help="unfreeze the SAM image encoder (beyond the "
                        "reference freeze set; for from-scratch runs "
                        "with no pretrained tower)")
    p.add_argument("--reset_mask_decoder", action="store_true",
                   help="re-initialize both mask decoders (reference "
                        "train_ds.py:245-256)")
    p.add_argument("--eval_only", action="store_true",
                   help="run one validation pass and exit")
    p.add_argument("--no_eval", action="store_true",
                   help="skip per-epoch validation")
    p.add_argument("--resume", default=None,
                   help="explicit checkpoint dir (overrides auto-resume)")
    p.add_argument("--pretrained_params", default=None,
                   help="initial weights: an export_params .npz "
                        "(not a training resume)")
    p.add_argument("--vision_pretrained", default=None,
                   help="raw SAM .pth checkpoint; converted on the fly "
                        "with left/right decoder duplication (reference "
                        "--vision_pretrained)")
    p.add_argument("--start_epoch", type=int, default=None)
    p.add_argument("--auto_resume", action="store_true", default=True)
    p.add_argument("--no_auto_resume", dest="auto_resume",
                   action="store_false")
    p.add_argument("--use_wandb", action="store_true")
    p.add_argument("--print_freq", type=int, default=10)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", default="cuda",
                   help="cuda (the card, default) or cpu")
    return p.parse_args(argv)


def check_flags(args) -> None:
    """The JAX CLI's combination errors (same wording), then the flags
    the port does not run yet."""
    if args.pp > 1 and args.sp > 1:
        raise SystemExit(
            "--pp cannot be combined with --sp (ring attention); "
            "use pp x tensor x data instead")
    if args.pp > 1 and args.moe_experts > 0:
        raise SystemExit(
            "--pp cannot be combined with --moe_experts (the GPipe "
            "engine stacks homogeneous per-layer params); use "
            "data x fsdp x ep x tensor instead")
    if args.moe_experts == 0 and args.ep > 1:
        raise SystemExit("--ep > 1 requires --moe_experts > 0")
    if args.moe_experts > 0 and args.moe_every < 1:
        raise SystemExit("--moe_every must be >= 1")
    if args.ep > 1 and args.moe_experts % args.ep != 0:
        raise SystemExit(
            f"--moe_experts {args.moe_experts} must be divisible by "
            f"--ep {args.ep} (stacked expert weights shard over the "
            "expert axis)")
    for flag in ("pp", "sp", "fsdp", "tensor", "ep"):
        if getattr(args, flag) > 1:
            raise SystemExit(f"--{flag} {getattr(args, flag)}: {_NOT_PORTED}")
    if args.moe_experts > 0:
        raise SystemExit(f"--moe_experts {args.moe_experts}: {_NOT_PORTED}")
    if args.decoder != "llama":
        raise SystemExit("--decoder mpt: not ported yet (ROADMAP Queue 1 "
                         "item 8)")
    if args.load_in_8bit and args.load_in_4bit:
        raise SystemExit("--load_in_8bit and --load_in_4bit exclude each "
                         "other")


def model_config(args, tok):
    """The preset with the CLI's LoRA, vocabulary and loss settings."""
    from ..core.config import ModelConfig
    from ..data.tokenizer import seg_token_idx

    base = ModelConfig.preset(args.model_preset)
    return base.replace(
        seg_token_idx=seg_token_idx(tok),
        decoder=args.decoder,
        ce_loss_weight=args.ce_loss_weight,
        dice_loss_weight=args.dice_loss_weight,
        bce_loss_weight=args.bce_loss_weight,
        taxonomy_logit_ce=args.taxonomy_logit_ce,
        llama=dataclasses.replace(
            base.llama, lora_rank=args.lora_r, lora_alpha=args.lora_alpha,
            lora_dropout=args.lora_dropout,
            lora_targets=tuple(
                m for m in args.lora_target_modules.split(",") if m),
            vocab_size=max(base.llama.vocab_size, len(tok) + 4)))


def build_model(cfg, precision: str, device, seed: int,
                pretrained_params=None, vision_pretrained=None,
                reset_mask_decoder: bool = False):
    """The LisaModel a run starts from, on `device`: weights drawn from a
    generator seeded `seed` on that device, then `pretrained_params` (an
    export .npz), then `vision_pretrained` (a raw SAM checkpoint, both
    mask decoders from its one), then, with `reset_mask_decoder`, both
    mask decoders drawn afresh from a generator seeded `seed + 7`
    (reference train_ds.py:245-256)."""
    import torch

    from ..model.lisa import LisaModel, init_random_

    dtype = torch.bfloat16 if precision == "bf16" else torch.float32
    device = torch.device(device)
    model = LisaModel(cfg, dtype, device=device,
                      generator=torch.Generator(device).manual_seed(seed))
    if pretrained_params:
        from .checkpoints import restore_params

        restore_params(pretrained_params, model)
        print(f"initialized from {pretrained_params}")
    if vision_pretrained:
        from ..tools.convert_weights import (convert_sam, load_state_dict,
                                             merge_into_init)

        sd = load_state_dict(vision_pretrained)
        merge_into_init(model, {"visual_model": convert_sam(
            sd, depth=cfg.sam_encoder.depth)})
        print(f"overlaid SAM weights from {vision_pretrained}")
    if reset_mask_decoder:
        gen = torch.Generator(device).manual_seed(seed + 7)
        for dec in (model.visual_model.mask_decoder_left,
                    model.visual_model.mask_decoder_right):
            init_random_(dec, gen)
        print("mask decoders re-initialized")
    return model


def model_meta(args, cfg) -> dict:
    """How the run's model was built: what a Predictor needs to rebuild it
    around a checkpoint's trainable tensors (infer/predictor.py)."""
    llama = cfg.llama
    return dict(model_preset=args.model_preset, decoder=args.decoder,
                precision=args.precision, seed=args.seed,
                pretrained_params=args.pretrained_params,
                vision_pretrained=args.vision_pretrained,
                reset_mask_decoder=args.reset_mask_decoder,
                llama=dict(lora_rank=llama.lora_rank,
                           lora_alpha=llama.lora_alpha,
                           lora_dropout=llama.lora_dropout,
                           lora_targets=list(llama.lora_targets),
                           vocab_size=llama.vocab_size))


def frozen_predicate(frozen, should_quantize):
    """`should_quantize` restricted to the frozen set (parameter names):
    QLoRA quantizes the frozen partition only (the JAX CLI quantizes
    `frozen` after `partition_params`), so the trainable `lm_head` stays
    float."""
    names = set(frozen)
    return lambda path: (".".join(path) in names and should_quantize(path))


def reseed_(ds, seed: int) -> None:
    """Reseed a dataset's generator and, for a mix, each member's."""
    from ..nn.lora import fold_in

    ds.rng = np.random.RandomState(seed % 2 ** 32)
    for i, member in enumerate(getattr(ds, "datasets", ())):
        reseed_(member, fold_in(seed, i))


def build_dataset(args, seed: int):
    from ..data.aff_dataset import AffDataset

    names = [n for n in args.dataset.split("||") if n]
    corpora = []
    for n in names:
        if n == "affordance":
            corpora.append(AffDataset(
                args.dataset_dir, samples_per_epoch=args.samples_per_epoch,
                seed=seed))
        elif n == "sem_seg":
            from ..data.seg_datasets import SemSegDataset

            with open(args.sem_seg_classes) as f:
                classes = [ln.strip() for ln in f if ln.strip()]
            corpora.append(SemSegDataset(args.sem_seg_data, classes,
                                         seed=seed))
        elif n == "refer_seg":
            from ..data.seg_datasets import ReferSegDataset

            refer_base = args.refer_seg_data
            corpora.append(ReferSegDataset(
                os.path.join(refer_base, "refs.json"),
                os.path.join(refer_base, "instances.json"),
                os.path.join(refer_base, "images"), seed=seed))
        elif n == "reason_seg":
            from ..data.extra_datasets import ReasonSegDataset

            corpora.append(ReasonSegDataset(
                args.reason_seg_data, seed=seed,
                explanatory=args.explanatory))
        elif n == "vqa":
            from ..data.extra_datasets import VqaDataset

            corpora.append(VqaDataset(args.vqa_data, args.vqa_image_dir,
                                      seed=seed))
        else:
            raise SystemExit(f"unknown dataset {n!r}")
    if len(corpora) == 1:
        ds = corpora[0]
    else:
        from ..data.extra_datasets import HybridDataset

        rates = ([float(r) for r in args.sample_rates.split(",")]
                 if args.sample_rates else [1.0] * len(corpora))
        ds = HybridDataset(corpora, rates,
                           samples_per_epoch=args.samples_per_epoch,
                           seed=seed)
    print(f"datasets: {names}; samples/epoch {args.samples_per_epoch}")
    return ds


@dataclasses.dataclass
class TrainRun:
    """What `main` ran: per micro-step metrics (floats, with the step
    count and `secs`, the step's time to its metrics on the host), each
    validation as (epoch, IoU, IoCM, frames, secs), each checkpoint as a
    dict (step; copy_s, the seconds `save` took to copy the state to the
    host; written_s, the seconds until it was on disk), the peak device
    memory in bytes (CUDA only), and the model, tokenizer, validation set
    and kept evaluate callable for a caller to examine."""

    steps: list = dataclasses.field(default_factory=list)
    validations: list = dataclasses.field(default_factory=list)
    checkpoints: list = dataclasses.field(default_factory=list)
    start_step: int = 0
    preempted: bool = False
    peak_bytes: int = 0
    model: object = None
    tok: object = None
    val_ds: object = None
    evaluate: object = None


def main(argv=None) -> TrainRun:
    args = parse_args(argv)
    check_flags(args)

    import signal

    import torch

    from ..core.config import TrainConfig
    from ..data.aff_dataset import AffDatasetVal
    from ..data.collate import collate_affordance
    from ..data.loader import PrefetchLoader
    from ..data.tokenizer import load_tokenizer
    from ..infer.evaluate import make_jitted_evaluate, validate_on_benchmark
    from ..infer.predictor import _require_device
    from ..model.lisa import TrainBatch
    from ..nn.lora import fold_in
    from .checkpoints import (CheckpointWriter, restore_checkpoint,
                              save_checkpoint)
    from .metrics import AverageMeter, MetricsLogger, ProgressMeter
    from .trainer import (count_params, init_train_state, make_train_step,
                          partition_params)

    device = _require_device(args.device)
    run = TrainRun()
    log_dir = os.path.join(args.log_base_dir, args.exp_name)
    ckpt_dir = os.path.join(log_dir, "ckpt_model")
    os.makedirs(log_dir, exist_ok=True)

    tok = load_tokenizer(args.tokenizer,
                         model_max_length=args.model_max_length)
    cfg = model_config(args, tok)
    tcfg = TrainConfig(
        model=cfg, lr=args.lr, beta1=args.beta1, beta2=args.beta2,
        warmup_steps=args.warmup_steps,
        total_steps=args.epochs * args.steps_per_epoch,
        epochs=args.epochs, steps_per_epoch=args.steps_per_epoch,
        batch_size=args.batch_size,
        grad_accumulation_steps=args.grad_accum,
        grad_clip_norm=args.grad_clip,
        pp_microbatches=args.pp_microbatches, seed=args.seed,
        remat=not args.no_remat)

    # Per-rank seed offset shards the random sampling across processes
    # (the DistributedSampler analog, reference train_ds.py:418-420).
    import torch.distributed as dist

    rank = dist.get_rank() if dist.is_available() and dist.is_initialized() \
        else 0
    seed = args.seed + 1000 * rank
    ds = build_dataset(args, seed)
    batch_lock = threading.Lock()

    def batch_maker(epoch):
        def make_batch(i):
            # The samples of batch i come from generators reseeded for it;
            # the collate (the heavy part) runs unlocked.
            with batch_lock:
                reseed_(ds, fold_in(seed, epoch, i))
                samples = [ds[0] for _ in range(args.batch_size)]
            return collate_affordance(
                samples, tok, sam_image_size=cfg.sam_encoder.image_size,
                clip_image_size=cfg.clip.image_size,
                max_text_len=args.model_max_length,
                conv_type=args.conv_type,
                use_mm_start_end=args.use_mm_start_end)
        return make_batch

    model = build_model(cfg, args.precision, device, args.seed,
                        args.pretrained_params, args.vision_pretrained,
                        args.reset_mask_decoder)
    exclude = () if args.train_mask_decoder else (
        "mask_decoder_left", "mask_decoder_right")
    extra = ("image_encoder",) if args.train_vision_encoder else ()
    trainable, frozen = partition_params(model, exclude, extra)
    print(f"trainable params: {count_params(trainable):,} / "
          f"{count_params(trainable) + count_params(frozen):,}")
    # Names only from here: a reference to a frozen float weight would keep
    # it on the device beside its quantized copy after --load_in_*bit.
    frozen = set(frozen)
    if args.load_in_8bit or args.load_in_4bit:
        # QLoRA analog (reference train_ds.py:57-58 bitsandbytes load): the
        # frozen LLM projections become int8 / packed int4 in place, one
        # layer at a time, each float weight freed as it goes; the
        # quantized products pass a straight-through gradient to x.
        from ..nn.quant import default_llm_predicate, quantize_model_

        quantize_model_(model, frozen_predicate(frozen, default_llm_predicate),
                        bits=4 if args.load_in_4bit else 8)
        print(f"frozen base quantized in place "
              f"({'int4' if args.load_in_4bit else 'int8'})")

    state = init_train_state(tcfg, trainable)
    start_epoch = 0
    micro_per_epoch = args.steps_per_epoch * args.grad_accum
    if args.resume:
        state, step = restore_checkpoint(args.resume, state)
        if step is None:
            raise SystemExit(
                f"--resume {args.resume}: no checkpoint found")
        start_epoch = int(step) // micro_per_epoch
        print(f"resumed from {args.resume} step {step} "
              f"(epoch {start_epoch})")
    elif args.auto_resume:
        state, step = restore_checkpoint(ckpt_dir, state)
        if step is not None:
            start_epoch = int(step) // micro_per_epoch
            print(f"auto-resumed from step {step} (epoch {start_epoch})")
    if args.start_epoch is not None:
        start_epoch = args.start_epoch
    run.start_step = int(state.step)

    step_fn = make_train_step(model, tcfg)
    logger = MetricsLogger(log_dir, use_wandb=args.use_wandb,
                           exp_name=args.exp_name)
    val_ds = AffDatasetVal(args.val_benchmark_dir) \
        if args.val_benchmark_dir else None
    ev = make_jitted_evaluate(model, max_new_tokens=32,
                              eos_id=tok.eos_token_id)
    run.model, run.tok, run.val_ds, run.evaluate = model, tok, val_ds, ev
    meta = model_meta(args, cfg)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    best_iou = -1.0

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    def run_validation(epoch):
        """Reference validate() (train_ds.py:625-758) via the shared
        protocol in infer/evaluate.py, on the model's own weights
        (quantized layers included), through the run's kept evaluate."""
        sync()
        t0 = time.perf_counter()
        iou, iocm, frames = validate_on_benchmark(
            model, tok, val_ds, val_batch_size=args.val_batch_size,
            model_max_length=args.model_max_length,
            conv_type=args.conv_type,
            use_mm_start_end=args.use_mm_start_end, evaluate=ev)
        sync()
        run.validations.append((epoch, iou, iocm, frames,
                                time.perf_counter() - t0))
        return iou, iocm

    def finish():
        if cuda:
            run.peak_bytes = torch.cuda.max_memory_allocated(device)
        logger.close()
        return run

    if args.eval_only:
        if val_ds is None or not len(val_ds):
            raise SystemExit("--eval_only needs --val_benchmark_dir")
        val_iou, val_iocm = run_validation(start_epoch)
        print(f"eval_only: val IoU {val_iou:.4f} IoCM {val_iocm:.4f}")
        return finish()

    # Preemption: the first SIGTERM finishes the in-flight micro-step,
    # checkpoints and returns (auto-resume picks the run back up); a
    # second one takes the default action.
    preempted = {"flag": False}

    def _on_term(signum, frame):
        preempted["flag"] = True
        signal.signal(signal.SIGTERM, signal.SIG_DFL)
        print("SIGTERM: checkpointing after the current step ...",
              flush=True)

    prev_term = signal.signal(signal.SIGTERM, _on_term)
    # Epoch and best-IoU checkpoints are written by a background thread;
    # only the preemption path flushes and saves synchronously.
    writer = CheckpointWriter(ckpt_dir, model_meta=meta)

    pending = []  # (record, time its save returned), until written

    def save(metrics=None):
        t0 = time.perf_counter()
        writer.save(int(state.step), state, metrics=metrics)
        rec = dict(step=int(state.step), copy_s=time.perf_counter() - t0)
        run.checkpoints.append(rec)
        pending.append((rec, t0))

    def drain():
        writer.finish()
        now = time.perf_counter()
        for rec, t0 in pending:
            rec["written_s"] = now - t0
        pending.clear()

    try:
        for epoch in range(start_epoch, args.epochs):
            meters = {k: AverageMeter(k) for k in
                      ("loss", "ce_loss", "mask_bce_loss",
                       "mask_dice_loss", "taxonomy_ce_loss")}
            time_meter = AverageMeter("secs/batch")
            loader = PrefetchLoader(batch_maker(epoch), micro_per_epoch,
                                    num_workers=max(1, args.workers))
            model.train()
            t0 = time.time()
            for i, raw in enumerate(loader):
                batch = TrainBatch(**{k: v for k, v in raw.items()
                                      if k != "resizes"}).to(device)
                ts = time.perf_counter()
                state, metrics = step_fn(state, batch, args.seed)
                rec = {k: float(v) for k, v in metrics.items()}
                rec.update(step=int(state.step),
                           secs=time.perf_counter() - ts)
                run.steps.append(rec)
                if os.environ.get("HAFF_TEST_PREEMPT_STEP") == str(i):
                    os.kill(os.getpid(), signal.SIGTERM)  # test hook
                if preempted["flag"]:
                    # keep 2: this mid-training state AND the best-IoU
                    # checkpoint
                    drain()
                    t1 = time.perf_counter()
                    save_checkpoint(ckpt_dir, int(state.step), state,
                                    max_to_keep=2, model_meta=meta)
                    run.checkpoints.append(dict(
                        step=int(state.step),
                        written_s=time.perf_counter() - t1))
                    print(f"preemption checkpoint at step "
                          f"{int(state.step)}; exiting", flush=True)
                    run.preempted = True
                    return finish()
                # Reference meter semantics (train_ds.py:556-620): every
                # micro-step updates the meters; each print_freq window
                # logs the windowed average and resets.
                for k, m in meters.items():
                    m.update(rec[k])
                if (i + 1) % args.print_freq == 0:
                    time_meter.update((time.time() - t0)
                                      / args.print_freq)
                    t0 = time.time()
                    ProgressMeter(
                        micro_per_epoch,
                        list(meters.values()) + [time_meter],
                        prefix=f"Epoch {epoch} ").display(i + 1)
                    logger.log({k: m.avg for k, m in meters.items()},
                               int(state.step))
                    for m in meters.values():
                        m.reset()

            # --- validation (reference validate(), train_ds.py:625-758) ---
            if val_ds is not None and len(val_ds) and not args.no_eval:
                val_iou, val_iocm = run_validation(epoch)
                print(f"Epoch {epoch}: val IoU {val_iou:.4f} "
                      f"IoCM {val_iocm:.4f}")
                logger.log(dict(val_iou=val_iou, val_precision=val_iocm),
                           int(state.step))
                if val_iou > best_iou:
                    best_iou = val_iou
                    save(dict(iou=val_iou))
                    print(f"saved best checkpoint (IoU {val_iou:.4f})")
            else:
                save()
        drain()
    finally:
        signal.signal(signal.SIGTERM, prev_term)
    return finish()


if __name__ == "__main__":
    main()
