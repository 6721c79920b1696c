"""The composite 2Haff model (port of haff_tpu/model/lisa.py): CLIP ViT
tower + mm_projector, LLaMA decoder emitting [SEG] (or, with
`cfg.decoder == "mpt"`, the MPT decoder of nn/mpt.py at the LLaMA
config's widths; with `cfg.decoder == "deepseek_v3"`, the DeepSeek-V3
decoder of nn/deepseek_v3.py, whose DeepseekV3Config `cfg.llama` then
holds: serving only), the [SEG] projection MLP, and SAM with the dual
mask decoders and the taxonomy head.

The model is built on the `meta` device, then materialised on `device`
(default "cuda": the card, unless the caller asks for the CPU) in
`dtype`, with weights drawn from a seeded `torch.Generator`; with
`device="meta"` it stays there, shapes and dtypes only (nn/quant.py
`random_quantized_like` materializes such a model in serving precision,
tools/parity_check.py checks a key map against it). Real weights come
through tools/bridge.py. The submodule methods are the ones
infer/evaluate.py calls; `forward(batch)` is the training/validation
forward (JAX `LisaModel.__call__`): vision encoders over the unique images
(the CLIP tower always without autograd, the SAM encoder without it unless
one of its parameters is trainable), multimodal splice, LLaMA, [SEG]
gather, dual mask decode and the loss stack.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..core.config import ModelConfig
from ..core.dtypes import resolve, set_reference_precision
from ..core.mesh import batch_total
from ..nn import deepseek_v3
from ..nn.clip_vit import ClipVisionTower
from ..nn.layers import LayerNorm, QDense
from ..nn.llama import LlamaForCausalLM, RMSNorm
from ..nn.moe import MoEMLP, moe_layers
from ..nn.mpt import MptConfig, MptForCausalLM
from ..nn.lora import LoraDense
from ..nn.sam import Sam, postprocess_masks_padded
from . import losses as L
from .multimodal import (SplicedBatch, find_image_position,
                         gather_seg_embeddings, splice_image_embeddings)

# Raw parameters drawn at unit scale (the JAX initializers' normal(1.0));
# every other raw parameter is drawn at 0.02.
_UNIT_SCALE = ("iou_token", "mask_tokens", "point_embeddings",
               "not_a_point_embed", "no_mask_embed",
               "positional_encoding_gaussian_matrix")


class TrainBatch(NamedTuple):
    """Static-shape training batch (JAX `TrainBatch`)."""

    images_sam: torch.Tensor      # (B_img, S, S, 3) SAM-preprocessed
    images_clip: torch.Tensor     # (B_img, C, C, 3) CLIP-preprocessed
    image_index: torch.Tensor     # (B,) conversation -> image row
    input_ids: torch.Tensor       # (B, L) with IMAGE_TOKEN_INDEX
    labels: torch.Tensor          # (B, L) IGNORE_INDEX-masked targets
    attention_mask: torch.Tensor  # (B, L) 1 = real token
    masks_left: torch.Tensor      # (B, S, S) binary on the SAM canvas
    masks_right: torch.Tensor     # (B, S, S)
    taxonomies: torch.Tensor      # (B, 4)
    valid_region: torch.Tensor    # (B, S, S) 1 inside the resized frame
    sample_weight: torch.Tensor   # (B,) 1 = real sample

    def to(self, device) -> "TrainBatch":
        """Every field as a tensor on `device` (numpy arrays accepted)."""
        return TrainBatch(*(torch.as_tensor(x, device=device) for x in self))


class LisaOutputs(NamedTuple):
    loss: torch.Tensor
    ce_loss: torch.Tensor
    mask_bce_loss: torch.Tensor
    mask_dice_loss: torch.Tensor
    taxonomy_ce_loss: torch.Tensor
    pred_masks_left: torch.Tensor   # (B, S, S) logits on the canvas
    pred_masks_right: torch.Tensor
    pred_taxonomies: torch.Tensor   # (B, 4)
    # The MoE blocks' summed Switch load-balance terms (None without MoE
    # blocks); train/trainer.py weighs them into the loss.
    moe_aux: Optional[torch.Tensor] = None


class LisaModel(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype=torch.bfloat16,
                 device="cuda", generator: Optional[torch.Generator] = None,
                 mesh=None):
        """`mesh` (core/mesh.py): build only what this rank keeps of the
        decoder under its pipe and expert axes (parallel/sharding.py
        `cut_before_init_`); the kept weights are those of the whole
        model's seeded init."""
        super().__init__()
        self.cfg = cfg
        # The LLaMA decoder's MoE layers (the MPT decoder has none).
        self.moe_layers = (moe_layers(cfg.llama) if cfg.decoder == "llama"
                           else ())
        if cfg.decoder == "deepseek_v3" and mesh is not None:
            raise ValueError("the deepseek_v3 decoder has no mesh path")
        with torch.device("meta"):
            if cfg.decoder == "deepseek_v3":
                if not isinstance(cfg.llama, deepseek_v3.DeepseekV3Config):
                    raise ValueError(
                        "decoder='deepseek_v3' takes a DeepseekV3Config as "
                        "cfg.llama (nn/deepseek_v3.model_config)")
                self.llm = deepseek_v3.DeepseekV3ForCausalLM(cfg.llama)
            elif cfg.decoder == "mpt":
                # The alternative MPT backend (reference llava_mpt.py) at
                # the LLaMA config's widths: the same (logits, hidden,
                # caches) interface; ALiBi ignores the positions.
                self.llm = MptForCausalLM(MptConfig(
                    vocab_size=cfg.llama.vocab_size,
                    d_model=cfg.llama.hidden_size,
                    n_heads=cfg.llama.num_heads,
                    n_layers=cfg.llama.num_layers,
                    max_seq_len=cfg.llama.max_seq_len))
            else:
                self.llm = LlamaForCausalLM(cfg.llama)
            self.vision_tower = ClipVisionTower(cfg.clip)
            self.mm_projector = QDense(cfg.clip.hidden_size,
                                       cfg.llama.hidden_size)
            self.visual_model = Sam(cfg.sam_encoder, cfg.sam_decoder)
            self.text_fc1 = QDense(cfg.llama.hidden_size, cfg.llama.hidden_size)
            self.text_fc2 = QDense(cfg.llama.hidden_size, cfg.out_dim)
        self.dtype = resolve(dtype)
        self.to(self.dtype)
        if mesh is not None:
            from ..parallel.sharding import cut_before_init_

            cut_before_init_(self, mesh)
        if torch.device(device).type == "meta":
            return  # shapes and dtypes only (JAX's eval_shape)
        self.to_empty(device=torch.device(device))
        set_reference_precision()
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        init_random_(self, generator)

    @property
    def device(self):
        return self.text_fc1.weight.device

    # ----- submodule methods (as the JAX LisaModel's) -----

    def encode_clip(self, images_clip):
        return self.mm_projector(self.vision_tower(images_clip))

    def encode_sam(self, images_sam, remat: bool = False):
        return self.visual_model.encode_image(images_sam, remat)

    def project_seg(self, hidden):
        return self.text_fc2(F.relu(self.text_fc1(hidden)))

    def decode_masks(self, sam_embeddings, seg_embeds):
        return self.visual_model.decode_masks(sam_embeddings, seg_embeds)

    def llm_forward(self, inputs_embeds, positions, segment_ids=None,
                    kv_caches=None, cache_index=None,
                    cache_kv_segment_ids=None, **kw):
        return self.llm(inputs_embeds, positions, segment_ids, kv_caches,
                        cache_index, cache_kv_segment_ids, **kw)

    def embed_tokens(self, input_ids):
        # IMAGE_TOKEN_INDEX (-200) reads row 0; the splice overwrites it.
        return self.llm.embed(input_ids.clamp(min=0))

    # ----- the training / validation forward -----

    def splice_inputs(self, batch: TrainBatch, remat: bool = False):
        """Vision encoders over the unique images, expanded to
        conversations by `image_index`, and the multimodal splice. Each
        encoder keeps an autograd graph only when one of its parameters
        requires grad: the SAM encoder (recomputing each block in the
        backward with `remat`), and the CLIP tower with its projector.
        Returns (SAM embeddings per conversation, SplicedBatch)."""
        grad = torch.is_grad_enabled()
        encoder = self.visual_model.image_encoder
        train_sam = any(p.requires_grad for p in encoder.parameters())
        with torch.set_grad_enabled(train_sam and grad):
            sam_emb = self.encode_sam(batch.images_sam, remat)
        clip = (*self.vision_tower.parameters(), *self.mm_projector.parameters())
        with torch.set_grad_enabled(grad and any(p.requires_grad for p in clip)):
            clip_emb = self.encode_clip(batch.images_clip)
        index = batch.image_index.long()
        sam_emb, clip_emb = sam_emb[index], clip_emb[index]
        input_ids = batch.input_ids.long()
        sp = splice_image_embeddings(
            self.embed_tokens(input_ids), clip_emb,
            find_image_position(input_ids), input_ids, batch.labels,
            batch.attention_mask, seg_token_idx=self.cfg.seg_token_idx)
        return sam_emb, sp

    def forward(self, batch: TrainBatch, dropout_seed: Optional[int] = None,
                remat: bool = False) -> LisaOutputs:
        """`dropout_seed` None is the deterministic forward; `remat`
        recomputes each LLaMA block (and each SAM encoder block, when the
        encoder is trained) in the backward. With MoE layers the outputs
        carry their load-balance terms' sum (`moe_aux`), which the loss
        leaves out, as JAX's `apply` does."""
        sam_emb, sp = self.splice_inputs(batch, remat)
        logits, hidden, _, aux = self.llm(
            sp.embeds, sp.positions, sp.segment_ids,
            dropout_seed=dropout_seed, remat=remat, with_aux=True)
        if self.cfg.decoder == "deepseek_v3":
            aux = None  # its fourth item is the routing, not a loss
        out = self.finish_outputs(batch, sam_emb, sp, logits, hidden)
        return out._replace(moe_aux=aux)

    def finish_outputs(self, batch: TrainBatch, sam_emb, sp: SplicedBatch,
                       logits, hidden) -> LisaOutputs:
        """[SEG] gather and projection, dual mask decode and canvas
        upsample, the loss stack (under a sharded batch, this rank's shares
        of the global losses: `core.mesh.batch_total`)."""
        cfg = self.cfg
        proj = self.project_seg(hidden)
        seg_emb, seg_valid = gather_seg_embeddings(
            proj, sp.seg_token_mask, max_segs=cfg.max_seg_tokens)
        masks_l, masks_r, _, _, taxonomy = self.decode_masks(sam_emb, seg_emb)
        S = cfg.sam_encoder.image_size
        pred_l = postprocess_masks_padded(masks_l, S)[:, 0]
        pred_r = postprocess_masks_padded(masks_r, S)[:, 0]

        sample_weight = batch.sample_weight.float()
        weight = sample_weight * seg_valid[:, 0].float()
        lm_labels = torch.where(sample_weight[:, None] > 0, sp.labels,
                                torch.full_like(sp.labels, -100))
        # Under a sharded batch each denominator is the global one, so the
        # losses are this rank's shares of the global losses.
        total = batch_total
        ce = L.language_model_loss(logits, lm_labels,
                                   total=total) * cfg.ce_loss_weight
        bce, dice = L.bimanual_mask_losses(
            pred_l, pred_r, batch.masks_left, batch.masks_right,
            batch.taxonomies, valid=batch.valid_region, sample_weight=weight,
            bce_weight=cfg.bce_loss_weight, dice_weight=cfg.dice_loss_weight,
            total=total)
        tax_ce = L.taxonomy_ce_loss(taxonomy, batch.taxonomies,
                                    sample_weight=weight,
                                    logit_ce=cfg.taxonomy_logit_ce,
                                    total=total)
        return LisaOutputs(
            loss=ce + bce + dice + tax_ce, ce_loss=ce, mask_bce_loss=bce,
            mask_dice_loss=dice, taxonomy_ce_loss=tax_ce,
            pred_masks_left=pred_l, pred_masks_right=pred_r,
            pred_taxonomies=taxonomy)


def _init_order(module, seen=None):
    """`module.modules()`, with each `OtherStage` place replaced by the
    layer it stands for (its `shadow`)."""
    seen = set() if seen is None else seen
    module = getattr(module, "shadow", module)
    if id(module) in seen:
        return
    seen.add(id(module))
    yield module
    for child in module.children():
        yield from _init_order(child, seen)


@torch.no_grad()
def init_random_(model: nn.Module, generator: torch.Generator) -> None:
    """Fill every parameter from `generator`: normal(0, fan_in^-1/2) for
    dense and convolution weights and the stacked MoE experts (fan-in: d
    for gate/up, f for down), zero biases, unit norms, normal(0, 0.02)
    for embeddings and position tables, normal(0, 1) for the SAM decoder's
    tokens and prompt embeddings; LoRA a he-uniform, b zero.

    Values are drawn on the generator's device in the module order of the
    whole model: for a layer another pipeline stage holds (an `OtherStage`
    with its meta `shadow`) they are drawn and dropped, and an MoE MLP
    holding experts [expert_start, +n) takes those rows of the whole
    draw, so a rank's part equals the whole model's."""

    def normal_(p, std, rows=None):
        shape = p.shape if rows is None else (rows[1],) + p.shape[1:]
        t = torch.randn(shape, generator=generator, device=generator.device,
                        dtype=torch.float32) * std
        if not p.is_meta:
            p.copy_(t if rows is None else t.narrow(0, rows[0], p.shape[0]))

    for mod in _init_order(model):
        if deepseek_v3.init_random_(mod, normal_):
            pass
        elif isinstance(mod, LoraDense):
            if mod.rank:
                mod.reset_lora_(generator)
        elif isinstance(mod, (LayerNorm, RMSNorm)):
            mod.weight.fill_(1.0)
            if getattr(mod, "bias", None) is not None:
                mod.bias.zero_()
        elif isinstance(mod, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
            normal_(mod.weight, 1.0 / math.sqrt(mod.weight[0].numel()))
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.Embedding):
            normal_(mod.weight, 0.02)
        elif isinstance(mod, MoEMLP):
            rows = (mod.expert_start, mod.cfg.moe_num_experts)
            for p in (mod.gate_proj, mod.up_proj, mod.down_proj):
                normal_(p, 1.0 / math.sqrt(p.shape[1]), rows)
        else:
            for name, p in mod.named_parameters(recurse=False):
                normal_(p, 1.0 if name in _UNIT_SCALE else 0.02)
