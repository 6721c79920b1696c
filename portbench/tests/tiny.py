"""Tiny configurations and cells for the CPU tests: the port's `tiny`
preset's widths in the benchmark's configuration format, float32."""

import copy

from portbench import registry

TINY_SAM = {
    "encoder": {"image_size": 128, "patch_size": 16, "embed_dim": 32,
                "depth": 2, "num_heads": 2, "mlp_ratio": 4.0,
                "out_chans": 32, "window_size": 4, "global_attn_indexes": [1]},
    "decoder": {"prompt_embed_dim": 32, "num_multimask_outputs": 3,
                "transformer_depth": 2, "transformer_mlp_dim": 64,
                "transformer_num_heads": 2, "attention_downsample_rate": 2,
                "iou_head_depth": 3, "iou_head_hidden_dim": 32,
                "taxonomy_classes": 4, "mask_in_chans": 4},
}


def lisa_cfg():
    cfg = copy.deepcopy(registry.config("lisa_mpt7b"))
    cfg["dtype"] = "float32"
    cfg["mpt"].update(d_model=64, n_heads=4, n_layers=2, vocab_size=512,
                      max_seq_len=128)
    cfg["clip"].update(image_size=32, patch_size=8, hidden_size=32,
                       intermediate_size=64, num_hidden_layers=2,
                       num_attention_heads=2)
    cfg["sam"] = copy.deepcopy(TINY_SAM)
    cfg["lisa"].update(out_dim=32, max_text_len=320, max_new_tokens=6)
    return cfg


def cell(name, **over):
    c = copy.deepcopy(registry.workload(name))
    c["traffic"].update(frames=2, height=48, width=80)
    c["check_requests"] = 2
    c.update(over)
    return c
