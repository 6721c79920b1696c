"""Tiny configurations and cells of the lisa_rows driver for the CPU
tests: the Moonlight configuration at the port's `tiny` deepseek_v3
widths (3 layers, the first dense, 8 experts top-2 with 1 shared), and
the batch-8 MPT cell at tiny.py's widths, float32."""

import copy

from portbench import registry
from portbench.tests import tiny


def moonlight_cfg():
    cfg = copy.deepcopy(registry.config("lisa_moonlight16b"))
    cfg["dtype"] = "float32"
    cfg.update(vocab_size=512, hidden_size=64, intermediate_size=128,
               moe_intermediate_size=32, num_hidden_layers=3,
               num_attention_heads=4, num_key_value_heads=4,
               kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
               v_head_dim=16, n_routed_experts=8, num_experts_per_tok=2,
               n_shared_experts=1, max_position_embeddings=1024)
    lisa_mpt = tiny.lisa_cfg()
    cfg["clip"], cfg["sam"] = lisa_mpt["clip"], lisa_mpt["sam"]
    cfg["lisa"].update(out_dim=32, max_text_len=320)  # 32 new tokens, as stated
    return cfg


CELLS = {"lisa_moonlight16b.robot_b1": moonlight_cfg,
         "lisa_mpt7b.label_b8": tiny.lisa_cfg}


def cell(name, **over):
    c = tiny.cell(name, **over)
    if c["traffic"].get("batch", 1) > 1:
        c["traffic"]["batch"] = 2
        c["check_requests"] = 1
    return c
