"""jamba-1.5-large-398b — hybrid Mamba+attention 1:7 interleave, MoE 16e
top-2 every other layer. 72L d=8192 64H (GQA kv=8) d_ff=24576
vocab=65536. [arXiv:2403.19887; hf]

The Mamba sublayers gate the stack, so speculation runs in CHAIN mode;
the attention sublayers take the same (causal) chain mask through the
generic tree-mask path.

``ONE_UNIT`` is the full-width model cut to one 4-position unit (the
unit layout of ``REDUCED``: SSM + dense, attention + MoE, SSM + dense,
SSM + MoE), the depth one 80 GB card holds in bf16: an 8-position
period alone carries four MoE layers, ~77 GB.
"""
import dataclasses

from repro_torch.configs.base import ModelConfig, reduce

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    num_experts=16,
    experts_per_tok=2,
    moe_every=2,
    moe_offset=1,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_conv=4,
    ssm_expand=2,
    hybrid_period=8,
    attn_index=3,
    act="silu",
    spec_mode="chain",
    full_attention=False,
    source="arXiv:2403.19887",
)

REDUCED = reduce(
    CONFIG, num_layers=4, hybrid_period=4, attn_index=1,
    d_model=64, ssm_head_dim=16, ssm_state=16, num_experts=4, experts_per_tok=2,
)

ONE_UNIT = dataclasses.replace(CONFIG, num_layers=4, hybrid_period=4,
                               attn_index=1,
                               name="jamba-1.5-large-398b-1unit")
