"""granite-moe-1b-a400m — 24L d=1024 16H (GQA kv=8) d_ff=512/expert, MoE 32e top-8.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]
"""
from repro_torch.configs.base import ModelConfig, reduce

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab_size=49155,
    num_experts=32,
    experts_per_tok=8,
    act="silu",
    spec_mode="tree",
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
)

REDUCED = reduce(CONFIG, num_experts=8, experts_per_tok=4)
