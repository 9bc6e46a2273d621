"""qwen1.5-0.5b — 24L d=1024 16H (GQA kv=16 == MHA) d_ff=2816 vocab=151936,
QKV bias. [hf:Qwen/Qwen1.5-0.5B; hf]
"""
from repro_torch.configs.base import ModelConfig, reduce

CONFIG = ModelConfig(
    name="qwen1.5-0.5b",
    family="dense",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=2816,
    vocab_size=151936,
    act="silu",
    qkv_bias=True,
    spec_mode="tree",
    source="hf:Qwen/Qwen1.5-0.5B",
)

REDUCED = reduce(CONFIG, num_kv_heads=4)
