"""qwen1.5-4b — 40L d=2560 20H (GQA kv=20 == MHA) d_ff=6912 vocab=151936,
QKV bias. [hf:Qwen/Qwen1.5-4B; hf]
"""
from repro_torch.configs.base import ModelConfig, reduce

CONFIG = ModelConfig(
    name="qwen1.5-4b",
    family="dense",
    num_layers=40,
    d_model=2560,
    num_heads=20,
    num_kv_heads=20,
    head_dim=128,
    d_ff=6912,
    vocab_size=151936,
    act="silu",
    qkv_bias=True,
    spec_mode="tree",
    source="hf:Qwen/Qwen1.5-4B",
)

REDUCED = reduce(CONFIG, num_kv_heads=4)
