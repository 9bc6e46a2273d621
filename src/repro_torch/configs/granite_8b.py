"""granite-8b — llama-arch code model. 36L d=4096 32H (GQA kv=8) d_ff=14336
vocab=49152. [arXiv:2405.04324; hf]
"""
from repro_torch.configs.base import ModelConfig, reduce

CONFIG = ModelConfig(
    name="granite-8b",
    family="dense",
    num_layers=36,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=49152,
    act="silu",
    spec_mode="tree",
    source="arXiv:2405.04324",
)

REDUCED = reduce(CONFIG)
