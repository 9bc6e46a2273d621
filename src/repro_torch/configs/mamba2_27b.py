"""mamba2-2.7b — attention-free SSD (state-space duality). 64L d=2560
vocab=50280, ssm_state=128. [arXiv:2405.21060; unverified]

Static tree attention cannot branch an SSM recurrence, so this arch
speculates in CHAIN mode: a tree degenerated to one path, verified in
one decode over the chain's tokens.
"""
from repro_torch.configs.base import ModelConfig, reduce

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    num_layers=64,
    d_model=2560,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_conv=4,
    ssm_expand=2,
    norm="rmsnorm",
    spec_mode="chain",
    full_attention=False,
    source="arXiv:2405.21060",
)

REDUCED = reduce(CONFIG, d_model=64, ssm_head_dim=16, ssm_state=16)
