"""whisper-tiny — encoder-decoder, conv frontend (stub), 4L d=384 6H
d_ff=1536 vocab=51865. [arXiv:2212.04356; unverified]

The conv frontend is a stub: ``models/frontends.py`` provides the
precomputed frame embeddings (1500 frames after the conv downsampling).
Whisper uses LayerNorm, learned positions, plain GELU MLPs and biased QKV.
Decode runs on the decoder (4 layers), which cross-attends to the
encoder's output (4 layers over the frames).
"""
from repro_torch.configs.base import ModelConfig, reduce

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="encdec",
    num_layers=4,              # decoder layers
    encoder_layers=4,
    cross_attention=True,
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    head_dim=64,
    d_ff=1536,
    vocab_size=51865,
    act="gelu",
    gated_mlp=False,
    norm="layernorm",
    qkv_bias=True,
    use_rope=False,
    frontend="conv_audio",
    frontend_len=1500,
    frontend_dim=384,
    max_position=33024,       # learned decoder positions: a 32k cache + tree
    spec_mode="tree",
    source="arXiv:2212.04356",
)

REDUCED = reduce(CONFIG, frontend_len=16)
