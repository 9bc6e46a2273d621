"""internvl2-26b — InternViT frontend (stub) + InternLM2-20B backbone.
48L d=6144 48H (GQA kv=8) d_ff=16384 vocab=92553. [arXiv:2404.16821; hf]

The config specifies the transformer BACKBONE only; the InternViT modality
frontend is a STUB: ``models/frontends.py`` provides stand-in patch
embeddings (256 tokens after pixel-shuffle, as in the paper).
"""
from repro_torch.configs.base import ModelConfig, reduce

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="vlm",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=92553,
    act="silu",
    frontend="vit",
    frontend_len=256,
    frontend_dim=6144,
    spec_mode="tree",
    source="arXiv:2404.16821",
)

REDUCED = reduce(CONFIG)
