"""Uniform model API (counterpart of ``repro.models.api``).

``init_cache`` here is the one cache factory the engine builds through.
The port carries the decoder-only stack of the dense, MoE, VLM, SSM and
hybrid families, under every cache dtype and layout of the reference;
the encoder-decoder and tensor parallelism raise
``NotImplementedError`` naming their later slice.
"""
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer


def get_model(cfg: ModelConfig):
    transformer.check_supported(cfg)
    return transformer


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, n_blocks=None,
               device="cuda"):
    """Decode cache for ``batch`` slots of ``max_len`` tokens on ``device``
    (the card unless the caller asks for ``"cpu"``), honouring
    ``cfg.cache_dtype`` (int8 adds scale leaves) and ``cfg.cache_layout``
    (``n_blocks`` sizes the paged pool, whose tables then start all-zero
    for an allocator to fill; None means the allocator-free identity
    table)."""
    return get_model(cfg).init_cache(cfg, batch, max_len, device=device,
                                     n_blocks=n_blocks)
