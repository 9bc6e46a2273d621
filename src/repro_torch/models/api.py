"""Uniform model API (counterpart of ``repro.models.api``).

``get_model`` dispatches on the config's family: ``models.encdec`` for
the encoder-decoder, ``models.transformer`` for the decoder-only
families (dense, MoE, VLM, SSM and hybrid).  ``init_cache`` here is the
one cache factory the engine builds through, under every cache dtype and
layout of the reference.  A config with a ``tp_axis`` (the local config
of a tensor-parallel rank, ``distributed/tp.py``) is carried for the
dense family; for the others ``get_model`` raises ``ValueError``.
"""
from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec, transformer


def get_model(cfg: ModelConfig):
    transformer.check_supported(cfg)
    return encdec if cfg.family == "encdec" else transformer


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
