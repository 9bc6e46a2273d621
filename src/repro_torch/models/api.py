"""Uniform model API (counterpart of ``repro.models.api``).

``init_cache`` here is the one cache factory the engine builds through.
The port's first slice carries the dense decoder only; every other family
and cache layout raises ``NotImplementedError`` naming its later slice.
"""
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer


def get_model(cfg: ModelConfig):
    transformer.check_supported(cfg)
    return transformer


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device="cuda"):
    """Decode cache for ``batch`` slots of ``max_len`` tokens on ``device``
    (the card unless the caller asks for ``"cpu"``)."""
    return get_model(cfg).init_cache(cfg, batch, max_len, device=device)
