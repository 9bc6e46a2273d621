"""Modality frontend stubs (counterpart of ``repro.models.frontends``).

A VLM or audio config specifies the transformer backbone only; these
helpers stand in for the vision or audio encoder by providing its
output, precomputed prefix embeddings [B, frontend_len, frontend_dim],
which the model projects with ``frontend_proj`` and prepends to the
token embeddings (``transformer.frontend_prefix``)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.runtime import resolve_device, torch_dtype


def frontend_shape(cfg: ModelConfig, batch: int):
    if not cfg.frontend:
        return None
    return (batch, cfg.frontend_len, cfg.frontend_dim or cfg.d_model)


def frontend_spec(cfg: ModelConfig, batch: int, device="meta"):
    """The frontend's output as a shape without storage (the reference's
    ``ShapeDtypeStruct``): an empty bf16 tensor of ``frontend_shape(cfg,
    batch)`` on ``device`` (the meta device; under a ``FakeTensorMode``
    a fake tensor), or None for a config without a frontend."""
    shape = frontend_shape(cfg, batch)
    return None if shape is None else torch.empty(shape,
                                                  dtype=torch.bfloat16,
                                                  device=device)


def frontend_embeds(cfg: ModelConfig, batch: int,
                    generator: Optional[torch.Generator] = None):
    """Random stand-in embeddings (what a real ViT or conv stack would
    emit): Normal(0, 1) * 0.02 in ``cfg.dtype``, drawn from ``generator``
    on its device (default: one seeded with 0 on the card, which raises
    without one).  None for a config without a frontend."""
    shape = frontend_shape(cfg, batch)
    if shape is None:
        return None
    if generator is None:
        generator = torch.Generator(
            device=resolve_device("cuda")).manual_seed(0)
    x = torch.randn(shape, generator=generator, dtype=torch_dtype(cfg.dtype),
                    device=generator.device)
    return x * 0.02
