"""Medusa multi-head prediction (paper §3.1) in PyTorch; counterpart of
``repro.core.medusa``.

K parallel heads on the backbone's final hidden state.  Each head k is a
residual SiLU block (zero-initialised, so heads start as the identity)
followed by its own vocabulary projection, predicting the token at
t + k + 1.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.runtime import torch_dtype


def init_medusa(gen: torch.Generator, cfg: ModelConfig, K: int,
                base_lm_head=None, dtype=None):
    """Stacked params for K heads on ``gen.device``.  ``base_lm_head``
    [d, V] seeds the vocab projections (Medusa's init recipe: copy the
    backbone's lm head); otherwise they are drawn from ``gen``."""
    d, V = cfg.d_model, cfg.vocab_size
    dt = torch_dtype(dtype or cfg.param_dtype)
    dev = gen.device
    if base_lm_head is not None:
        lm = base_lm_head.to(dt)[None].expand(K, d, V).clone()
    else:
        lm = torch.empty((K, d, V), dtype=dt, device=dev)
        lm.normal_(generator=gen).div_(math.sqrt(d))
    return {
        # zero init => resblock starts as identity
        "w1": torch.zeros((K, d, d), dtype=dt, device=dev),
        "b1": torch.zeros((K, d), dtype=dt, device=dev),
        "lm": lm,
    }


def medusa_hidden(mp, hidden):
    """hidden [..., d] -> per-head hidden [K, ..., d] (residual SiLU block)."""
    h = torch.einsum("...d,kde->k...e", hidden, mp["w1"].to(hidden.dtype))
    b1 = mp["b1"].to(hidden.dtype)
    b1 = b1.reshape(b1.shape[:1] + (1,) * (hidden.dim() - 1) + b1.shape[1:])
    return hidden[None] + F.silu(h + b1)


def medusa_logits(mp, hidden):
    """hidden [..., d] -> logits [K, ..., V]."""
    hk = medusa_hidden(mp, hidden)
    return torch.einsum("k...d,kdv->k...v", hk, mp["lm"].to(hidden.dtype))


def medusa_topk(mp, hidden, max_topk: int):
    """-> (tokens [K, ..., max_topk] int32, probs same shape float32)."""
    logits = medusa_logits(mp, hidden).float()
    _, idx = torch.topk(logits, max_topk, dim=-1)
    probs = torch.softmax(logits, dim=-1)
    pvals = torch.gather(probs, -1, idx)
    return idx.to(torch.int32), pvals
