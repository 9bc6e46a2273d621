"""Classic two-model speculative decoding (Leviathan/Chen 2023; paper
§2.2), counterpart of ``repro.core.draft_model``.

``proposers.DraftModelProposer`` drafts the γ-token chain and the generic
``engine.SpecEngine`` verifies and commits it.  ``DraftSpecEngine`` is the
thin two-cache shell with the reference's call shape: ``init_caches``
gives the target's and the draft's caches, and ``generate(tparams,
dparams, ..., tcache, dcache, ...)`` runs one ``SpecEngine.generate``
with the draft cache as the proposer state.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig, SamplingParams
from repro_torch.core.engine import SpecEngine
from repro_torch.core.proposers import DraftModelProposer, draft_config
from repro_torch.models import api as model_api
from repro_torch.runtime import resolve_device


class DraftSpecEngine:
    """``accept="greedy"`` verifies by argmax match (lossless against
    greedy AR); ``accept="sample"`` makes the draft sample its chain under
    ``sampling`` and verifies by chain rejection sampling, which keeps the
    warped target distribution exactly.  At ``sampling.temperature <= 0``
    the sample mode is token-identical to greedy.  ``use_kernel``,
    ``verify_fusion``, ``device``, ``graphs``, ``seed`` and ``deferred``
    are ``SpecEngine``'s; the draft decodes on the engine's kernel path
    and write side (``proposers.draft_config``)."""

    def __init__(self, target_cfg: ModelConfig, draft_cfg: ModelConfig,
                 gamma: int = 4, accept: str = "greedy",
                 sampling: Optional[SamplingParams] = None,
                 use_kernel: bool = False, device="cuda",
                 verify_fusion: Optional[bool] = None, graphs: bool = True,
                 seed: int = 0, deferred: bool = False):
        if accept not in ("greedy", "sample"):
            raise ValueError(f"accept must be greedy | sample, got "
                             f"{accept!r}")
        dev = resolve_device(device)
        if verify_fusion is not None:
            target_cfg = dataclasses.replace(target_cfg,
                                             verify_fusion=verify_fusion)
        self.gamma = gamma
        self.engine = SpecEngine(
            target_cfg, use_kernel=use_kernel, accept=accept,
            sampling=sampling, device=dev, graphs=graphs, seed=seed,
            deferred=deferred,
            proposer=DraftModelProposer(
                target_cfg, draft_config(target_cfg, draft_cfg), gamma=gamma,
                device=dev, use_kernel=use_kernel))
        self.proposer = self.engine.proposer
        # the proposer keeps the draft's cache dense: its config is the one
        # init_caches builds the draft cache from
        self.tc, self.dc = self.engine.cfg, self.proposer.dc
        self.tb, self.dtree = self.engine.tb, self.engine.dtree
        self.accept = accept
        self.sampling = self.engine.sampling

    def init_caches(self, batch: int, max_len: int):
        """(target cache, draft cache) for ``batch`` rows on the engine's
        device, each in its own config's cache dtype and layout."""
        return (self.engine.init_cache(batch, max_len),
                model_api.init_cache(self.dc, batch, max_len,
                                     device=self.engine.device))

    def generate(self, tparams, dparams, tokens, prompt_lengths, tcache,
                 dcache, max_new: int, extra_embeds=None):
        """The draft cache ``dcache`` becomes the proposer state of one
        ``SpecEngine.generate`` run (``extra_embeds``: a VLM's prefix,
        which the target and the draft both prefill).  Returns (out
        [B, max_new] int32, n_out [B] int32, steps)."""
        B = tokens.shape[0]
        state = {"cache": dcache,
                 "len": torch.zeros((B,), dtype=torch.int32,
                                    device=tokens.device)}
        out, n_out, stats = self.engine.generate(
            tparams, dparams, tokens, prompt_lengths, tcache, max_new,
            extra_embeds=extra_embeds, state=state)
        return out, n_out, stats.steps
