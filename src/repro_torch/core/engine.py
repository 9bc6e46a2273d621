"""Speculative decoding engine over a pluggable ``Proposer`` (counterpart
of ``repro.core.engine``, greedy acceptance).

``SpecEngine`` runs the paper's static speculation step: candidates from
the proposer -> one backbone verification forward -> tensorized greedy
acceptance -> zero-copy commit.  Where the reference runs the generation
loop as one ``lax.while_loop``, this engine runs a host Python loop over
one fixed-shape step; the only device->host read per step is the loop's
exit test.

``ar_generate`` is the greedy autoregressive baseline on the same cache
machinery (T=1 decode): the losslessness oracle (greedy spec == greedy AR,
token for token).  Given a config with ``verify_fusion`` and
``use_kernel``, its decode steps take the fused write side too.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import verify as V
from repro_torch.core.proposers import MedusaProposer, Proposer
from repro_torch.core.tree import TreeBuffers
from repro_torch.kernels import ops as KO
from repro_torch.models import api as model_api
from repro_torch.models.api import get_model
from repro_torch.models.transformer import PAGES_KEY
from repro_torch.runtime import resolve_device


class StepStats(NamedTuple):
    tokens_out: torch.Tensor     # [B] int32 tokens generated (incl. bonus)
    steps: int                   # decode steps taken
    accepted_sum: torch.Tensor   # scalar int — sum of per-step acc, each
                                 # clamped to the remaining max_new budget
                                 # and excluding the final bonus token, so
                                 # accepted_sum / (steps * B) is the
                                 # unbiased mean accepted length
    accepted_per_slot: torch.Tensor  # [B] the same clamped acc, per row


class SpecEngine:
    """Greedy speculative engine for one (config, proposer) pair on one
    device.

    ``proposer`` selects the draft policy; passing a ``TreeBuffers`` as
    ``tb`` (or nothing) builds a ``MedusaProposer`` on that tree.
    ``use_kernel`` routes decode attention through
    ``kernels.ops.tree_attention`` (the ``flash_decode`` kernel on the
    card).  ``verify_fusion`` (default: ``cfg.verify_fusion``) verifies
    from the ``unembed_verify_stats`` kernel's statistics instead of the
    [B, T, V] logits, and with ``use_kernel`` also runs each layer's write
    side as one ``fused_qkv_rope_commit`` launch.  ``device`` defaults to
    the card and raises if there is none.
    """

    def __init__(self, cfg: ModelConfig, tb: Optional[TreeBuffers] = None,
                 use_kernel: bool = False,
                 proposer: Optional[Proposer] = None, device="cuda",
                 verify_fusion: Optional[bool] = None):
        if proposer is not None and tb is not None:
            raise ValueError("pass either tb (Medusa tree) or proposer, "
                             "not both")
        self.device = resolve_device(device)
        # resolve the fusion knob into the config itself: the model's decode
        # path gates the fused write side on ``cfg.verify_fusion``, so an
        # engine-level override must be visible there (and to
        # ``ar_generate(engine.cfg, ...)``)
        if verify_fusion is not None and verify_fusion != cfg.verify_fusion:
            cfg = dataclasses.replace(cfg, verify_fusion=verify_fusion)
        self.cfg = cfg
        self.model = get_model(cfg)
        self.proposer = proposer if proposer is not None \
            else MedusaProposer(cfg, self.device, tb)
        self.tb = self.proposer.tb
        if cfg.spec_mode == "chain" and not self.tb.is_chain:
            raise ValueError(f"{cfg.name}: chain-mode archs verify "
                             "single-path candidates; pass a chain_tree()")
        self.dtree = self.proposer.dtree
        self.use_kernel = use_kernel

    def init_cache(self, batch: int, max_len: int):
        """Decode cache for ``batch`` slots on the engine's device in the
        config's cache dtype and layout (paged: the identity table)."""
        return model_api.init_cache(self.cfg, batch, max_len,
                                    device=self.device)

    def init_proposer_state(self, batch: int, capacity: int):
        return self.proposer.init_state(batch, capacity)

    def prefill(self, params, proposer_params, tokens, lengths, cache,
                state=None):
        """-> (cache, lengths, base_token [B], proposer state)."""
        B, Sp = tokens.shape
        last_hidden, cache = self.model.prefill(params, self.cfg, tokens,
                                                lengths, cache)
        logits = self.model.unembed(params, self.cfg, last_hidden)
        base = torch.argmax(logits, dim=-1).to(torch.int32)
        if state is None:
            state = self.init_proposer_state(B, Sp + self.dtree.T + 2)
        state = self.proposer.prime(proposer_params, state, tokens, lengths,
                                    last_hidden, base)
        return cache, lengths, base, state

    def spec_step(self, params, proposer_params, cache, lengths, base, state):
        """One static speculative step: propose -> one target forward ->
        verify -> commit -> observe.  Returns (cache, lengths, verdict,
        state')."""
        dt = self.dtree
        cand, _, state = self.proposer.propose(proposer_params, state, base)
        hidden, spec_cache = self.model.decode(
            params, self.cfg, cache, cand, lengths, dt.mask, dt.depths,
            use_kernel=self.use_kernel)
        if self.cfg.verify_fusion:
            verdict = self._verify_fused(params, cand, hidden)
        else:
            logits = self.model.unembed(params, self.cfg, hidden)  # [B,T,V]
            verdict = V.greedy_verify(cand, logits, dt)
        cache, lengths = self.model.commit(self.cfg, spec_cache, lengths,
                                           verdict.path_slots, verdict.acc)
        rows = torch.arange(hidden.shape[0], device=hidden.device)
        h_last = hidden[rows, verdict.last_slot]                  # [B, d]
        state = self.proposer.observe(proposer_params, state, verdict,
                                      h_last, lengths)
        return cache, lengths, verdict, state

    def _verify_fused(self, params, cand, hidden):
        """Fused-epilogue greedy acceptance: the ``unembed_verify_stats``
        kernel streams the lm-head product over vocabulary tiles and hands
        back Verdict-sized statistics; the [B, T, V] logits are never
        made.  The Verdict is bit-identical to ``greedy_verify``'s."""
        tmax = torch.ones((cand.shape[0],), dtype=torch.float32,
                          device=hidden.device)       # greedy: raw logits
        stats = V.VerifyStats(*KO.verify_stats(hidden, params["lm_head"],
                                               cand, tmax))
        return V.greedy_verify_stats(cand, stats, self.dtree)

    def generate(self, params, proposer_params, tokens, prompt_lengths, cache,
                 max_new: int, state=None):
        """Full speculative generation loop.

        tokens [B, S_p] int32 right-padded prompts, prompt_lengths [B]
        int32, cache from ``init_cache``, all on the engine's device.
        Returns (out_tokens [B, max_new] int32, n_out [B] int32 true
        lengths, StepStats)."""
        dt = self.dtree
        B, Sp = tokens.shape
        K1 = dt.K + 1
        buf_len = max_new + K1 + 1
        dev = tokens.device
        if state is None:
            state = self.init_proposer_state(B, Sp + max_new + dt.T + 2)
        cache, lengths, base, state = self.prefill(
            params, proposer_params, tokens, prompt_lengths, cache,
            state=state)
        out = torch.zeros((B, buf_len), dtype=torch.int32, device=dev)
        rows = torch.arange(B, device=dev)[:, None]
        cols = torch.arange(K1, device=dev)[None, :]

        def write_out(toks, n_out):
            start = torch.clamp(n_out, max=buf_len - K1).long()[:, None]
            out[rows, start + cols] = toks.to(torch.int32)

        n_out = torch.zeros((B,), dtype=torch.int32, device=dev)
        acc_sum = torch.zeros((), dtype=torch.int64, device=dev)
        acc_slot = torch.zeros((B,), dtype=torch.int32, device=dev)
        steps = 0
        # host-driven loop (max_new bounds it: every step commits >= 1
        # token per row); the exit test is the one host read per step
        while steps < max_new and bool(torch.any(n_out < max_new)):  # speclint: disable=trace-safety
            cache, lengths, verdict, state = self.spec_step(
                params, proposer_params, cache, lengths, base, state)
            write_out(verdict.path_tokens, n_out)
            acc_row = torch.minimum(verdict.acc,
                                    torch.clamp(max_new - n_out, min=0))
            acc_sum += acc_row.sum()
            acc_slot += acc_row
            n_out = n_out + verdict.acc
            base = verdict.next_token
            steps += 1
        # final certain token
        write_out(base[:, None].expand(B, K1), n_out)
        n_out = n_out + 1
        stats = StepStats(tokens_out=n_out, steps=steps, accepted_sum=acc_sum,
                          accepted_per_slot=acc_slot)
        return out[:, :max_new], torch.clamp(n_out, max=max_new), stats


def build_engine(cfg: ModelConfig, proposer: str = "medusa", *,
                 use_kernel: bool = False, device="cuda",
                 verify_fusion: Optional[bool] = None) -> SpecEngine:
    """Engine construction shared by the launcher and the tests.  The
    port carries the Medusa proposer only."""
    if proposer != "medusa":
        raise NotImplementedError(f"proposer {proposer!r}: draft-model and "
                                  "n-gram proposers are ROADMAP queue 1 "
                                  "item 12")
    dev = resolve_device(device)
    return SpecEngine(cfg, use_kernel=use_kernel,
                      proposer=MedusaProposer(cfg, dev), device=dev,
                      verify_fusion=verify_fusion)


def ar_step(cfg: ModelConfig, params, cache, tok, lengths,
            use_kernel: bool = False):
    """One greedy AR decode step (T=1): writes ``tok`` [B] at ``lengths``
    and returns (logits [B, V] for the next token, cache, lengths + 1)."""
    model = get_model(cfg)
    dev = tok.device
    chain1 = torch.ones((1, 1), dtype=torch.bool, device=dev)
    depth0 = torch.zeros((1,), dtype=torch.int32, device=dev)
    hidden, spec_cache = model.decode(params, cfg, cache, tok[:, None],
                                      lengths, chain1, depth0,
                                      use_kernel=use_kernel)
    # T=1: the written row is already in place; no compaction needed
    return (model.unembed(params, cfg, hidden[:, 0]),
            _squeeze_spec(spec_cache), lengths + 1)


def ar_generate(cfg: ModelConfig, params, tokens, prompt_lengths, cache,
                max_new: int, use_kernel: bool = False, observe=None):
    """Greedy autoregressive baseline on the same cache machinery (T=1).

    tokens [B, S_p] int32, prompt_lengths [B] int32, cache from
    ``init_cache``.  ``use_kernel`` routes decode attention through the
    ``flash_decode`` kernel as the speculative engine does.  ``observe``,
    if given, is called as ``observe(i, logits)`` with the [B, V] logits
    whose argmax is output token ``i`` (``chip_smoke.py`` reads the
    near-tie margins there).  Returns (out [B, max_new] int32, lengths [B]
    final cache lengths)."""
    model = get_model(cfg)
    B = tokens.shape[0]
    last_hidden, cache = model.prefill(params, cfg, tokens, prompt_lengths,
                                       cache)
    logits = model.unembed(params, cfg, last_hidden)
    out = torch.zeros((B, max_new), dtype=torch.int32, device=tokens.device)
    lengths = prompt_lengths
    for i in range(max_new):
        if observe is not None:
            observe(i, logits)
        out[:, i] = torch.argmax(logits, dim=-1).to(torch.int32)
        logits, cache, lengths = ar_step(cfg, params, cache, out[:, i],
                                         lengths, use_kernel)
    return out, lengths


def _squeeze_spec(spec_cache):
    """Drop the in-flight ``*_new`` rows of a T=1 spec cache, keeping the
    persistent leaves (k/v and, under int8, k_scale/v_scale) and the paged
    layout's ``_pages`` block table."""
    return {pos: entry if pos == PAGES_KEY else
            {n: x for n, x in entry.items() if not n.endswith("_new")}
            for pos, entry in spec_cache.items()}
