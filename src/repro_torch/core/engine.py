"""Speculative decoding engine over a pluggable ``Proposer`` (counterpart
of ``repro.core.engine``).

``SpecEngine`` runs the paper's static speculation step: candidates from
the proposer -> one backbone verification forward -> tensorized
acceptance (greedy, typical or lossless sampling, ``core/verify.py``) ->
zero-copy commit.  Where the reference runs the generation
loop as one compiled ``lax.while_loop``, this engine keeps the loop's
carry in static buffers (``SpecCarry``) and runs the loop body as one
CUDA graph on the card (``runtime.StepGraph``): captured once per step
shape and replayed every step.  The host's only work per step is the
replay and the loop's exit test, its one device->host read.  Prefill runs
eagerly.  On the CPU, or with ``graphs=False``, the same body runs
eagerly.

``ar_generate`` is the greedy autoregressive baseline on the same cache
machinery (T=1 decode), its step captured the same way: the losslessness
oracle (greedy spec == greedy AR, token for token).  Given a config with
``verify_fusion`` and ``use_kernel``, its decode steps take the fused
write side too.  ``ar_generate_sampled`` is its stochastic sibling, the
distribution-equality oracle for ``accept="sample"``.

Randomness comes from a ``torch.Generator`` on the engine's device (the
engine's own, seeded by ``seed``; ``ar_generate_sampled`` takes one).  A
captured step registers it with its graph, so every replay draws fresh
noise, the noise the same step run eagerly from the same generator state
draws.  The per-row temperature and top-p live in the loop's carry as
[B] device tensors, so a new value replays the same graph.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import NamedTuple, Optional, Union

import torch

from repro_torch.configs.base import ModelConfig, SamplingParams
from repro_torch.core import sampling as S
from repro_torch.core import verify as V
from repro_torch.core.proposers import (MedusaProposer, Proposer,
                                       draft_config, make_proposer)
from repro_torch.core.tree import TreeBuffers, chain_tree
from repro_torch.distributed import collectives as C
from repro_torch.kernels import ops as KO
from repro_torch.kernels import paging as P
from repro_torch.models import api as model_api
from repro_torch.models.api import get_model
from repro_torch.models.transformer import (CROSS_KEY, PAGES_KEY,
                                             cache_max_len, is_attn_entry)
from repro_torch.runtime import (StepGraphs, binding, copy_tree_,
                                 resolve_device, torch_dtype, tree_map,
                                 tree_spec)


class StepStats(NamedTuple):
    tokens_out: torch.Tensor     # [B] int32 tokens generated (incl. bonus)
    steps: int                   # decode steps taken
    accepted_sum: torch.Tensor   # scalar int — sum of per-step acc, each
                                 # clamped to the remaining max_new budget
                                 # and excluding the final bonus token, so
                                 # accepted_sum / (steps * B) is the
                                 # unbiased mean accepted length
    accepted_per_slot: torch.Tensor  # [B] the same clamped acc, per row


class Draws(NamedTuple):
    """One speculative step's noise (``core.sampling``: randomness is an
    argument), drawn from the engine's generator or passed in."""
    u: Optional[torch.Tensor]    # f32 acceptance uniforms (accept=
                                 # "sample"): [B, max(K, 1), Cmax] for the
                                 # tree walk, [B, K] for the chain walk
    g: torch.Tensor              # [B, V] f32 Gumbel noise of the step's
                                 # final draw


@dataclasses.dataclass
class SpecCarry:
    """The speculative loop's carry (the reference's ``while_loop``
    carry) in static buffers: the step reads and writes them in place, so
    a captured step replays on them.  ``cache`` holds the caller's cache
    tensors, written in place by every step."""
    cache: dict
    lengths: torch.Tensor        # [B] int32 committed rows
    base: torch.Tensor           # [B] int32 the next certain token
    state: dict                  # the proposer's state (nested dicts)
    out: torch.Tensor            # [B, max_new + K + 2] int32
    n_out: torch.Tensor          # [B] int32 tokens written so far
    acc_sum: torch.Tensor        # () int64, as StepStats.accepted_sum
    acc_slot: torch.Tensor       # [B] int32, as StepStats.accepted_per_slot
    temperature: torch.Tensor    # [B] f32 per-row warp temperature
    top_p: torch.Tensor          # [B] f32 per-row nucleus mass

    def load(self, lengths, base, state, temperature=1.0, top_p=1.0):
        """Start a loop from a prefill's (lengths, base, state), at the
        given per-row (or scalar) temperature and top-p."""
        self.lengths.copy_(lengths)
        self.base.copy_(base)
        copy_tree_(self.state, state)
        for t in (self.out, self.n_out, self.acc_sum, self.acc_slot):
            t.zero_()
        B, dev = self.base.shape[0], self.base.device
        self.temperature.copy_(S.per_row(temperature, B, dev))
        self.top_p.copy_(S.per_row(top_p, B, dev))


class SpecEngine:
    """Speculative engine for one (config, proposer) pair on one device.

    ``proposer`` selects the draft policy; passing a ``TreeBuffers`` as
    ``tb`` (or nothing) builds a ``MedusaProposer`` on that tree.
    ``accept`` selects verification: "greedy" (lossless argmax match),
    "typical" (Medusa's lossy typical acceptance at ``temperature``) or
    "sample" (lossless rejection sampling under ``sampling``, whose
    temperature defaults to ``temperature``: the tree walk for a proposer
    whose ``q_kind`` is "mprob", the chain walk for "logits").  At
    ``sampling.temperature <= 0`` the "sample" mode is token-identical to
    "greedy".  ``seed``
    seeds the engine's ``generator`` (on its device), which every draw of
    the non-greedy modes comes from.
    ``use_kernel`` routes decode attention through
    ``kernels.ops.tree_attention`` (the ``flash_decode`` kernel on the
    card).  ``verify_fusion`` (default: ``cfg.verify_fusion``) verifies
    from the ``unembed_verify_stats`` kernel's statistics instead of the
    [B, T, V] logits, and with ``use_kernel`` also runs each layer's write
    side as one ``fused_qkv_rope_commit`` launch.  ``deferred`` skips the
    per-step tree-row cache write: decode attends over the committed cache
    (its columns below the lengths) merged with the in-flight rows, and
    commit is the step's only cache write; it takes the unfused write side
    (no ``fused_qkv_rope_commit``), as in the reference, and is forced off
    for the encoder-decoder, as there.  ``device``
    defaults to the card and raises if there is none.  ``graphs``
    (default True) replays ``generate``'s step as a CUDA graph on the
    card; False runs the same step eagerly (to compare the two).  The engine keeps its
    graphs, one per step shape, in ``step_graphs``, and drops them with
    itself.  Verify fusion refuses ``accept="typical"`` (it needs full-row
    entropies) and a truncating warp (top_k or top_p < 1 need the sorted
    row); neither falls back to the unfused path.
    """

    def __init__(self, cfg: ModelConfig, tb: Optional[TreeBuffers] = None,
                 use_kernel: bool = False, accept: str = "greedy",
                 temperature: float = 0.7,
                 sampling: Optional[SamplingParams] = None,
                 proposer: Optional[Proposer] = None, device="cuda",
                 verify_fusion: Optional[bool] = None, graphs: bool = True,
                 seed: int = 0, deferred: bool = False):
        if accept not in ("greedy", "typical", "sample"):
            raise ValueError(f"unknown accept mode {accept!r}")
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
        # the encoder-decoder keeps the write-then-attend step (the
        # reference's rule): its decode ignores ``deferred``
        self.deferred = deferred and cfg.family != "encdec"
        self.accept = accept
        self.temperature = temperature
        self.sampling = sampling if sampling is not None else \
            SamplingParams(temperature=temperature)
        sp = self.sampling
        if cfg.verify_fusion:
            # the fused epilogue carries Verdict-sized statistics only:
            # typical acceptance needs full-row entropies and a top-k /
            # top-p warp the sorted row, so both stay unfused
            if accept == "typical":
                raise ValueError("verify_fusion does not support "
                                 "accept='typical'")
            if accept == "sample" and (sp.top_k or sp.top_p != 1.0):
                raise ValueError("verify_fusion + accept='sample' requires "
                                 "top_k=0 and top_p=1.0")
        # the tensor-parallel verify epilogue's eligibility: the fused
        # kernel's statistics contract (greedy, or an untruncated sampled
        # warp); an ineligible TP engine verifies the all-gathered logits
        self._tp_stats = bool(cfg.tp_axis) and not cfg.verify_fusion and (
            accept == "greedy"
            or (accept == "sample" and not sp.top_k and sp.top_p == 1.0))
        if self.proposer.q_kind not in ("mprob", "logits"):
            raise ValueError(f"proposer q_kind {self.proposer.q_kind!r}: "
                             "the engine verifies 'mprob' and 'logits'")
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.step_graphs = StepGraphs(self.device, capture=graphs)
        self._caches = {}

    def init_cache(self, batch: int, max_len: int, n_blocks=None):
        """Decode cache for ``batch`` slots on the engine's device in the
        config's cache dtype and layout.  Paged: ``n_blocks`` sizes the
        pool and its tables start all-zero (every entry trash block 0) for
        an allocator to fill; None gives the identity table.  The engine
        keeps one cache per (batch, max_len, n_blocks): a later call
        zeroes that cache in place (tables back to the identity or to
        zero) and returns it again, so a graph captured on it replays for
        every group of requests."""
        key = (batch, max_len, n_blocks)
        cache = self._caches.get(key)
        if cache is None:
            cache = self._caches[key] = model_api.init_cache(
                self.cfg, batch, max_len, n_blocks=n_blocks,
                device=self.device)
            return cache
        for pos, entry in cache.items():
            for t in entry.values():
                if pos == PAGES_KEY and n_blocks is None:
                    t.copy_(P.identity_table(*t.shape, device=t.device))
                else:
                    t.zero_()
        return cache

    def _capacity(self, cache, fallback: int) -> int:
        """Rows a proposer state allocated for ``cache`` holds: the
        cache's per-slot capacity; for a cache without attention rows (a
        pure SSM stack's) the ``max_len`` this engine made it with, so
        every group on the engine's cache has one state shape (one
        graph); else ``fallback`` (the reference's prompt-sized rule)."""
        rows = cache_max_len(cache)
        if rows:
            return rows
        for (_, max_len, _), mine in self._caches.items():
            if mine is cache:
                return max_len
        return fallback

    def init_proposer_state(self, batch: int, capacity: int):
        return self.proposer.init_state(batch, capacity)

    def _sampling_args(self, temperature=None, top_p=None):
        """(temperature, top_k, top_p) with the engine's defaults, per-call
        (or per-row [B] tensor) overrides winning."""
        sp = self.sampling
        return (sp.temperature if temperature is None else temperature,
                sp.top_k, sp.top_p if top_p is None else top_p)

    def draws(self, batch: int, dtree=None) -> Optional[Draws]:
        """One step's noise from the engine's generator: none under greedy,
        the Gumbel noise of the bonus draw under typical, and the
        acceptance uniforms too under sample (one per chain position for
        a "logits" proposer, one per round and sibling for the tree
        walk), sized for the step's topology ``dtree`` (default: the
        proposer's)."""
        if self.accept == "greedy":
            return None
        u = None
        dt = self.dtree if dtree is None else dtree
        if self.accept == "sample" and self.proposer.q_kind == "logits":
            u = S.uniform((batch, dt.K), self.generator)
        elif self.accept == "sample":
            u = S.uniform((batch, max(dt.K, 1), dt.Cmax), self.generator)
        return Draws(u, S.gumbel((batch, self.cfg.vocab_size),
                                 self.generator))

    def _tok_lens(self, lengths, extra_embeds):
        """True token counts inside the prompt tensor: ``lengths`` minus
        the frontend prefix a VLM prefill prepends."""
        if extra_embeds is not None and self.cfg.frontend \
                and self.cfg.family != "encdec":
            return lengths - self.cfg.frontend_len
        return lengths

    def prefill(self, params, proposer_params, tokens, lengths, cache,
                extra_embeds=None, state=None, temperature=None, top_p=None):
        """-> (cache, lengths, base_token [B], proposer state).

        ``extra_embeds`` [B, F, fd] (a config with a frontend) is the stub
        frontend's prefix, prefilled at rows 0..F-1 ahead of the tokens
        (``lengths`` then count its F rows), or the encoder-decoder's
        frames, which its encoder reads (``lengths`` count tokens only).
        Under ``accept="sample"`` the base token (the first emitted
        token) is drawn from the warped target logits with noise from the
        engine's generator, as the sampled AR oracle draws it; otherwise
        it is the argmax.
        ``temperature``/``top_p`` may be per-row [B] tensors.  ``state``
        is the proposer state to prime; None allocates one holding as many
        rows as the cache."""
        B, Sp = tokens.shape
        last_hidden, cache = self.model.prefill(params, self.cfg, tokens,
                                                lengths, cache,
                                                extra_embeds=extra_embeds)
        logits = self.model.unembed(params, self.cfg, last_hidden)
        if self.accept == "sample":
            t, k, p = self._sampling_args(temperature, top_p)
            base = S.sample(S.gumbel(tuple(logits.shape), self.generator),
                            logits, t, k, p)
        else:
            base = torch.argmax(logits, dim=-1).to(torch.int32)
        if state is None:
            state = self.init_proposer_state(
                B, self._capacity(cache, Sp + self.dtree.T + 2))
        state = self.proposer.prime(proposer_params, state, tokens, lengths,
                                    self._tok_lens(lengths, extra_embeds),
                                    last_hidden, base,
                                    extra_embeds=extra_embeds)
        return cache, lengths, base, state

    def step_dtrees(self, levels=()):
        """The adaptive-speculation graph family: ``(gamma, DeviceTree)``
        step topologies, ascending, ending with the proposer's full tree.
        Each smaller level is a single-path ``chain_tree`` prefix, which
        every accept mode verifies losslessly; the serving scheduler
        captures one step graph per level and selects among them on the
        host.  ``levels`` lists the chain gammas (default (1, 3), those
        below the full tree's K kept)."""
        K = self.dtree.K
        fam = []
        for g in sorted(set(levels or (1, 3))):
            if 0 < g < K:
                fam.append((g, V.device_tree(chain_tree(g), self.device)))
        fam.append((K, self.dtree))
        return fam

    def suffix_prefill(self, params, proposer_params, cache, lengths, tokens,
                       n_valid, active, temperature=None, top_p=None,
                       state=None):
        """Continue a prefill from cached prefix rows (prefix-cache
        admission and chunked prefill).

        A causal T-token decode of ``tokens`` [B, T] (right-padded
        suffixes) from ``lengths`` [B] (the rows already in the cache),
        committed for ``n_valid`` [B] rows on the slots where ``active``
        [B] is True; inactive slots keep their lengths, and their rows
        land where the masked commit sends dead rows.  Returns (cache,
        lengths, base [B], proposer state), meaningful on active rows
        only.  The proposer is primed from the suffix alone; one that
        does not ``supports_prefix`` raises.  Under ``accept="sample"``
        the base token is drawn from the warped target logits at the last
        valid row (``temperature``/``top_p`` may be per-row [B]
        tensors) with noise from the engine's generator; otherwise it is
        the argmax."""
        if not self.proposer.supports_prefix:
            raise ValueError(f"{type(self.proposer).__name__} cannot be "
                             "primed from a prompt suffix")
        B, T = tokens.shape
        dev = tokens.device
        causal = torch.tril(torch.ones((T, T), dtype=torch.bool, device=dev))
        depths = torch.arange(T, dtype=torch.int32, device=dev)
        nv = torch.clamp(n_valid, 1, T).to(torch.int32)
        # an SSM position keeps, inside its loop over the T tokens, only
        # the state after each row's valid suffix (the root on a masked
        # row): never the [B, T, ...] per-token states of a whole chunk
        hidden, spec_cache = self.model.decode(
            params, self.cfg, cache, tokens, lengths, causal, depths,
            use_kernel=self.use_kernel,
            ssm_keep=torch.where(active, nv, torch.zeros_like(nv)))
        path = torch.arange(T, dtype=torch.int32,
                            device=dev)[None].expand(B, T)
        cache, new_lengths = self.model.commit(self.cfg, spec_cache, lengths,
                                               path, nv, active=active)
        rows = torch.arange(B, device=dev)
        h_last = hidden[rows, (nv - 1).long()]                    # [B, d]
        logits = self.model.unembed(params, self.cfg, h_last)
        if self.accept == "sample":
            t, k, p = self._sampling_args(temperature, top_p)
            base = S.sample(S.gumbel(tuple(logits.shape), self.generator),
                            logits, t, k, p)
        else:
            base = torch.argmax(logits, dim=-1).to(torch.int32)
        if state is None:
            state = self.init_proposer_state(
                B, self._capacity(cache, T + self.dtree.T + 2))
        state = self.proposer.prime(proposer_params, state, tokens,
                                    new_lengths, nv, h_last, base)
        return cache, new_lengths, base, state

    def spec_step(self, params, proposer_params, cache, lengths, base, state,
                  draws: Optional[Draws] = None, temperature=None,
                  top_p=None, active=None, dtree=None):
        """One static speculative step: propose -> one target forward ->
        verify -> commit -> observe.  Returns (cache, lengths, verdict,
        state').  ``draws`` is the step's noise (None: ``self.draws``
        from the engine's generator); ``temperature``/``top_p`` override
        the engine's ``sampling`` and may be per-row [B] tensors.  A
        proposer that ``consumes_key`` draws its noise from the engine's
        generator before the step's verify draws are made.  ``active``
        [B] bool (optional) is the serving scheduler's masked commit: only
        active slots advance their lengths.  ``dtree`` (optional) is a
        member of ``step_dtrees()`` to step on instead of the proposer's
        full topology; verification stays lossless."""
        dt = self.dtree if dtree is None else dtree
        t, k, p = self._sampling_args(temperature, top_p)
        cand, q, state = self.proposer.propose(
            proposer_params, state, base, self.generator, t, k, p,
            stochastic=self.accept == "sample", dtree=dt)
        hidden, spec_cache = self.model.decode(
            params, self.cfg, cache, cand, lengths, dt.mask, dt.depths,
            use_kernel=self.use_kernel, deferred=self.deferred)
        if draws is None:
            draws = self.draws(cand.shape[0], dt)
        if self.cfg.verify_fusion:
            verdict = self._verify_fused(params, cand, hidden, q, draws, t,
                                         dt)
        elif self._tp_stats:
            verdict = self._verify_tp(params, cand, hidden, q, draws, t, k,
                                      p, dt)
        else:
            logits = self.model.unembed(params, self.cfg, hidden)  # [B,T,V]
            verdict = self._verify(cand, logits, q, draws, t, k, p, dt)
        cache, lengths = self.model.commit(self.cfg, spec_cache, lengths,
                                           verdict.path_slots, verdict.acc,
                                           active=active)
        rows = torch.arange(hidden.shape[0], device=hidden.device)
        h_last = hidden[rows, verdict.last_slot]                  # [B, d]
        state = self.proposer.observe(proposer_params, state, verdict,
                                      h_last, lengths)
        return cache, lengths, verdict, state

    def _verify(self, cand, logits, q, draws, temperature, top_k, top_p,
                dt):
        """Acceptance-rule dispatch on ``accept`` over the step's topology
        ``dt``; every verifier returns the same shapes."""
        if self.accept == "typical":
            return V.typical_verify(cand, logits, dt, draws.g,
                                    temperature=self.temperature)
        if self.accept == "sample" and self.proposer.q_kind == "logits":
            return V.sample_verify_chain(cand, logits, q, dt, draws.u,
                                         draws.g, temperature=temperature,
                                         top_k=top_k, top_p=top_p)
        if self.accept == "sample":
            return V.sample_verify_tree(cand, logits, q, dt, draws.u, draws.g,
                                        temperature=temperature,
                                        top_k=top_k, top_p=top_p)
        return V.greedy_verify(cand, logits, dt)

    def _verify_fused(self, params, cand, hidden, q, draws, temperature,
                      dt):
        """Fused-epilogue acceptance: the ``unembed_verify_stats`` kernel
        streams the lm-head product over vocabulary tiles and hands back
        Verdict-sized statistics of the logits divided by ``tmax`` (ones
        for greedy, max(t, 1e-6) per row for sample); the [B, T, V]
        logits are never made.  The sampled walks (tree or chain, as
        ``_verify`` picks) rebuild the residual from ONE [B, V] row
        unembed at each row's stopping node.  The greedy Verdict is
        bit-identical to ``greedy_verify``'s."""
        B = cand.shape[0]
        dev = hidden.device
        if self.accept == "sample":
            tmax = torch.clamp(S.per_row(temperature, B, dev), min=1e-6)
        else:
            tmax = torch.ones((B,), dtype=torch.float32, device=dev)
        w, layout = self.model.unembed_weight(params)
        stats = V.VerifyStats(*KO.verify_stats(hidden, w, cand, tmax,
                                               layout))
        if self.accept != "sample":
            return V.greedy_verify_stats(cand, stats, dt)
        rows = torch.arange(B, device=dev)

        def row_fn(idx):
            return self.model.unembed(params, self.cfg, hidden[rows, idx])

        if self.proposer.q_kind == "logits":
            return V.sample_verify_chain_stats(cand, stats, q, dt,
                                               draws.u, draws.g, row_fn,
                                               temperature=temperature)
        return V.sample_verify_tree_stats(cand, stats, q, dt,
                                          draws.u, draws.g, row_fn,
                                          temperature=temperature)

    def _verify_tp(self, params, cand, hidden, q, draws, temperature, top_k,
                   top_p, dt):
        """Tensor-parallel acceptance epilogue: each rank's lm head holds a
        [d, V / tp] slice of the vocabulary, so each rank warps the logits
        of its own columns and ``tp_verify_stats`` reduces them across
        ranks to the ``VerifyStats`` the fused kernel would give.  The
        [B, T, V] logits exist on no rank; the statistics feed the
        ``*_stats`` walks the fused kernel's path feeds, so the verdicts
        are the single-device engine's."""
        B = cand.shape[0]
        dev = hidden.device
        if self.accept == "sample":
            tmax = torch.clamp(S.per_row(temperature, B, dev), min=1e-6)
        else:
            tmax = torch.ones((B,), dtype=torch.float32, device=dev)
        stats = tp_verify_stats(
            self.model.unembed_local(params, self.cfg, hidden), cand, tmax,
            self.cfg.tp_axis)
        if self.accept != "sample":
            return V.greedy_verify_stats(cand, stats, dt)
        rows = torch.arange(B, device=dev)

        def row_fn(idx):
            # one all-gathered [B, V] row: the residual or bonus draw never
            # needs more than the stopping node's row
            return self.model.unembed(params, self.cfg, hidden[rows, idx])

        if self.proposer.q_kind == "logits":
            return V.sample_verify_chain_stats(
                cand, stats, q, dt, draws.u, draws.g, row_fn,
                temperature=temperature, top_k=top_k, top_p=top_p)
        return V.sample_verify_tree_stats(cand, stats, q, dt, draws.u,
                                          draws.g, row_fn,
                                          temperature=temperature)

    # -- the loop -----------------------------------------------------------

    def loop_step(self, params, proposer_params, cache, state, max_new: int):
        """-> (StepGraph, SpecCarry): ``generate``'s loop body on a static
        carry over ``cache``, one step a call.  Kept in ``step_graphs``
        under (batch, max_new, the state's shapes) while ``cache`` and the
        weights are the same tensors, and built anew (recaptured) when
        they are not.  ``state`` gives the proposer state's shapes (every
        leaf of its nested dicts).  A deferred step is a key of its
        own."""
        B = _cache_batch(cache)
        key = ("spec", B, max_new, self.accept, self.sampling.top_k,
               self.deferred, tree_spec(state))

        def make():
            dev = self.device
            i32 = torch.int32
            f32 = dict(dtype=torch.float32, device=dev)
            c = SpecCarry(
                cache=cache, lengths=torch.zeros((B,), dtype=i32, device=dev),
                base=torch.zeros((B,), dtype=i32, device=dev),
                state=tree_map(torch.empty_like, state),
                out=torch.zeros((B, max_new + self.dtree.K + 2), dtype=i32,
                                device=dev),
                n_out=torch.zeros((B,), dtype=i32, device=dev),
                acc_sum=torch.zeros((), dtype=torch.int64, device=dev),
                acc_slot=torch.zeros((B,), dtype=i32, device=dev),
                temperature=torch.ones((B,), **f32),
                top_p=torch.ones((B,), **f32))
            draws_from = () if self.accept == "greedy" else (self.generator,)
            # the engine holds its graphs, so the step holds the engine
            # weakly: no cycle, and a dropped engine frees its graphs at
            # once rather than whenever the cyclic collector runs
            eng = weakref.ref(self)
            return self.step_graphs.graph(
                lambda: eng()._carry_step(params, proposer_params, c,
                                          max_new), draws_from), c

        return self.step_graphs.get(
            key, binding(params, proposer_params, cache), make)

    def _carry_step(self, params, proposer_params, c: SpecCarry,
                    max_new: int):
        """One step of the loop on the static carry, in place (the body of
        the reference's ``while_loop``)."""
        _, lengths, verdict, state = self.spec_step(
            params, proposer_params, c.cache, c.lengths, c.base, c.state,
            temperature=c.temperature, top_p=c.top_p)
        _write_out(c, verdict.path_tokens)
        acc_row = torch.minimum(verdict.acc,
                                torch.clamp(max_new - c.n_out, min=0))
        c.acc_sum.add_(acc_row.sum())
        c.acc_slot.add_(acc_row)
        c.n_out.add_(verdict.acc)
        c.lengths.copy_(lengths)
        c.base.copy_(verdict.next_token)
        copy_tree_(c.state, state)

    def generate(self, params, proposer_params, tokens, prompt_lengths, cache,
                 max_new: int, extra_embeds=None, state=None,
                 temperature=None):
        """Full speculative generation loop.

        tokens [B, S_p] int32 right-padded prompts, prompt_lengths [B]
        int32, cache from ``init_cache``, all on the engine's device.
        ``extra_embeds`` [B, F, fd] (a config with a frontend) is the
        prompts' frontend prefix (``prompt_lengths`` then count its F
        rows), or the encoder-decoder's frames (they do not).
        ``temperature`` (a scalar or a per-row [B] tensor) overrides the
        engine's ``sampling.temperature`` for this call; it and
        ``sampling.top_p`` are carry values, so the captured step replays
        for any of them.  ``state`` (optional) is a proposer state to
        prime, such as a draft cache the caller allocated; None allocates
        one holding as many rows as ``cache`` (the reference sizes it to
        the prompt and ``max_new``, which would make every prompt width a
        step shape of its own; the tokens are the same).  Returns
        (out_tokens [B, max_new] int32, n_out [B] int32 true lengths,
        StepStats)."""
        dt = self.dtree
        B = tokens.shape[0]
        t, _, p = self._sampling_args(temperature)
        if state is None:
            state = self.init_proposer_state(
                B, self._capacity(cache, tokens.shape[1] + max_new + dt.T + 2))
        cache, lengths, base, state = self.prefill(
            params, proposer_params, tokens, prompt_lengths, cache,
            extra_embeds=extra_embeds, state=state, temperature=t, top_p=p)
        step, c = self.loop_step(params, proposer_params, cache, state,
                                 max_new)
        c.load(lengths, base, state, t, p)
        steps = 0
        # max_new bounds the loop (every step commits >= 1 token per row);
        # the exit test is the one host read per step
        while steps < max_new and bool(torch.any(c.n_out < max_new)):  # speclint: disable=trace-safety
            step()
            steps += 1
        # final certain token
        _write_out(c, c.base[:, None].expand(B, dt.K + 1))
        n_out = c.n_out + 1
        stats = StepStats(tokens_out=n_out, steps=steps,
                          accepted_sum=c.acc_sum.clone(),
                          accepted_per_slot=c.acc_slot.clone())
        return c.out[:, :max_new].clone(), torch.clamp(n_out, max=max_new), \
            stats


def tp_verify_stats(logits_local, cand, tmax, axis: str) -> V.VerifyStats:
    """``VerifyStats`` of the logits divided by ``tmax`` [B], from this
    rank's vocabulary slice ``logits_local`` [B, T, V / tp] (ranks hold
    ascending, contiguous slices) and the candidates ``cand`` [B, T]
    (global token ids), reduced across the ranks of ``axis``:

      * max: the max of the gathered per-rank row maxima;
      * argmax: the first rank attaining it (rank order is index order, so
        the first index wins across ranks as within one);
      * sum of exponentials: the sum over ranks of each rank's partial sum
        taken at the global max;
      * candidate columns: the sum over ranks of a one-hot extraction
        (each candidate lives on one rank; the others add exact zeros).

    The maxima and argmaxima travel in one all-gather, the two sums in
    one all-reduce."""
    B, T = cand.shape
    wv = logits_local.float() / tmax[:, None, None]
    v_loc = wv.shape[-1]
    offs = C.axis_index(axis) * v_loc
    m_loc = torch.amax(wv, dim=-1)                                 # [B, T]
    a_loc = torch.argmax(wv, dim=-1)               # the first index on ties
    # a global index (< 2**24) is exact in float32
    both = C.all_gather(torch.stack([m_loc, (a_loc + offs).float()]), axis,
                        dim=0, tiled=False)                   # [N, 2, B, T]
    ms, am = both[:, 0], both[:, 1]
    first = torch.argmax(ms, dim=0)               # the first rank at the max
    m = torch.amax(ms, dim=0)
    argm = torch.gather(am, 0, first[None])[0].to(torch.int32)
    here = (cand >= offs) & (cand < offs + v_loc)                 # [B, T]
    cidx = torch.clamp(cand - offs, 0, v_loc - 1).long()
    colw = torch.gather(wv, 2, cidx[:, None, :].expand(B, T, T))
    part_l = torch.sum(torch.exp(wv - m[:, :, None]), dim=-1)      # [B, T]
    part_w = torch.where(here[:, None, :], colw, 0.0)              # [B,T,T]
    sums = C.psum_(torch.cat([part_l[..., None], part_w], dim=-1), axis)
    return V.VerifyStats(argm, m, sums[..., 0].contiguous(),
                         sums[..., 1:].contiguous())


def _write_out(c: SpecCarry, toks):
    """c.out[b, n_out[b] + j] = toks[b, j] for the K + 1 columns of
    ``toks``, the start clamped so the row stays inside ``out``."""
    B, K1 = toks.shape
    dev = toks.device
    start = torch.clamp(c.n_out, max=c.out.shape[1] - K1).long()[:, None]
    rows = torch.arange(B, device=dev)[:, None]
    c.out[rows, start + torch.arange(K1, device=dev)] = toks.to(torch.int32)


def _cache_batch(cache) -> int:
    """Slots of a cache: the table's rows (paged) or the B axis of its
    first entry's leaves (dense; an SSM position's state and the
    encoder-decoder's cross k/v are per slot under every layout)."""
    if PAGES_KEY in cache:
        return cache[PAGES_KEY]["table"].shape[0]
    return next(iter(next(iter(cache.values())).values())).shape[1]


def build_engine(cfg: ModelConfig, proposer: str = "medusa", *,
                 tb: Optional[TreeBuffers] = None,
                 draft_cfg: Optional[ModelConfig] = None,
                 draft_layers: int = 2, gamma: int = 4, max_n: int = 3,
                 min_n: int = 1, matcher: str = "auto",
                 use_kernel: bool = False, device="cuda",
                 accept: str = "greedy",
                 sampling: Optional[SamplingParams] = None,
                 verify_fusion: Optional[bool] = None,
                 graphs: bool = True, seed: int = 0,
                 deferred: bool = False) -> SpecEngine:
    """Engine construction shared by the launcher and the tests.

    ``proposer`` names the draft policy (medusa | draft | ngram; another
    name raises ``ValueError``).  For "draft" a ``draft_cfg`` may be given;
    omitted, a ``draft_layers``-layer sibling of ``cfg`` is derived
    (``proposers.draft_config``), and either way the draft takes the
    engine's verify fusion and ``use_kernel``.  ``tb`` overrides the
    Medusa tree; ``gamma``/``max_n``/``min_n`` shape the chain proposers;
    ``matcher`` picks the n-gram lookup (scan | automaton | auto: the
    hash-table automaton at a history capacity >= 8192)."""
    dev = resolve_device(device)
    if verify_fusion is not None and verify_fusion != cfg.verify_fusion:
        cfg = dataclasses.replace(cfg, verify_fusion=verify_fusion)
    if proposer == "draft":
        draft_cfg = draft_config(cfg, draft_cfg, draft_layers)
    p = make_proposer(proposer, cfg, device=dev, tb=tb, draft_cfg=draft_cfg,
                      gamma=gamma, max_n=max_n, min_n=min_n, matcher=matcher,
                      use_kernel=use_kernel)
    return SpecEngine(cfg, use_kernel=use_kernel, accept=accept,
                      sampling=sampling, proposer=p, device=dev,
                      graphs=graphs, seed=seed, deferred=deferred)


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


@dataclasses.dataclass
class ARCarry:
    """The AR loop's carry (the reference's ``fori_loop`` carry) in static
    buffers, with the loop index on the device so the captured step
    writes ``out[:, i]`` at the step's own index."""
    cache: dict
    lengths: torch.Tensor        # [B] int32
    tok: torch.Tensor            # [B] int32 the token this step writes
    logits: torch.Tensor         # [B, V] that ``tok`` was picked from
    out: torch.Tensor            # [B, max_new] int32
    i: torch.Tensor              # [1] int64 the step's output column
    temperature: torch.Tensor    # [B] f32 per-row warp temperature (sampled)
    top_p: torch.Tensor          # [B] f32 per-row nucleus mass (sampled)

    def load(self, lengths, logits, temperature=1.0, top_p=1.0):
        """Start a loop from a prefill's lengths and last logits; the
        caller sets ``tok`` (``_ar_next``)."""
        B, dev = lengths.shape[0], self.lengths.device
        self.lengths.copy_(lengths)
        self.logits.copy_(logits)
        self.temperature.copy_(S.per_row(temperature, B, dev))
        self.top_p.copy_(S.per_row(top_p, B, dev))
        self.out.zero_()
        self.i.zero_()


def _ar_next(c: ARCarry, logits, sampling, generator):
    """The token after ``logits``: the argmax (greedy AR, ``sampling``
    None) or a draw from the warped logits at the carry's per-row
    temperature and top-p, with Gumbel noise from ``generator``."""
    if sampling is None:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    return S.sample(S.gumbel(tuple(logits.shape), generator), logits,
                    c.temperature, sampling.top_k, c.top_p)


def ar_loop_step(cfg: ModelConfig, params, cache, max_new: int,
                 use_kernel: bool, graphs: StepGraphs,
                 sampling: Optional[SamplingParams] = None,
                 generator: Optional[torch.Generator] = None):
    """-> (StepGraph, ARCarry): ``ar_generate``'s loop body on a static
    carry over ``cache``, kept in ``graphs`` as ``SpecEngine.loop_step``
    keeps the speculative one.  With ``sampling`` (and ``generator``) the
    body is ``ar_generate_sampled``'s: each token drawn from the warped
    logits, the generator registered with the graph."""
    B = _cache_batch(cache)
    top_k = None if sampling is None else sampling.top_k
    key = ("ar", cfg, B, max_new, use_kernel, top_k)
    draws_from = () if sampling is None else (generator,)

    def make():
        dev = graphs.device
        f32 = dict(dtype=torch.float32, device=dev)
        c = ARCarry(
            cache=cache, lengths=torch.zeros((B,), dtype=torch.int32,
                                             device=dev),
            tok=torch.zeros((B,), dtype=torch.int32, device=dev),
            logits=torch.zeros((B, cfg.vocab_size),
                               dtype=torch_dtype(cfg.dtype), device=dev),
            out=torch.zeros((B, max_new), dtype=torch.int32, device=dev),
            i=torch.zeros((1,), dtype=torch.int64, device=dev),
            temperature=torch.ones((B,), **f32),
            top_p=torch.ones((B,), **f32))
        return graphs.graph(lambda: _ar_carry_step(
            cfg, params, c, use_kernel, sampling, generator), draws_from), c

    return graphs.get(key, binding(params, cache, *draws_from), make)


def _ar_carry_step(cfg, params, c: ARCarry, use_kernel, sampling=None,
                   generator=None):
    """One AR step on the static carry, in place (the reference's
    ``fori_loop`` body)."""
    c.out.index_copy_(1, c.i, c.tok[:, None])              # out[:, i] = tok
    logits, _, lengths = ar_step(cfg, params, c.cache, c.tok, c.lengths,
                                 use_kernel)
    c.i.add_(1)
    c.lengths.copy_(lengths)
    c.logits.copy_(logits)
    c.tok.copy_(_ar_next(c, logits, sampling, generator))


def _ar_run(cfg, params, tokens, prompt_lengths, cache, max_new, use_kernel,
            observe, graphs, sampling=None, generator=None,
            extra_embeds=None):
    """The AR loop of ``ar_generate`` / ``ar_generate_sampled``."""
    model = get_model(cfg)
    last_hidden, cache = model.prefill(params, cfg, tokens, prompt_lengths,
                                       cache, extra_embeds=extra_embeds)
    if not isinstance(graphs, StepGraphs):
        graphs = StepGraphs(tokens.device, capture=graphs)
    step, c = ar_loop_step(cfg, params, cache, max_new, use_kernel, graphs,
                           sampling, generator)
    logits = model.unembed(params, cfg, last_hidden)
    if sampling is None:
        c.load(prompt_lengths, logits)
    else:
        c.load(prompt_lengths, logits, sampling.temperature, sampling.top_p)
    c.tok.copy_(_ar_next(c, c.logits, sampling, generator))
    for i in range(max_new):
        if observe is not None:
            observe(i, c.logits.clone())
        step()
    return c.out.clone(), c.lengths.clone()


def ar_generate(cfg: ModelConfig, params, tokens, prompt_lengths, cache,
                max_new: int, use_kernel: bool = False, observe=None,
                graphs: Union[bool, StepGraphs] = True, extra_embeds=None):
    """Greedy autoregressive baseline on the same cache machinery (T=1).

    tokens [B, S_p] int32, prompt_lengths [B] int32, cache from
    ``init_cache``.  ``use_kernel`` routes decode attention through the
    ``flash_decode`` kernel as the speculative engine does.  ``observe``,
    if given, is called as ``observe(i, logits)`` with a copy of the
    [B, V] logits whose argmax is output token ``i`` (``chip_smoke.py``
    reads the near-tie margins there).  ``graphs``: True replays the step
    as a CUDA graph on the card, captured for this call; False runs it
    eagerly; a ``StepGraphs`` (an engine's ``step_graphs``) keeps the
    graph across calls.  ``extra_embeds`` [B, F, fd] (a config with a
    frontend) is prefilled ahead of the tokens, ``prompt_lengths``
    counting its F rows (the encoder-decoder's frames go to its encoder
    and take no row).  Returns (out [B, max_new] int32, lengths [B]
    final cache lengths)."""
    return _ar_run(cfg, params, tokens, prompt_lengths, cache, max_new,
                   use_kernel, observe, graphs, extra_embeds=extra_embeds)


def ar_generate_sampled(cfg: ModelConfig, params, tokens, prompt_lengths,
                        cache, max_new: int, generator: torch.Generator,
                        sampling: Optional[SamplingParams] = None,
                        use_kernel: bool = False,
                        graphs: Union[bool, StepGraphs] = True,
                        extra_embeds=None):
    """Stochastic autoregressive baseline on the same cache machinery
    (T=1): every token is drawn from the warped target logits, with noise
    from ``generator`` (on the tokens' device).

    The distribution-equality oracle for ``accept="sample"``: lossless
    stochastic speculative decoding must produce sequences distributed as
    this loop's.  At ``sampling.temperature <= 0`` it is token-identical
    to ``ar_generate``.  ``sampling.temperature``/``top_p`` go into the
    carry as [B] tensors (``top_k`` is part of the graph's key);
    ``use_kernel``, ``graphs`` and ``extra_embeds`` as ``ar_generate``.
    Returns (out [B, max_new] int32, lengths [B])."""
    sp = sampling if sampling is not None else SamplingParams()
    return _ar_run(cfg, params, tokens, prompt_lengths, cache, max_new,
                   use_kernel, None, graphs, sp, generator, extra_embeds)


def _squeeze_spec(spec_cache):
    """Settle a T=1 spec cache: drop the in-flight ``*_new`` rows, keeping
    the persistent leaves (k/v and, under int8, k_scale/v_scale), the
    paged layout's ``_pages`` block table and the encoder-decoder's
    ``cross`` entry, which pass through untouched.  An SSM position's
    state after the one token (a T=1 step always accepts it) is copied
    over its persistent state first: the reference's collapse of the T=1
    axis."""
    out = {}
    for pos, entry in spec_cache.items():
        if pos in (PAGES_KEY, CROSS_KEY):
            out[pos] = entry
            continue
        if not is_attn_entry(entry):
            for name, x in entry.items():
                for u, states in enumerate(entry.get(name + "_new", ())):
                    x[u].copy_(states[:, 0])
        out[pos] = {n: x for n, x in entry.items() if not n.endswith("_new")}
    return out
