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
from repro_torch.core.proposers import MedusaProposer, Proposer
from repro_torch.core.tree import TreeBuffers
from repro_torch.kernels import ops as KO
from repro_torch.kernels import paging as P
from repro_torch.models import api as model_api
from repro_torch.models.api import get_model
from repro_torch.models.transformer import PAGES_KEY
from repro_torch.runtime import (StepGraphs, binding, resolve_device,
                                 torch_dtype)


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
    u: Optional[torch.Tensor]    # [B, max(K, 1), Cmax] f32 acceptance
                                 # uniforms (accept="sample")
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
    state: dict                  # the proposer's state
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
        for k, t in state.items():
            self.state[k].copy_(t)
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
    temperature defaults to ``temperature``).  At ``sampling.temperature
    <= 0`` the "sample" mode is token-identical to "greedy".  ``seed``
    seeds the engine's ``generator`` (on its device), which every draw of
    the non-greedy modes comes from.
    ``use_kernel`` routes decode attention through
    ``kernels.ops.tree_attention`` (the ``flash_decode`` kernel on the
    card).  ``verify_fusion`` (default: ``cfg.verify_fusion``) verifies
    from the ``unembed_verify_stats`` kernel's statistics instead of the
    [B, T, V] logits, and with ``use_kernel`` also runs each layer's write
    side as one ``fused_qkv_rope_commit`` launch.  ``device`` defaults to
    the card and raises if there is none.  ``graphs`` (default True)
    replays ``generate``'s step as a CUDA graph on the card; False runs
    the same step eagerly (to compare the two).  The engine keeps its
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
                 seed: int = 0):
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
        if accept == "sample" and self.proposer.q_kind != "mprob":
            raise NotImplementedError("the chain walk (draft-model "
                                      "proposals) is ROADMAP queue 1 item 12")
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.step_graphs = StepGraphs(self.device, capture=graphs)
        self._caches = {}

    def init_cache(self, batch: int, max_len: int):
        """Decode cache for ``batch`` slots on the engine's device in the
        config's cache dtype and layout (paged: the identity table).  The
        engine keeps one cache per (batch, max_len): a later call zeroes
        that cache in place and returns it again, so a graph captured on
        it replays for every group of requests."""
        cache = self._caches.get((batch, max_len))
        if cache is None:
            cache = self._caches[batch, max_len] = model_api.init_cache(
                self.cfg, batch, max_len, device=self.device)
            return cache
        for pos, entry in cache.items():
            for t in entry.values():
                if pos == PAGES_KEY:
                    t.copy_(P.identity_table(*t.shape, device=t.device))
                else:
                    t.zero_()
        return cache

    def init_proposer_state(self, batch: int, capacity: int):
        return self.proposer.init_state(batch, capacity)

    def _sampling_args(self, temperature=None, top_p=None):
        """(temperature, top_k, top_p) with the engine's defaults, per-call
        (or per-row [B] tensor) overrides winning."""
        sp = self.sampling
        return (sp.temperature if temperature is None else temperature,
                sp.top_k, sp.top_p if top_p is None else top_p)

    def draws(self, batch: int) -> Optional[Draws]:
        """One step's noise from the engine's generator: none under greedy,
        the Gumbel noise of the bonus draw under typical, and the
        acceptance uniforms too under sample."""
        if self.accept == "greedy":
            return None
        u = None
        if self.accept == "sample":
            u = S.uniform((batch, max(self.dtree.K, 1), self.dtree.Cmax),
                          self.generator)
        return Draws(u, S.gumbel((batch, self.cfg.vocab_size),
                                 self.generator))

    def prefill(self, params, proposer_params, tokens, lengths, cache,
                state=None, temperature=None, top_p=None):
        """-> (cache, lengths, base_token [B], proposer state).

        Under ``accept="sample"`` the base token (the first emitted token)
        is drawn from the warped target logits with noise from the
        engine's generator, as the sampled AR oracle draws it; otherwise
        it is the argmax.  ``temperature``/``top_p`` may be per-row [B]
        tensors."""
        B, Sp = tokens.shape
        last_hidden, cache = self.model.prefill(params, self.cfg, tokens,
                                                lengths, cache)
        logits = self.model.unembed(params, self.cfg, last_hidden)
        if self.accept == "sample":
            t, k, p = self._sampling_args(temperature, top_p)
            base = S.sample(S.gumbel(tuple(logits.shape), self.generator),
                            logits, t, k, p)
        else:
            base = torch.argmax(logits, dim=-1).to(torch.int32)
        if state is None:
            state = self.init_proposer_state(B, Sp + self.dtree.T + 2)
        state = self.proposer.prime(proposer_params, state, tokens, lengths,
                                    last_hidden, base)
        return cache, lengths, base, state

    def spec_step(self, params, proposer_params, cache, lengths, base, state,
                  draws: Optional[Draws] = None, temperature=None,
                  top_p=None):
        """One static speculative step: propose -> one target forward ->
        verify -> commit -> observe.  Returns (cache, lengths, verdict,
        state').  ``draws`` is the step's noise (None: ``self.draws``
        from the engine's generator); ``temperature``/``top_p`` override
        the engine's ``sampling`` and may be per-row [B] tensors."""
        dt = self.dtree
        t, k, p = self._sampling_args(temperature, top_p)
        cand, q, state = self.proposer.propose(
            proposer_params, state, base, self.generator, t, k, p,
            stochastic=self.accept == "sample")
        hidden, spec_cache = self.model.decode(
            params, self.cfg, cache, cand, lengths, dt.mask, dt.depths,
            use_kernel=self.use_kernel)
        if draws is None:
            draws = self.draws(cand.shape[0])
        if self.cfg.verify_fusion:
            verdict = self._verify_fused(params, cand, hidden, q, draws, t)
        else:
            logits = self.model.unembed(params, self.cfg, hidden)  # [B,T,V]
            verdict = self._verify(cand, logits, q, draws, t, k, p)
        cache, lengths = self.model.commit(self.cfg, spec_cache, lengths,
                                           verdict.path_slots, verdict.acc)
        rows = torch.arange(hidden.shape[0], device=hidden.device)
        h_last = hidden[rows, verdict.last_slot]                  # [B, d]
        state = self.proposer.observe(proposer_params, state, verdict,
                                      h_last, lengths)
        return cache, lengths, verdict, state

    def _verify(self, cand, logits, q, draws, temperature, top_k, top_p):
        """Acceptance-rule dispatch on ``accept``; every verifier returns
        the same shapes."""
        dt = self.dtree
        if self.accept == "typical":
            return V.typical_verify(cand, logits, dt, draws.g,
                                    temperature=self.temperature)
        if self.accept == "sample":
            return V.sample_verify_tree(cand, logits, q, dt, draws.u, draws.g,
                                        temperature=temperature,
                                        top_k=top_k, top_p=top_p)
        return V.greedy_verify(cand, logits, dt)

    def _verify_fused(self, params, cand, hidden, q, draws, temperature):
        """Fused-epilogue acceptance: the ``unembed_verify_stats`` kernel
        streams the lm-head product over vocabulary tiles and hands back
        Verdict-sized statistics of the logits divided by ``tmax`` (ones
        for greedy, max(t, 1e-6) per row for sample); the [B, T, V]
        logits are never made.  The sampled walk rebuilds the residual
        from ONE [B, V] row unembed at each row's stopping node.  The
        greedy Verdict is bit-identical to ``greedy_verify``'s."""
        B = cand.shape[0]
        dev = hidden.device
        if self.accept == "sample":
            tmax = torch.clamp(S.per_row(temperature, B, dev), min=1e-6)
        else:
            tmax = torch.ones((B,), dtype=torch.float32, device=dev)
        stats = V.VerifyStats(*KO.verify_stats(hidden, params["lm_head"],
                                               cand, tmax))
        if self.accept != "sample":
            return V.greedy_verify_stats(cand, stats, self.dtree)
        rows = torch.arange(B, device=dev)

        def row_fn(idx):
            return self.model.unembed(params, self.cfg, hidden[rows, idx])

        return V.sample_verify_tree_stats(cand, stats, q, self.dtree,
                                          draws.u, draws.g, row_fn,
                                          temperature=temperature)

    # -- the loop -----------------------------------------------------------

    def loop_step(self, params, proposer_params, cache, state, max_new: int):
        """-> (StepGraph, SpecCarry): ``generate``'s loop body on a static
        carry over ``cache``, one step a call.  Kept in ``step_graphs``
        under (batch, max_new, the state's shapes) while ``cache`` and the
        weights are the same tensors, and built anew (recaptured) when
        they are not.  ``state`` gives the proposer state's shapes."""
        B = _cache_batch(cache)
        key = ("spec", B, max_new, self.accept, self.sampling.top_k,
               tuple((k, tuple(t.shape), t.dtype)
                     for k, t in sorted(state.items())))

        def make():
            dev = self.device
            i32 = torch.int32
            f32 = dict(dtype=torch.float32, device=dev)
            c = SpecCarry(
                cache=cache, lengths=torch.zeros((B,), dtype=i32, device=dev),
                base=torch.zeros((B,), dtype=i32, device=dev),
                state={k: torch.empty_like(t) for k, t in state.items()},
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
        for k, t in state.items():
            c.state[k].copy_(t)

    def generate(self, params, proposer_params, tokens, prompt_lengths, cache,
                 max_new: int, state=None, temperature=None):
        """Full speculative generation loop.

        tokens [B, S_p] int32 right-padded prompts, prompt_lengths [B]
        int32, cache from ``init_cache``, all on the engine's device.
        ``temperature`` (a scalar or a per-row [B] tensor) overrides the
        engine's ``sampling.temperature`` for this call; it and
        ``sampling.top_p`` are carry values, so the captured step replays
        for any of them.  Returns (out_tokens [B, max_new] int32, n_out
        [B] int32 true lengths, StepStats)."""
        dt = self.dtree
        B, Sp = tokens.shape
        t, _, p = self._sampling_args(temperature)
        if state is None:
            state = self.init_proposer_state(B, Sp + max_new + dt.T + 2)
        cache, lengths, base, state = self.prefill(
            params, proposer_params, tokens, prompt_lengths, cache,
            state=state, temperature=t, top_p=p)
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


def _write_out(c: SpecCarry, toks):
    """c.out[b, n_out[b] + j] = toks[b, j] for the K + 1 columns of
    ``toks``, the start clamped so the row stays inside ``out``."""
    B, K1 = toks.shape
    dev = toks.device
    start = torch.clamp(c.n_out, max=c.out.shape[1] - K1).long()[:, None]
    rows = torch.arange(B, device=dev)[:, None]
    c.out[rows, start + torch.arange(K1, device=dev)] = toks.to(torch.int32)


def _cache_batch(cache) -> int:
    """Slots of a cache: the table's rows (paged) or the B axis (dense)."""
    if PAGES_KEY in cache:
        return cache[PAGES_KEY]["table"].shape[0]
    return cache["pos0"]["k"].shape[1]


def build_engine(cfg: ModelConfig, proposer: str = "medusa", *,
                 use_kernel: bool = False, device="cuda",
                 accept: str = "greedy",
                 sampling: Optional[SamplingParams] = None,
                 verify_fusion: Optional[bool] = None,
                 graphs: bool = True, seed: int = 0) -> SpecEngine:
    """Engine construction shared by the launcher and the tests.  The
    port carries the Medusa proposer only."""
    if proposer != "medusa":
        raise NotImplementedError(f"proposer {proposer!r}: draft-model and "
                                  "n-gram proposers are ROADMAP queue 1 "
                                  "item 12")
    dev = resolve_device(device)
    return SpecEngine(cfg, use_kernel=use_kernel, accept=accept,
                      sampling=sampling, proposer=MedusaProposer(cfg, dev),
                      device=dev, verify_fusion=verify_fusion, graphs=graphs,
                      seed=seed)


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
            observe, graphs, sampling=None, generator=None):
    """The AR loop of ``ar_generate`` / ``ar_generate_sampled``."""
    model = get_model(cfg)
    last_hidden, cache = model.prefill(params, cfg, tokens, prompt_lengths,
                                       cache)
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
                graphs: Union[bool, StepGraphs] = True):
    """Greedy autoregressive baseline on the same cache machinery (T=1).

    tokens [B, S_p] int32, prompt_lengths [B] int32, cache from
    ``init_cache``.  ``use_kernel`` routes decode attention through the
    ``flash_decode`` kernel as the speculative engine does.  ``observe``,
    if given, is called as ``observe(i, logits)`` with a copy of the
    [B, V] logits whose argmax is output token ``i`` (``chip_smoke.py``
    reads the near-tie margins there).  ``graphs``: True replays the step
    as a CUDA graph on the card, captured for this call; False runs it
    eagerly; a ``StepGraphs`` (an engine's ``step_graphs``) keeps the
    graph across calls.  Returns (out [B, max_new] int32, lengths [B]
    final cache lengths)."""
    return _ar_run(cfg, params, tokens, prompt_lengths, cache, max_new,
                   use_kernel, observe, graphs)


def ar_generate_sampled(cfg: ModelConfig, params, tokens, prompt_lengths,
                        cache, max_new: int, generator: torch.Generator,
                        sampling: Optional[SamplingParams] = None,
                        use_kernel: bool = False,
                        graphs: Union[bool, StepGraphs] = True):
    """Stochastic autoregressive baseline on the same cache machinery
    (T=1): every token is drawn from the warped target logits, with noise
    from ``generator`` (on the tokens' device).

    The distribution-equality oracle for ``accept="sample"``: lossless
    stochastic speculative decoding must produce sequences distributed as
    this loop's.  At ``sampling.temperature <= 0`` it is token-identical
    to ``ar_generate``.  ``sampling.temperature``/``top_p`` go into the
    carry as [B] tensors (``top_k`` is part of the graph's key);
    ``use_kernel`` and ``graphs`` as ``ar_generate``.  Returns (out
    [B, max_new] int32, lengths [B])."""
    sp = sampling if sampling is not None else SamplingParams()
    return _ar_run(cfg, params, tokens, prompt_lengths, cache, max_new,
                   use_kernel, None, graphs, sp, generator)


def _squeeze_spec(spec_cache):
    """Drop the in-flight ``*_new`` rows of a T=1 spec cache, keeping the
    persistent leaves (k/v and, under int8, k_scale/v_scale) and the paged
    layout's ``_pages`` block table."""
    return {pos: entry if pos == PAGES_KEY else
            {n: x for n, x in entry.items() if not n.endswith("_new")}
            for pos, entry in spec_cache.items()}
