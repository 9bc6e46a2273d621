"""Continuous-batching speculative server over one ``SpecEngine``
(counterpart of ``repro.serving.scheduler``).

The decode batch is B fixed slots.  Every decode step runs all B slots
with per-slot lengths; empty slots carry a dummy row and are masked out of
the commit (``spec_step(..., active=...)``), never out of tensor shapes.
So the serve step has one shape per speculation level, and on the card it
is a CUDA graph (``runtime.StepGraph``), captured once per level in the
engine's ``step_graphs`` and replayed every step.  Every per-slot input of
the step lives in a static device tensor that the host updates in place
with ``copy_``: the cache (a dense [n_units, B, S, ...] cache, or under
the paged layout the global block pool and its [B, max_blocks] table),
``lengths``, ``base``, ``n_out``, the proposer state, and the slot
metadata ``active`` / ``eos`` / ``max_new`` / ``temperature`` / ``top_p``.
Admission, reaping, the table push, preemption and recovery all mutate
these tensors in place, so their addresses hold and a new request never
causes a recapture.  The host reads exactly one ``SlotSync`` a step, as
one device-to-host copy of one [B, 3 + K + 1] int32 tensor.

The host decisions are the reference's, line for line: which request is
admitted, deferred, preempted, reaped, cancelled or failed, and when.
Where the reference gathers admitted rows into the slot batch with a
``where`` on the slot mask, the port writes them with ``index_copy_``
along each leaf's batch axis (1 for cache leaves, ``Proposer.state_axes``
for state leaves); the values are the same.

Admission paths (all eager: a prefill's shape changes with its bucket):

* **batched** (default): each admission round groups the queued requests
  by prompt bucket and prefills each group in one ``[n, bucket]`` call
  (n padded to a power of two), into the engine's scratch cache of n rows
  (dense) or straight into the global pool through the group's table rows
  (paged);
* **serial**: one ``[1, bucket]`` prefill per request;
* **prefix cache** (paged, ``prefix_cache=True``): a request's prompt
  blocks are matched against a registry (``serving.block_pool``); shared
  blocks map into its table refcounted, a partially matching divergence
  block is copied on write, and only the un-cached suffix runs, through
  ``SpecEngine.suffix_prefill``;
* **chunked prefill** (``sched.chunk_size``): a long prompt streams in
  through ``suffix_prefill`` one [B, chunk] call an iteration, beside the
  decode step.

Overload countermeasures (``SchedulerParams``): optimistic block
allocation with preempt-and-requeue of the latest-submitted request
(``preemption``, paged only: the resume folds the delivered tokens into
the prompt and recomputes, token for token at temperature 0), and
adaptive speculation (``adaptive_gamma``: a per-slot acceptance EMA picks
one of ``SpecEngine.step_dtrees``' levels each step, each its own
captured graph).

Fault tolerance: per-request step budgets and deadlines cancel
stragglers; a failed step re-queues every in-flight request (at-least-once)
and rebuilds every device buffer in place.  The only failure it catches
is its own ``ServerStepFailure`` (an injected step fault, or a pool
exhausted with no victim to preempt); every other error propagates.

The cache and the proposer state are opaque to the scheduler: the int8
cache, the deferred write, verify fusion and every proposer ride through
unchanged, and so do the MoE and VLM families' models (a VLM served on
its tokens alone, as the reference serves it).  The SSM and hybrid
families' recurrent state is per slot under every layout: paged
admission writes it into the admitted slots as dense admission writes
every leaf, copy-on-write touches only the attention pools, and every
masked slot of a step or a chunk call keeps its state bit for bit (the
model's commit restores the speculation root there; ``ssm_restores``
counts those slot-steps).  The prefix cache is refused for them, as the
reference refuses it: a shared KV block carries no recurrent state.

The encoder-decoder's requests carry their frames (``extra_embeds``
[frontend_len, frontend_dim], required there and refused for every other
family, as in the reference), kept on the host for the request's
lifetime: admission gathers each group's frames into its prefill, whose
encoder pass writes the slots' cross k/v, and a preempted request runs
its encoder again when it is re-admitted.  The cross k/v is per slot
under every layout, written at admission as a dense cache's leaves are,
and never the paged pool (``transformer.is_cache_rows``): paged
admission and copy-on-write leave it to its slot.  The prefix cache and
chunked prefill are refused for the encoder-decoder, as the reference
refuses them: both skip the whole-prompt prefill whose encoder pass
builds the cross k/v.
"""
from __future__ import annotations

import itertools
import time
import weakref
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.configs.base import SchedulerParams
from repro_torch.core.engine import SpecEngine
from repro_torch.kernels.paging import blocks_for
from repro_torch.models import api as model_api
from repro_torch.models.transformer import (PAGES_KEY, is_attn_entry,
                                             is_cache_rows)
from repro_torch.runtime import binding, copy_tree_, tree_map
from repro_torch.serving.block_pool import BlockPool, PrefixCache

NO_EOS = -1  # device-side "no eos configured" sentinel (token ids are >= 0)

_SERVERS = itertools.count()


class ServerStepFailure(RuntimeError):
    """A failed scheduler iteration that the server recovers from by
    re-queueing its in-flight requests (at-least-once): the injected step
    fault of ``step_once(fail_hook=)`` and a block pool exhausted with no
    preemptible victim.  Any other exception (a kernel that fails to
    build or launch, a device assert, a bug) propagates."""


def _along(mask, x, ax: int):
    """``mask`` [B] bool shaped to broadcast along axis ``ax`` of ``x``."""
    shp = [1] * x.dim()
    shp[ax] = -1
    return mask.reshape(shp)


def _put_rows(big, small, slots, rows, axis: int):
    """``big``'s entries ``slots`` along ``axis`` take ``small``'s entries
    ``rows`` (both [m] int64 on the device), in place."""
    big.index_copy_(axis, slots, small.index_select(axis, rows)
                    .to(big.dtype))


def cache_bytes_per_slot(cfg, max_len: int) -> int:
    """Attention KV-cache bytes one decode slot pins for its lifetime
    (values + int8 scales): the capacity term of the memory model.  At a
    fixed memory budget the slot count scales inversely with it, so the
    int8 layout buys about twice the slots."""
    return cfg.kv_cache_bytes_per_token() * max_len


def slots_for_budget(cfg, max_len: int, hbm_bytes: int) -> int:
    """Decode slots a ``hbm_bytes`` cache budget sustains at ``max_len``
    under the dense layout, where every slot pins its worst case."""
    return int(hbm_bytes // cache_bytes_per_slot(cfg, max_len))


def blocks_for_budget(cfg, hbm_bytes: int) -> int:
    """Physical pool blocks a ``hbm_bytes`` cache budget sustains under
    the paged layout: ``hbm / (kv_cache_bytes_per_token() * page_size)``
    (the sizing knob for ``SpecServer(n_blocks=...)``)."""
    return int(hbm_bytes // (cfg.kv_cache_bytes_per_token() * cfg.page_size))


@dataclass
class Request:
    """One serving request, entirely host-owned: admission lowers it into
    per-slot device tensors and ``output`` accumulates from the per-step
    ``SlotSync``.  ``first_token_s`` / ``finished_s`` are host clock
    readings (``time.monotonic``) of its first delivered token and of its
    reap, for latency reports."""
    rid: int
    prompt: np.ndarray                  # [len] int32
    max_new: int
    eos_id: Optional[int] = None
    deadline_s: Optional[float] = None  # wall-clock straggler bound
    max_steps: Optional[int] = None     # decode-step budget
    # per-request sampling controls, honoured when the engine runs
    # accept="sample"; temperature 0.0 is exact greedy, so greedy and
    # sampled requests share one static step
    temperature: float = 0.0
    top_p: float = 1.0
    # the encoder-decoder's frames [frontend_len, frontend_dim] float32,
    # kept for the request's lifetime: a preempted request encodes them
    # again at its re-admission
    frames: Optional[np.ndarray] = None
    submitted_at: float = field(default_factory=time.monotonic)
    output: List[int] = field(default_factory=list)
    steps: int = 0
    retries: int = 0
    preemptions: int = 0                # times evicted mid-flight
    status: str = "queued"              # queued|running|done|cancelled|failed
    first_token_s: Optional[float] = None
    finished_s: Optional[float] = None


@dataclass
class _Slot:
    request: Optional[Request] = None

    @property
    def free(self):
        return self.request is None


class SlotSync(NamedTuple):
    """The one per-step device->host read, as numpy (one copy of the step's
    [B, 3 + K + 1] sync tensor).  The host applies it mechanically: append
    ``tokens[i, :acc[i]]`` to slot i's request, reap where ``done``; the
    EOS scan, the budget clip and the masked commit already happened on
    the device."""
    acc: np.ndarray         # [B] int32 tokens to append (EOS/budget-clipped)
    tokens: np.ndarray      # [B, K+1] int32 this step's committed path
    done: np.ndarray        # [B] bool slot finished (EOS hit or budget met)
    spec_acc: np.ndarray    # [B] int32 raw verifier acceptance (what the
                            # commit advanced the length by): the host's
                            # committed-length mirror and acceptance EMA


def _pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


class SpecServer:
    """Continuous-batching server over one ``SpecEngine`` (any proposer).

    Host-owned state: the request ``queue``, per-slot ``Request`` bindings
    (``slots``), retry/deadline policy, numpy mirrors of the per-slot step
    inputs (``_active``/``_eos``/``_maxnew``/``_temp``/``_topp``) and,
    under the paged layout, the block allocator and table mirror.
    Device-owned state (static tensors, written in place): ``cache``,
    ``lengths`` [B] int32, ``base`` [B] int32, ``pstate`` (the proposer's
    state, merged per leaf along ``Proposer.state_axes``), ``n_out`` [B]
    int32, the slot metadata and the sync tensor.

    ``proposer_params`` are whatever the engine's proposer consumes:
    Medusa heads, draft-model weights, or None for the n-gram lookup.
    ``n_blocks`` sizes the paged pool (default: every slot's worst case,
    the dense layout's capacity; size it from a budget with
    ``blocks_for_budget``).  ``prefix_cache=True`` enables the
    shared-prefix registry (paged layout, proposers that can be primed
    from a prompt suffix).

    ``timing`` accumulates host-side readings: ``iterations`` and
    ``iter_s`` (seconds) over ``step_once``, ``step_s`` inside the decode
    step's replay and its sync read, ``admit_s`` inside admission and
    chunk calls, and ``suffix_calls``, the ``suffix_prefill`` calls
    (prefix-cache admissions and chunks: one commit launch each, like a
    decode step).
    """

    def __init__(self, engine: SpecEngine, params, proposer_params,
                 batch_slots: int, max_len: int,
                 prompt_buckets=(32, 128, 512), max_retries: int = 1,
                 admission: str = "batched", n_blocks: Optional[int] = None,
                 prefix_cache: bool = False,
                 sched: Optional[SchedulerParams] = None):
        assert admission in ("batched", "serial"), admission
        self.engine = engine
        self.cfg = engine.cfg
        self.model = engine.model
        self.device = engine.device
        self.params = params
        self.proposer_params = proposer_params
        self.B = batch_slots
        self.max_len = max_len
        self.sched = sched if sched is not None else SchedulerParams()
        # a bucket wider than the cache cannot be prefilled: clamp to
        # max_len so every prompt that fits the cache stays servable;
        # prompts beyond the largest bucket are rejected at admission
        self.buckets = tuple(sorted({min(b, max_len) for b in prompt_buckets}))
        self.max_retries = max_retries
        self.admission = admission

        # paged layout: the pool is the admission resource
        self.paged = self.cfg.paged
        self.page_size = self.cfg.page_size
        self.blocks_per_slot = blocks_for(max_len, self.page_size)
        if n_blocks is not None and not self.paged:
            raise ValueError("n_blocks requires cache_layout='paged'")
        self.n_blocks = (1 + self.B * self.blocks_per_slot
                         if n_blocks is None else int(n_blocks))
        if prefix_cache and not self.paged:
            raise ValueError("prefix_cache requires cache_layout='paged'")
        self.encdec = self.cfg.family == "encdec"
        if prefix_cache and (self.cfg.num_ssm_layers or self.encdec):
            # prefix-cache admission skips the prefill of matched tokens;
            # a shared KV block carries no recurrent or cross state to
            # restore from, so a hit would leave the slot's state cold
            # (the reference's message)
            raise ValueError(
                "prefix_cache shares KV blocks only; SSM/encdec state "
                "cannot be reconstructed from them (DESIGN.md §17 — use "
                "chunked prefill / preemption for these families)")
        if prefix_cache and not engine.proposer.supports_prefix:
            raise ValueError(
                f"prefix_cache needs a proposer that can be primed from a "
                f"prompt suffix; {type(engine.proposer).__name__} cannot")
        self.prefix_enabled = prefix_cache

        # overload countermeasures
        self.chunk = min(int(self.sched.chunk_size), max_len) \
            if self.sched.chunk_size else 0
        if self.chunk and not engine.proposer.supports_prefix:
            raise ValueError(
                f"chunked prefill rides the suffix_prefill path; "
                f"{type(engine.proposer).__name__} cannot be primed from a "
                "suffix")
        if self.chunk and self.encdec:
            # the cross k/v comes from the encoder pass inside the
            # whole-prompt prefill, which a chunk does not run
            raise ValueError(
                "chunked prefill cannot split an encoder-decoder prompt: "
                "the cross-attention cache is built by the encoder pass "
                "inside whole-prompt prefill")
        self.preemption = bool(self.sched.preemption)
        if self.preemption and not self.paged:
            raise ValueError("preemption (optimistic block allocation) "
                             "requires cache_layout='paged': the dense "
                             "layout has no pool to exhaust")
        self.adaptive = bool(self.sched.adaptive_gamma)

        self.queue: deque[Request] = deque()
        self.slots = [_Slot() for _ in range(self.B)]
        self.done: Dict[int, Request] = {}
        self._rid = 0
        # repr of each ServerStepFailure recovered from, oldest first
        self.failures: List[str] = []

        # the adaptive-speculation family: one captured step per level,
        # selected on the host
        self._levels = (engine.step_dtrees(self.sched.gamma_levels)
                        if self.adaptive else [(engine.dtree.K, engine.dtree)])
        self._level = len(self._levels) - 1   # start at full speculation
        self.stats = self._fresh_stats()
        self.timing = self._fresh_timing()

        # the captured steps live in the engine's step_graphs under keys of
        # this server, dropped with it
        self._uid = next(_SERVERS)
        self._graph_keys: set = set()
        weakref.finalize(self, engine.step_graphs.drop, self._graph_keys)

        self._alloc_device_state()
        self._reset_device_state()

        # host mirrors of the per-slot device bookkeeping inputs
        self._active = np.zeros((self.B,), bool)
        self._eos = np.full((self.B,), NO_EOS, np.int32)
        self._maxnew = np.zeros((self.B,), np.int32)
        self._temp = np.zeros((self.B,), np.float32)   # per-request sampling
        self._topp = np.ones((self.B,), np.float32)
        self._done_now = np.zeros((self.B,), bool)
        self._meta_dirty = True     # the device metadata needs a refresh
        # committed-length mirror (tracks the raw SlotSync.spec_acc, which
        # is what the commit advanced by), the per-slot acceptance EMA, and
        # the mid-chunk prefill cursors
        self._len_host = np.zeros((self.B,), np.int64)
        self._acc_ema = np.ones((self.B,), np.float64)
        self._chunk_state: Dict[int, dict] = {}

        # the device calls, one attribute each (the tests wrap them to
        # inject failures after the real call)
        self._admit_fn = (self._prefill_group_paged if self.paged
                          else self._prefill_group)
        self._step_fn = self._replay_step
        self._suffix_fn = self._suffix_rows
        self._copy_fn = self._copy_blocks
        self._trim_fn = self._trim_rows
        self._prime_fn = self._prime_rows

    def _fresh_stats(self) -> dict:
        return {"prefill_calls": 0, "admitted": 0, "steps": 0,
                "deferred": 0, "prefill_tokens": 0, "cached_tokens": 0,
                "cow_copies": 0, "peak_blocks": 0,
                # overload counters
                "chunk_calls": 0, "preemptions": 0, "resumed": 0,
                "reclaimed_blocks": 0, "grown_blocks": 0,
                "gamma_steps": {g: 0 for g, _ in self._levels},
                # slot-steps whose SSM recurrent state was restored (0
                # for a family without SSM positions)
                "ssm_restores": 0}

    @staticmethod
    def _fresh_timing() -> dict:
        return {"iterations": 0, "iter_s": 0.0, "step_s": 0.0,
                "admit_s": 0.0, "suffix_calls": 0}

    # ------------------------------------------------------------------ API

    def submit(self, prompt: np.ndarray, max_new: int, eos_id=None,
               deadline_s=None, max_steps=None,
               temperature: Optional[float] = None,
               top_p: Optional[float] = None, extra_embeds=None) -> int:
        """``temperature``/``top_p`` take effect when the engine verifies
        with ``accept="sample"``; omitted values fall back to the engine's
        ``SamplingParams``, and temperature 0.0 reproduces greedy output
        exactly.  ``extra_embeds`` [frontend_len, frontend_dim] (the
        stub encoder's frames) is required for the encoder-decoder and
        refused for every other family, as the reference does: a
        decoder-only model's frontend prefix is not per-request state in
        the server."""
        sp = self.engine.sampling
        if self.encdec:
            if extra_embeds is None:
                raise ValueError(
                    "encdec requests need extra_embeds [frontend_len, "
                    "frontend_dim]: the encoder pass runs at admission")
            extra_embeds = np.asarray(extra_embeds, np.float32)
            want = self._frames_shape()
            if extra_embeds.shape != want:
                raise ValueError(
                    f"extra_embeds shape {extra_embeds.shape} != {want}")
        elif extra_embeds is not None:
            raise ValueError(
                f"extra_embeds is encdec-only; {self.cfg.family!r} requests "
                f"carry token ids (decoder-only frontends fold their prefix "
                f"in at prefill, outside the server)")
        if (self.cfg.verify_fusion and self.engine.accept == "sample"
                and top_p is not None and top_p != 1.0):
            # the fused epilogue keeps only Verdict-sized statistics; a
            # top-p warp needs the sorted full row
            raise ValueError("verify_fusion rejects per-request top_p != 1.0")
        self._rid += 1
        self.queue.append(Request(
            self._rid, np.asarray(prompt, np.int32), max_new, eos_id,
            deadline_s, max_steps or 4 * max_new,
            temperature=sp.temperature if temperature is None else temperature,
            top_p=sp.top_p if top_p is None else top_p, frames=extra_embeds))
        return self._rid

    def result(self, rid: int) -> Optional[Request]:
        return self.done.get(rid)

    @property
    def busy(self) -> bool:
        """True while any work is queued or in flight."""
        return bool(self.queue) or any(not s.free for s in self.slots)

    def step_once(self, fail_hook: Optional[Callable[[int], bool]] = None,
                  it: int = 0):
        """One scheduler iteration: batched admit -> chunk advance ->
        decode step -> batched reap.  ``fail_hook(it)`` returning True
        simulates a step failure.  Admission, the chunk advance and the
        decode step sit inside the recovery scope: a failure in any of
        them re-queues the in-flight requests and rebuilds the device
        state (requests attach to slots before their prefill, so
        ``_recover`` sees them)."""
        t0 = time.perf_counter()
        try:
            self._admit()
            if fail_hook is not None and fail_hook(it):
                raise ServerStepFailure("injected step failure")
            self._chunk_step()
            self._decode_step()
        except ServerStepFailure as e:
            self.failures.append(repr(e))
            self._recover()
        self._reap()
        self.timing["iterations"] += 1
        self.timing["iter_s"] += time.perf_counter() - t0

    def run(self, max_iters: int = 10_000,
            fail_hook: Optional[Callable[[int], bool]] = None):
        """Drive until all work is done."""
        it = 0
        while self.busy and it < max_iters:
            self.step_once(fail_hook, it)
            it += 1
        return it

    def release_all(self):
        """Cancel and resolve every queued and in-flight request (a test
        helper; the device state is dead until the slots are
        re-admitted)."""
        for req in list(self.queue):
            req.status = "cancelled"
            self.done[req.rid] = req
        self.queue.clear()
        for i, slot in enumerate(self.slots):
            if slot.request is not None:
                slot.request.status = "cancelled"
                self.done[slot.request.rid] = slot.request
                slot.request = None
            if self.paged:
                self.pool.free(self._slot_alloc.pop(i, []))
                self._table[i, :] = 0
                self._matched[i] = 0
        if self.paged:
            self._table_dirty = True
        self._reset_host_slots()

    def reset(self):
        """Fresh server, warm graphs: drop every queued / in-flight /
        finished request, zero the stats and rebuild the device state in
        place, keeping every captured step, so a test or a benchmark can
        run many scenarios on one ``SpecServer``."""
        self.queue.clear()
        self.done.clear()
        self.failures.clear()
        for slot in self.slots:
            slot.request = None
        self.stats = self._fresh_stats()
        self.timing = self._fresh_timing()
        self._level = len(self._levels) - 1
        self._reset_device_state()
        self._reset_host_slots()

    def _reset_host_slots(self):
        """Clear every host per-slot mirror to the no-tenant state."""
        self._active[:] = False
        self._done_now[:] = False
        self._len_host[:] = 0
        self._acc_ema[:] = 1.0
        self._chunk_state.clear()
        self._meta_dirty = True

    # --------------------------------------------------------- device code

    def _prefill_group(self, toks, plens, gtemp, gtopp, slots, rows,
                       frames=None):
        """Prefill one bucket group [n, bucket] into the engine's scratch
        cache of n rows and write the group's rows ``rows`` [m] into the
        slots ``slots`` [m] of the B-slot state (cache leaves along axis
        1, proposer-state leaves along their declared axes).  ``gtemp`` /
        ``gtopp`` [n] are the rows' sampling controls (a sample-mode
        engine draws each base token at its own temperature); ``frames``
        [n, F, fd] the encoder-decoder's (None for other families)."""
        n = toks.shape[0]
        cache_n = self.engine.init_cache(n, self.max_len)
        st_n = self.engine.init_proposer_state(n, self.max_len)
        cache_n, len_n, base_n, st_n = self.engine.prefill(
            self.params, self.proposer_params, toks, plens, cache_n,
            extra_embeds=frames, state=st_n, temperature=gtemp, top_p=gtopp)
        for pos, entry in self.cache.items():
            for name, t in entry.items():
                _put_rows(t, cache_n[pos][name], slots, rows, 1)
        self._merge_state(st_n, slots, rows, len_n, base_n)

    def _prefill_group_paged(self, toks, plens, gtemp, gtopp, slots, rows,
                             gtable, frames=None):
        """Paged variant of ``_prefill_group``: the attention positions'
        prefill writes land in the global pool through ``gtable``
        [n, max_blocks] (the admitted slots' table rows; padding rows are
        all-zero, so their writes sink into the trash block).  Per-slot
        entries (an SSM position's state, the encoder-decoder's cross
        k/v) are prefilled into fresh n-row leaves and their rows ``rows``
        written into the slots ``slots``, as ``_prefill_group`` writes
        every leaf; then the [B]-sized step state and the proposer state
        merge."""
        n = toks.shape[0]
        view = {}
        for pos, entry in self.cache.items():
            if pos == PAGES_KEY or is_cache_rows(pos, entry):
                view[pos] = entry               # the shared pool
            else:
                view[pos] = {name: t.new_zeros((t.shape[0], n)
                                               + t.shape[2:])
                             for name, t in entry.items()}
        view[PAGES_KEY] = {"table": gtable}
        st_n = self.engine.init_proposer_state(n, self.max_len)
        _, len_n, base_n, st_n = self.engine.prefill(
            self.params, self.proposer_params, toks, plens, view,
            extra_embeds=frames, state=st_n, temperature=gtemp, top_p=gtopp)
        for pos, entry in self.cache.items():
            if pos != PAGES_KEY and not is_cache_rows(pos, entry):
                for name, t in entry.items():
                    _put_rows(t, view[pos][name], slots, rows, 1)
        self._merge_state(st_n, slots, rows, len_n, base_n)

    def _merge_state(self, st_n, slots, rows, len_n, base_n):
        """The admitted rows' proposer state, lengths and base into their
        slots; their ``n_out`` to 0."""
        tree_map(lambda big, small, ax: _put_rows(big, small, slots, rows,
                                                  ax),
                 self.pstate, st_n, self._sax)
        _put_rows(self.lengths, len_n, slots, rows, 0)
        _put_rows(self.base, base_n, slots, rows, 0)
        self.n_out.index_fill_(0, slots, 0)

    def _suffix_rows(self, stoks, nv, mlen, smask, temp, topp):
        """Continue prefill from cached rows for the slots in ``smask``
        [B] bool: prefix-cache admission and chunked prefill.

        stoks [B, T] right-padded suffix tokens (garbage on other rows),
        nv [B] true suffix lengths (1 on other rows), mlen [B] the rows
        already cached.  All B slots run the same causal decode; only
        ``smask`` rows take their new lengths, base and proposer state.

        Dead writes: another slot admitted in the same round already has
        its new table installed but not yet its length, so writing at its
        stale length could corrupt the shared prefix blocks its table now
        maps.  Every slot outside ``smask`` therefore runs at length =
        capacity: its rows fall past the table (paged: trash block 0) or
        past the cache's end (dense: dropped), and its real length stays."""
        cap = (self.blocks_per_slot * self.page_size if self.paged
               else self.max_len)
        self._fresh_recurrent_state(smask & (mlen == 0))
        lens_in = torch.where(smask, mlen, torch.full_like(mlen, cap))
        st_n = self.engine.init_proposer_state(self.B, self.max_len)
        _, lens_new, base_n, st_n = self.engine.suffix_prefill(
            self.params, self.proposer_params, self.cache, lens_in, stoks,
            nv, smask, temperature=temp, top_p=topp, state=st_n)
        self.lengths.copy_(torch.where(smask, lens_new, self.lengths))
        self.base.copy_(torch.where(smask, base_n, self.base))
        tree_map(lambda big, small, ax: big.copy_(torch.where(
            _along(smask, big, ax), small.to(big.dtype), big)),
            self.pstate, st_n, self._sax)
        self.n_out.copy_(torch.where(smask, torch.zeros_like(self.n_out),
                                     self.n_out))

    def _fresh_recurrent_state(self, rows):
        """Zero the SSM positions' state of the slots ``rows`` [B] bool
        marks: a suffix call from no cached row (a chunked prefill's first
        chunk) starts from the state before any token, not from the last
        tenant's.  (The reference starts it from the last tenant's state,
        so its chunked answers on a reused slot are not AR's.)"""
        for pos, entry in self.cache.items():
            if pos != PAGES_KEY and not is_attn_entry(entry):
                for t in entry.values():
                    t.masked_fill_(_along(rows, t, 1), 0)

    def _copy_blocks(self, src, dst):
        """Copy-on-write: pool rows of physical blocks ``src`` [m] copy
        into blocks ``dst`` [m] across every attention pool leaf (values
        and int8 scales share one block id space; an SSM position's
        per-slot state and the encoder-decoder's cross k/v are no pool).
        Padding pairs are (0, 0): a trash-to-trash no-op."""
        for pos, entry in self.cache.items():
            if not is_cache_rows(pos, entry):
                continue
            for name, x in entry.items():
                x.index_copy_(1, dst, x.index_select(1, src))

    def _trim_rows(self, keep):
        """Zero the proposer-state rows of slots where ``keep`` [B] is
        False (a preempted tenant's history or draft cache)."""
        copy_tree_(self.pstate, self.engine.proposer.reset_rows(self.pstate,
                                                                keep))

    def _prime_rows(self, toks, tl, mask):
        """Re-prime the ``mask`` rows of a token-lookup proposer's state
        from token ids alone."""
        copy_tree_(self.pstate, self.engine.proposer.prime_tokens(
            self.pstate, toks, tl, self.base, mask))

    def _step_body(self, dtree):
        """One masked speculative step on the static state, and the
        on-device bookkeeping: the EOS scan over the accepted tokens, the
        budget clip and the done mask, written with the raw acceptance
        and the path's tokens into the sync tensor, the step's one
        device->host read.  The body of the captured graph of the level
        whose topology is ``dtree``."""
        active = self._active_dev
        _, lengths, verdict, state = self.engine.spec_step(
            self.params, self.proposer_params, self.cache, self.lengths,
            self.base, self.pstate, temperature=self._temp_dev,
            top_p=self._topp_dev, active=active, dtree=dtree)
        eos_id, max_new = self._eos_dev, self._maxnew_dev
        toks = verdict.path_tokens.to(torch.int32)
        K1 = toks.shape[1]
        pos = torch.arange(K1, device=toks.device)
        within = pos[None, :] < verdict.acc[:, None]
        is_eos = (within & (toks == eos_id[:, None])
                  & (eos_id != NO_EOS)[:, None])
        has_eos = torch.any(is_eos, dim=1)
        eos_pos = torch.argmax(is_eos.to(torch.int32), dim=1).to(torch.int32)
        n_take = torch.where(has_eos, eos_pos + 1, verdict.acc)
        n_take = torch.minimum(n_take, torch.clamp(max_new - self.n_out,
                                                   min=0))
        zero = torch.zeros_like(n_take)
        n_take = torch.where(active, n_take, zero)
        self.n_out.add_(n_take)
        done = active & ((self.n_out >= max_new) | has_eos)
        self.lengths.copy_(lengths)
        self.base.copy_(verdict.next_token)
        copy_tree_(self.pstate, state)
        sync = self._sync_dev
        sync[:, 0].copy_(n_take)
        sync[:, 1].copy_(done.to(torch.int32))
        sync[:, 2].copy_(torch.where(active, verdict.acc, zero))
        sync[:, 3:3 + K1].copy_(toks)

    def _serve_graph(self, level: int):
        """The captured step of ``level``, kept in the engine's
        ``step_graphs`` under this server's key while the weights and the
        static state are the same tensors."""
        eng = self.engine
        key = ("serve", self._uid, level)
        dtree = self._levels[level][1]
        srv = weakref.ref(self)
        draws_from = () if eng.accept == "greedy" else (eng.generator,)

        def make():
            return eng.step_graphs.graph(
                lambda: srv()._step_body(dtree), draws_from), None

        self._graph_keys.add(key)
        graph, _ = eng.step_graphs.get(key, binding(
            self.params, self.proposer_params, self._static_state(),
            *draws_from), make)
        return graph

    def step_graphs(self) -> dict:
        """{gamma: StepGraph} of the levels whose step has run."""
        out = {}
        for level, (gamma, _) in enumerate(self._levels):
            pair = self.engine.step_graphs.held(("serve", self._uid, level))
            if pair is not None:
                out[gamma] = pair[0]
        return out

    def _replay_step(self, level: int):
        """Run (replay) the captured step of ``level``; -> the sync
        tensor."""
        self._serve_graph(level)()
        return self._sync_dev

    # ------------------------------------------------------------- internals

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def _tensor(self, a):
        """A host numpy array as a tensor on the server's device."""
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _effective(self, req: Request):
        """(effective prompt, remaining max_new) for (re-)admission.  A
        preempted request resumes by folding its delivered tokens into the
        prompt: the re-admission recomputes (or prefix-matches) exactly
        the sequence its first tenure committed, so at temperature 0 the
        resumed continuation is token-identical to a never-preempted
        run."""
        if req.output:
            return (np.concatenate([req.prompt,
                                    np.asarray(req.output, np.int32)]),
                    req.max_new - len(req.output))
        return req.prompt, req.max_new

    def _admit(self):
        """Admission round (host): drain the queue into free slots.

        Dense: the free-slot count is the only resource.  Paged: each
        request must also reserve its blocks from the pool, its worst case
        (``prompt + max_new + T + 2`` tokens) by default, or optimistically
        (``prompt + T + 2``, grown by ``_ensure_blocks``) under
        ``sched.preemption``.  ``_plan_blocks`` returning None defers the
        request (queue head, FIFO kept) until a reap frees blocks.
        Prefix-matched requests admit through the suffix path; prompts
        longer than ``sched.chunk_size`` only install their slot here and
        stream through ``_chunk_step``; the rest go through the bucketed
        group prefill."""
        t0 = time.perf_counter()
        free = [i for i, s in enumerate(self.slots) if s.free]
        take: List[tuple] = []
        while self.queue and len(take) < len(free):
            req = self.queue.popleft()
            p_ext, mn = self._effective(req)
            # reject what cannot run losslessly: prompts that do not fit
            # the cache, or (chunking off) exceed the largest bucket;
            # under optimistic allocation also a request whose worst case
            # exceeds the whole pool (its growth could never be served)
            if (len(p_ext) + mn + self.engine.dtree.T + 2 > self.max_len
                    or (not self.chunk and len(p_ext) > self.buckets[-1])
                    or (self.paged and self.preemption and
                        blocks_for(len(p_ext) + mn + self.engine.dtree.T + 2,
                                   self.page_size) > self.n_blocks - 1)):
                req.status = "failed"
                self.done[req.rid] = req
                continue
            plan = self._plan_blocks(req, p_ext, mn) if self.paged else None
            if self.paged and plan is None:
                # pool exhausted: defer, at the head, and stop admitting so
                # the order is kept
                self.queue.appendleft(req)
                self.stats["deferred"] += 1
                break
            take.append((req, plan, p_ext, mn))
        if not take:
            return
        pairs = []          # (slot, req, p_ext) for this round's prefills
        cows = []
        for i, (req, plan, p_ext, mn) in zip(free, take):
            req.status = "running"
            self.slots[i].request = req
            if req.output:
                self.stats["resumed"] += 1
            self._eos[i] = NO_EOS if req.eos_id is None else req.eos_id
            self._maxnew[i] = mn
            self._temp[i] = req.temperature
            self._topp[i] = req.top_p
            self._acc_ema[i] = 1.0
            matched = 0
            if plan is not None:
                row = plan["shared"] + plan["fresh"]
                self._table[i, :] = 0
                self._table[i, : len(row)] = row
                self._table_dirty = True
                self._slot_alloc[i] = row
                self._matched[i] = plan["matched"]
                matched = plan["matched"]
                if plan["cow"] is not None:
                    cows.append((plan["cow"], plan["fresh"][0]))
            if self.chunk and len(p_ext) - matched > self.chunk:
                # chunked prefill: the slot holds its request but stays
                # inactive; _chunk_step streams the prompt in
                self._chunk_state[i] = {"toks": p_ext, "pos": matched}
                self._active[i] = False
                self._len_host[i] = matched
            else:
                self._active[i] = True
                self._len_host[i] = len(p_ext)
                pairs.append((i, req, p_ext))
        self._meta_dirty = True
        self.stats["admitted"] += len(take)
        try:
            if self.paged:
                self._admit_paged(pairs, cows)
            elif self.admission == "serial":
                for i, req, p_ext in pairs:
                    self._prefill_one(req, i, p_ext)
            else:
                self._admit_batched(pairs)
        finally:
            self.timing["admit_s"] += time.perf_counter() - t0

    # ---- paged admission (host side) -------------------------------------

    def _plan_blocks(self, req: Request, p_ext: np.ndarray, mn: int):
        """Reserve blocks for ``req`` (all-or-nothing; None = defer).

        The default reservation is the worst case (``p_ext + mn + T + 2``
        tokens); under ``sched.preemption`` it is the prompt plus one
        step of slack (``p_ext + T + 2``).  Returns {"shared": [ids],
        "fresh": [ids], "matched": int, "cow": src_block|None}: ``shared``
        blocks hold an already-cached prompt prefix (refcount bumped),
        ``fresh`` are newly owned, ``matched`` counts the cached prompt
        tokens, and ``cow`` is the donor block of a partial match at the
        divergence block, to copy into ``fresh[0]`` before the suffix
        prefill (pinned until ``_admit_paged`` has copied it).  The
        matched blocks are pinned before eviction and allocation run, so
        a registry-only matched block can be neither evicted nor handed
        back as one of this request's fresh blocks."""
        shared, div_block, div_tokens = [], None, 0
        if self.prefix is not None:
            shared, div_block, div_tokens = self.prefix.match(p_ext)
        pinned = shared + ([div_block] if div_tokens else [])
        self.pool.share(pinned)
        need_tokens = len(p_ext) + self.engine.dtree.T + 2
        if not self.preemption:
            need_tokens += mn           # worst-case reservation
        total = blocks_for(need_tokens, self.page_size)
        n_fresh = total - len(shared)
        shortfall = n_fresh - self.pool.available
        if shortfall > 0 and self.prefix is not None:
            self.prefix.evict(self.pool, shortfall)   # all-or-nothing
        fresh = self.pool.alloc(n_fresh)
        if fresh is None:
            self.pool.free(pinned)                    # undo the pins
            if pinned:
                # fall back to a no-sharing plan: unpinned, the match may
                # be evicted, and a full prefill beats deferring forever
                # when the only reclaimable space is the matched prefix
                shortfall = total - self.pool.available
                if shortfall > 0:
                    self.prefix.evict(self.pool, shortfall)
                fresh = self.pool.alloc(total)
                if fresh is not None:
                    return {"shared": [], "fresh": fresh, "matched": 0,
                            "cow": None}
            return None
        matched = len(shared) * self.page_size + div_tokens
        return {"shared": shared, "fresh": fresh, "matched": matched,
                "cow": div_block if div_tokens else None}

    def _admit_paged(self, pairs, cows):
        """Execute a planned paged admission round: push the tables, run
        the CoW copies, group-prefill the unmatched requests,
        suffix-prefill the matched ones, then register the new prompts in
        the prefix cache.  Chunked slots are not in ``pairs``: their table
        rows and CoW copies are installed here, their prefill streams
        through ``_chunk_step``."""
        self._push_table()
        if cows:
            n = _pow2(len(cows))
            src = np.zeros((n,), np.int64)
            dst = np.zeros((n,), np.int64)     # pad pairs: trash -> trash
            for j, (s, d) in enumerate(cows):
                src[j], dst[j] = s, d
            self._copy_fn(self._tensor(src), self._tensor(dst))
            self.pool.free([s for s, _ in cows])   # release the cow pins
            self.stats["cow_copies"] += len(cows)
        full = [p for p in pairs if self._matched[p[0]] == 0]
        pref = [p for p in pairs if self._matched[p[0]] > 0]
        if self.admission == "serial":
            for pair in full:
                self._admit_batched([pair])
        elif full:
            self._admit_batched(full)
        for i, req, p_ext in pref:
            self._admit_suffix_one(i, p_ext, self._matched[i])
        for i, req, p_ext in pairs:
            self.stats["prefill_tokens"] += len(p_ext) - self._matched[i]
            self.stats["cached_tokens"] += self._matched[i]
            if self.prefix is not None:
                self.prefix.register(p_ext, self._table[i], self.pool)
        self.stats["peak_blocks"] = max(self.stats["peak_blocks"],
                                        self.pool.in_use)

    def _admit_suffix_one(self, slot_idx: int, p_ext: np.ndarray,
                          matched: int):
        """Admit one prefix-matched request: a causal suffix prefill over
        the slot's already mapped cached prefix, one [B, suffix_bucket]
        call per request."""
        suffix = p_ext[matched:]
        bucket = self._bucket(len(suffix))
        stoks = np.zeros((self.B, bucket), np.int32)
        stoks[slot_idx, : len(suffix)] = suffix[:bucket]
        nv = np.ones((self.B,), np.int32)
        nv[slot_idx] = len(suffix)
        mlen = np.zeros((self.B,), np.int32)
        mlen[slot_idx] = matched
        smask = np.zeros((self.B,), bool)
        smask[slot_idx] = True
        self.timing["suffix_calls"] += 1
        self._suffix_fn(self._tensor(stoks), self._tensor(nv),
                        self._tensor(mlen), self._tensor(smask),
                        self._tensor(self._temp), self._tensor(self._topp))
        if self.engine.proposer.primes_from_tokens:
            self._prime_full_history(slot_idx, p_ext)
        self.stats["prefill_calls"] += 1

    def _prime_full_history(self, slot_idx: int, p_ext: np.ndarray):
        """Re-prime a token-lookup proposer with the full prompt after a
        prefix-cache suffix admission (the suffix call primes it from the
        un-cached suffix only).  Bucketed like admission; a prompt past
        the largest bucket keeps its most recent window.  Proposals only
        change the hit rate, never the verified output."""
        W = self._bucket(min(len(p_ext), self.buckets[-1]))
        window = p_ext[-W:] if len(p_ext) > W else p_ext
        ptoks = np.zeros((self.B, W), np.int32)
        ptoks[slot_idx, : len(window)] = window
        tl = np.ones((self.B,), np.int32)
        tl[slot_idx] = len(window)
        pmask = np.zeros((self.B,), bool)
        pmask[slot_idx] = True
        self._prime_fn(self._tensor(ptoks), self._tensor(tl),
                       self._tensor(pmask))

    def _admit_batched(self, pairs):
        """Group the admitted requests by prompt bucket and prefill each
        group in one call (the host builds the [n, bucket] inputs).  Under
        the paged layout the group's table rows ride along (padding rows
        all-zero: trash-sunk writes), and for the encoder-decoder the
        group's frames [n, F, fd] (padding rows zero)."""
        groups: Dict[int, list] = {}
        for i, req, p_ext in pairs:
            groups.setdefault(self._bucket(len(p_ext)), []).append(
                (i, req, p_ext))
        for bucket, grp in groups.items():
            n = _pow2(len(grp))
            toks = np.zeros((n, bucket), np.int32)
            plens = np.ones((n,), np.int32)      # padding rows: length 1
            gtemp = np.zeros((n,), np.float32)
            gtopp = np.ones((n,), np.float32)
            slots = np.zeros((len(grp),), np.int64)
            rows = np.arange(len(grp), dtype=np.int64)
            gtable = (np.zeros((n, self.blocks_per_slot), np.int32)
                      if self.paged else None)
            gframes = (np.zeros((n,) + self._frames_shape(), np.float32)
                       if self.encdec else None)
            for j, (i, req, p_ext) in enumerate(grp):
                toks[j, : len(p_ext)] = p_ext[:bucket]
                plens[j] = len(p_ext)
                gtemp[j] = req.temperature
                gtopp[j] = req.top_p
                slots[j] = i
                if self.paged:
                    gtable[j] = self._table[i]
                if self.encdec:
                    gframes[j] = req.frames
            extra = (self._tensor(gtable),) if self.paged else ()
            if self.encdec:
                extra += (self._tensor(gframes),)
            self._admit_fn(self._tensor(toks), self._tensor(plens),
                           self._tensor(gtemp), self._tensor(gtopp),
                           self._tensor(slots), self._tensor(rows), *extra)
            self.stats["prefill_calls"] += 1

    def _prefill_one(self, req: Request, slot_idx: int,
                     p_ext: Optional[np.ndarray] = None):
        """Serial admission (dense): one [1, bucket] group prefill, written
        into slot ``slot_idx``."""
        p_ext = req.prompt if p_ext is None else p_ext
        bucket = self._bucket(len(p_ext))
        toks = np.zeros((1, bucket), np.int32)
        toks[0, : len(p_ext)] = p_ext[:bucket]
        frames = ((self._tensor(req.frames[None]),) if self.encdec else ())
        self._admit_fn(
            self._tensor(toks), self._tensor(np.array([len(p_ext)],
                                                      np.int32)),
            self._tensor(np.array([req.temperature], np.float32)),
            self._tensor(np.array([req.top_p], np.float32)),
            self._tensor(np.array([slot_idx], np.int64)),
            self._tensor(np.zeros((1,), np.int64)), *frames)
        self.stats["prefill_calls"] += 1

    def _frames_shape(self):
        """One request's frames: (frontend_len, frontend_dim)."""
        return (self.cfg.frontend_len,
                self.cfg.frontend_dim or self.cfg.d_model)

    def _push_table(self):
        """Copy the host block-table mirror into the device table when it
        changed (tables change only at admission, growth and reap, never
        inside a step)."""
        if self.paged and self._table_dirty:
            self.cache[PAGES_KEY]["table"].copy_(
                torch.from_numpy(self._table))
            self._table_dirty = False

    def _push_meta(self):
        """Copy the host slot metadata into the step's device tensors when
        it changed."""
        if not self._meta_dirty:
            return
        for dst, src in ((self._active_dev, self._active),
                         (self._eos_dev, self._eos),
                         (self._maxnew_dev, self._maxnew),
                         (self._temp_dev, self._temp),
                         (self._topp_dev, self._topp)):
            dst.copy_(torch.from_numpy(src))
        self._meta_dirty = False

    def _chunk_step(self):
        """Advance every mid-chunk slot by one ``chunk_size`` piece in one
        ``suffix_prefill`` call of the fixed [B, chunk] shape.  A slot
        whose last chunk lands here becomes active (its base token and
        primed proposer state come from this call) and, under the paged
        layout, registers its prompt in the prefix registry."""
        if not self._chunk_state:
            return
        t0 = time.perf_counter()
        self._push_table()
        C = self.chunk
        stoks = np.zeros((self.B, C), np.int32)
        nv = np.ones((self.B,), np.int32)
        mlen = np.zeros((self.B,), np.int32)
        smask = np.zeros((self.B,), bool)
        finishing = []
        for i, cs in self._chunk_state.items():
            toks, pos = cs["toks"], cs["pos"]
            n = min(C, len(toks) - pos)
            stoks[i, :n] = toks[pos:pos + n]
            nv[i] = n
            mlen[i] = pos
            smask[i] = True
            cs["pos"] = pos + n
            if cs["pos"] >= len(toks):
                finishing.append(i)
        self.timing["suffix_calls"] += 1
        self._suffix_fn(self._tensor(stoks), self._tensor(nv),
                        self._tensor(mlen), self._tensor(smask),
                        self._tensor(self._temp), self._tensor(self._topp))
        self.stats["chunk_calls"] += 1
        self.stats["prefill_calls"] += 1
        if self.cfg.num_ssm_layers:
            # every slot outside the chunk mask ran this call masked: its
            # recurrent state is the one it had (the restore)
            self.stats["ssm_restores"] += int(self.B - smask.sum())
        for i, cs in self._chunk_state.items():
            self._len_host[i] = cs["pos"]
            self.stats["prefill_tokens"] += int(nv[i])
        for i in finishing:
            cs = self._chunk_state.pop(i)
            self._active[i] = True
            self._acc_ema[i] = 1.0
            self._meta_dirty = True
            if self.prefix is not None:
                self.prefix.register(cs["toks"], self._table[i], self.pool)
        self.timing["admit_s"] += time.perf_counter() - t0

    # ---- optimistic allocation + preemption (host side) -------------------

    def _ensure_blocks(self):
        """Grow every active slot's block table to reach ``len + T + 2``
        rows before the decode step writes there.  On pool exhaustion:
        evict registry-only prefix blocks first, then preempt the
        latest-submitted running request and retry, possibly preempting
        the very slot being grown (admission guarantees any admitted
        request fits an otherwise-empty pool, so the loop ends)."""
        T2 = self.engine.dtree.T + 2
        for i in range(self.B):
            if not self._active[i]:
                continue
            need = blocks_for(int(self._len_host[i]) + T2, self.page_size)
            have = len(self._slot_alloc.get(i, []))
            while need > have:
                short = need - have
                if short > self.pool.available and self.prefix is not None:
                    self.prefix.evict(self.pool, short - self.pool.available)
                fresh = self.pool.alloc(short)
                if fresh is None:
                    if not self._preempt_lowest():
                        raise ServerStepFailure(
                            "block pool exhausted with no preemptible "
                            "victim")
                    if not self._active[i]:
                        break              # this very slot was the victim
                    continue
                row = self._slot_alloc[i]
                self._table[i, have:need] = fresh
                row.extend(fresh)
                self._table_dirty = True
                self.stats["grown_blocks"] += len(fresh)
                have = need
        self.stats["peak_blocks"] = max(self.stats["peak_blocks"],
                                        self.pool.in_use)

    def _preempt_lowest(self) -> bool:
        """Preempt the lowest-priority preemptible tenant (priority =
        submission order: the latest rid goes first).  False if none can
        be preempted."""
        cand = sorted((i for i, s in enumerate(self.slots)
                       if s.request is not None),
                      key=lambda i: self.slots[i].request.rid, reverse=True)
        for i in cand:
            if self._preempt(i):
                return True
        return False

    def _preempt(self, i: int) -> bool:
        """Preempt-and-requeue slot ``i``: release its blocks (registered
        ones survive in the registry for the resume to match), trim its
        proposer-state rows, and put the request back at the queue head
        with its delivered tokens folded into the resume prompt
        (``_effective``).  False when the request could not resume
        losslessly (its extended prompt no longer fits a prefill bucket
        and chunking is off)."""
        req = self.slots[i].request
        if req is None:
            return False
        if not self.chunk and \
                len(req.prompt) + len(req.output) > self.buckets[-1]:
            return False
        req.preemptions += 1
        req.status = "queued"
        self.queue.appendleft(req)
        self.slots[i].request = None
        self._active[i] = False
        self._done_now[i] = False
        self._chunk_state.pop(i, None)
        self._len_host[i] = 0
        self._meta_dirty = True
        if self.paged:
            self.pool.free(self._slot_alloc.pop(i, []))
            self._table[i, :] = 0
            self._matched[i] = 0
            self._table_dirty = True
        keep = np.ones((self.B,), bool)
        keep[i] = False
        self._trim_fn(self._tensor(keep))
        self.stats["preemptions"] += 1
        return True

    def _pick_level(self):
        """Select this step's speculation level: move one level at a time
        on the active slots' mean acceptance EMA, with
        ``adapt_low``/``adapt_high`` hysteresis."""
        if not self.adaptive or not self._active.any():
            return
        mean = float(self._acc_ema[self._active].mean())
        if mean < self.sched.adapt_low and self._level > 0:
            self._level -= 1
        elif mean > self.sched.adapt_high and \
                self._level < len(self._levels) - 1:
            self._level += 1

    def _decode_step(self):
        """One captured serving step (device) and the ``SlotSync`` apply
        (host).  Reads back exactly one sync tensor; the slot metadata and
        the block table are copied to the device only when the host
        changed them.  Mid-chunk slots (inactive, request attached) are
        skipped by the masked commit and by the apply."""
        if self.paged and self.preemption:
            self._ensure_blocks()
        if not self._active.any():
            return
        self._push_table()
        self._push_meta()
        self._pick_level()
        gamma, _ = self._levels[self._level]
        t0 = time.perf_counter()
        sync = self._step_fn(self._level)
        self.stats["steps"] += 1
        self.stats["gamma_steps"][gamma] += 1
        if self.cfg.num_ssm_layers:
            # masked slots (empty or mid-chunk) kept their recurrent state
            # through the commit's restore of the speculation root
            self.stats["ssm_restores"] += int((~self._active).sum())
        # one transfer for the whole sync tensor
        raw = sync.cpu().numpy()
        self.timing["step_s"] += time.perf_counter() - t0
        sync = SlotSync(acc=raw[:, 0], tokens=raw[:, 3:],
                        done=raw[:, 1].astype(bool), spec_acc=raw[:, 2])
        acc, spec_acc, toks = sync.acc, sync.spec_acc, sync.tokens
        self._done_now = sync.done
        # committed-length mirror + acceptance EMA: spec_acc is the raw
        # verifier acceptance, exactly what the commit advanced by
        self._len_host[self._active] += spec_acc[self._active]
        d = self.sched.accept_ema
        ratio = (spec_acc - 1.0) / max(gamma, 1)
        self._acc_ema[self._active] = (
            d * self._acc_ema[self._active]
            + (1.0 - d) * ratio[self._active])
        now = time.monotonic()
        for i, slot in enumerate(self.slots):
            req = slot.request
            if req is None or not self._active[i]:
                continue
            req.steps += 1
            req.output.extend(int(t) for t in toks[i, : acc[i]])
            if req.first_token_s is None and req.output:
                req.first_token_s = now

    def _reap(self):
        """Batch-reap every slot the device marked done plus host-side
        stragglers; freed slots refill together on the next ``_admit``."""
        now = time.monotonic()
        freed = []
        for i, slot in enumerate(self.slots):
            req = slot.request
            if req is None:
                continue
            finished = bool(self._done_now[i])
            straggler = ((req.deadline_s and now - req.submitted_at > req.deadline_s)
                         or (req.max_steps and req.steps >= req.max_steps))
            if finished or straggler:
                # the device already clipped the output at EOS / budget
                req.status = "done" if finished else "cancelled"
                req.finished_s = now
                self.done[req.rid] = req
                slot.request = None
                freed.append(i)
        if freed:
            self._active[freed] = False
            self._done_now[freed] = False
            self._meta_dirty = True
            if self.paged:
                # return the slot's blocks (blocks a prefix registration or
                # another slot still references survive) and zero its
                # table row, so the freed slot's dead writes inside the
                # static step sink into the trash block
                for i in freed:
                    alloc = self._slot_alloc.pop(i, [])
                    # under worst-case reservation an early EOS strands the
                    # tail of the reserve: count the blocks never written
                    used = blocks_for(int(self._len_host[i]), self.page_size)
                    self.stats["reclaimed_blocks"] += max(0,
                                                          len(alloc) - used)
                    self.pool.free(alloc)
                    self._table[i, :] = 0
                    self._matched[i] = 0
                self._table_dirty = True
            for i in freed:
                # a straggler-cancelled request may still be mid-chunk
                self._chunk_state.pop(i, None)
                self._len_host[i] = 0
                self._acc_ema[i] = 1.0

    def _recover(self):
        """Failure recovery: re-queue all in-flight work (its cache rows
        are lost) and rebuild the device state in place.  Mid-chunk slots
        re-queue like any other in-flight request, and delivered output
        is cleared, so the retry is a from-scratch admission, not a
        resume."""
        for slot in self.slots:
            if slot.request is not None:
                req = slot.request
                req.retries += 1
                if req.retries > self.max_retries:
                    req.status = "failed"
                    self.done[req.rid] = req
                else:
                    req.output = []
                    req.steps = 0
                    req.first_token_s = None
                    req.status = "queued"
                    self.queue.appendleft(req)
                slot.request = None
        # rebuild every device tensor: a failure raised after a device call
        # ran has left its writes behind
        self._reset_device_state()
        self._reset_host_slots()
        self._level = len(self._levels) - 1

    def _static_state(self) -> dict:
        """Every static device tensor the captured steps read and write."""
        return {"cache": self.cache, "lengths": self.lengths,
                "base": self.base, "state": self.pstate, "n_out": self.n_out,
                "active": self._active_dev, "eos": self._eos_dev,
                "max_new": self._maxnew_dev, "temp": self._temp_dev,
                "top_p": self._topp_dev, "sync": self._sync_dev}

    def _alloc_device_state(self):
        """Allocate the static device tensors, once: the cache (a dense
        [n_units, B, max_len] cache of the server's own, or the paged pool
        of ``n_blocks`` blocks with all-zero tables), the [B] step state,
        the proposer state, the slot metadata and the sync tensor.  The
        cache is not ``engine.init_cache``'s: the engine keeps one cache a
        shape, which dense admission uses as its prefill scratch and which
        the replicas of a ``ReplicaRouter``, built on one engine, would
        share."""
        dev = self.device
        i32 = dict(dtype=torch.int32, device=dev)
        f32 = dict(dtype=torch.float32, device=dev)
        self.cache = model_api.init_cache(
            self.cfg, self.B, self.max_len,
            n_blocks=self.n_blocks if self.paged else None, device=dev)
        self.lengths = torch.ones((self.B,), **i32)
        self.base = torch.zeros((self.B,), **i32)
        self.n_out = torch.zeros((self.B,), **i32)
        self.pstate = self.engine.init_proposer_state(self.B, self.max_len)
        self._sax = self.engine.proposer.state_axes(self.pstate)
        self._active_dev = torch.zeros((self.B,), dtype=torch.bool,
                                       device=dev)
        self._eos_dev = torch.full((self.B,), NO_EOS, **i32)
        self._maxnew_dev = torch.zeros((self.B,), **i32)
        self._temp_dev = torch.zeros((self.B,), **f32)
        self._topp_dev = torch.ones((self.B,), **f32)
        self._sync_dev = torch.zeros((self.B, 3 + self.engine.dtree.K + 1),
                                     **i32)

    def _reset_device_state(self):
        """Zero every static device tensor in place (the captured steps'
        addresses hold) and drop every host claim about them: under the
        paged layout a fresh block pool, table mirror and prefix
        registry, since the pool's contents are gone."""
        if self.paged:
            self.pool = BlockPool(self.n_blocks)
            self.prefix = (PrefixCache(self.page_size)
                           if self.prefix_enabled else None)
            self._table = np.zeros((self.B, self.blocks_per_slot), np.int32)
            self._table_dirty = False
            self._slot_alloc: Dict[int, list] = {}
            self._matched = np.zeros((self.B,), np.int32)
        else:
            self.prefix = None
        tree_map(lambda t: t.zero_(), self.cache)
        tree_map(lambda t: t.zero_(), self.pstate)
        self.lengths.fill_(1)
        self.base.zero_()
        self.n_out.zero_()
        self._meta_dirty = True


class FamilySpecServer:
    """Per-request proposer choice behind one serving façade.

    Each named group is a full ``SpecServer`` lane owning its engine (its
    proposer and captured step graphs), its weights, its cache and its
    slots, so one deployment mixes, say, chat traffic through a Medusa
    lane and code traffic through the n-gram lane, and no lane's step
    shape constrains another's.  ``submit(..., group=...)`` routes a
    request to its lane (default: the first group); ``step_once`` advances
    every busy lane.  Façade request ids are lane-independent: results
    resolve here, never against a lane directly.  Groups over one config
    may share one ``params`` tree (the weights are read-only)."""

    def __init__(self, groups: Dict[str, SpecServer],
                 default: Optional[str] = None):
        if not groups:
            raise ValueError("FamilySpecServer needs at least one slot group")
        self.groups: Dict[str, SpecServer] = dict(groups)
        self.default = next(iter(self.groups)) if default is None else default
        if self.default not in self.groups:
            raise ValueError(f"default group {self.default!r} not in "
                             f"{sorted(self.groups)}")
        self._rid = 0
        self._route: Dict[int, tuple] = {}

    def submit(self, prompt: np.ndarray, max_new: int,
               group: Optional[str] = None, **kw) -> int:
        name = self.default if group is None else group
        if name not in self.groups:
            raise KeyError(f"unknown slot group {name!r}; have "
                           f"{sorted(self.groups)}")
        inner = self.groups[name].submit(prompt, max_new, **kw)
        self._rid += 1
        self._route[self._rid] = (name, inner)
        return self._rid

    def result(self, rid: int) -> Optional[Request]:
        route = self._route.get(rid)
        if route is None:
            return None
        name, inner = route
        return self.groups[name].result(inner)

    def group_of(self, rid: int) -> Optional[str]:
        route = self._route.get(rid)
        return None if route is None else route[0]

    @property
    def busy(self) -> bool:
        return any(srv.busy for srv in self.groups.values())

    def step_once(self, it: int = 0):
        """One façade iteration: advance every lane with work in flight;
        idle lanes launch nothing."""
        for srv in self.groups.values():
            if srv.busy:
                srv.step_once(it=it)

    def run(self, max_iters: int = 10_000) -> int:
        it = 0
        while self.busy and it < max_iters:
            self.step_once(it)
            it += 1
        return it

    def release_all(self):
        for srv in self.groups.values():
            srv.release_all()

    def reset(self):
        for srv in self.groups.values():
            srv.reset()
        self._route.clear()
        self._rid = 0

    @property
    def stats(self) -> Dict[str, dict]:
        """Per-lane stats keyed by group name."""
        return {name: srv.stats for name, srv in self.groups.items()}


# the reference's name from when the server was Medusa-only
MedusaServer = SpecServer
