"""One run of one cell: the port's server driven by the mix's clients.

``run_cell`` draws the weights, builds the port's engine and
``SpecServer`` as the configuration's ``serving`` block says, warms up
every prefill shape the mix reaches and the captured serve step, starts
the closed loop (each client sends its next request when its last one
completes) and opens the window once every client has completed one
request.  The window closes at the first iteration boundary past
``seconds``; the requests still in flight then finish (no new ones are
sent), at most a minute past the close.  Everything before the window
is set-up.

The server is driven only through ``submit``, ``step_once`` and the
requests it returns.  The benchmark's own wrappers, set on the server
instance, read what a step and a prefill were given (the active slots'
committed rows, the groups' prompt lengths) and, with ``trace``, time
the serve step's replay and each prefill call with CUDA events and mark
the host's phases for the profiler."""
from __future__ import annotations

import collections
import gc
import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from perfbench import tracing
from perfbench.families import family, sub_seed
from perfbench.traffic import Stream, warm_prompts

DRAIN_S = 60.0          # how long past the close in-flight requests may take
WARM_NEW = 4            # tokens a warm-up request asks for


@dataclass
class Sent:
    """One request as its client sent it, and the port's ``Request``."""
    client: int
    sent_s: float       # the client's send, on ``time.monotonic``
    req: object         # repro_torch.serving.scheduler.Request
    end_s: Optional[float] = None   # the iteration boundary that saw it end

    @property
    def done(self) -> bool:
        return self.req.status == "done"


@dataclass
class Run:
    """Everything a metric reader or the correctness check reads."""
    cell: str
    cfg: dict               # the configuration's file
    mix: dict               # the traffic mix's file
    seed: int
    family: object          # the family's module (costs)
    slots: int
    tree_rows: int          # T, rows a slot verifies a step
    device_kind: str
    t_start: float
    t_open: float = 0.0
    t_close: float = 0.0
    delivered: int = 0      # output tokens delivered inside the window
    sent: List[Sent] = field(default_factory=list)
    steps: list = field(default_factory=list)      # (t, [committed rows])
    prefills: list = field(default_factory=list)   # (t, [[prompt lens]])
    timing: dict = field(default_factory=dict)     # SpecServer.timing diff
    step_events: list = field(default_factory=list)     # trace: (t, a, b)
    prefill_events: list = field(default_factory=list)  # (t, a, b, tokens)
    step_ms: list = field(default_factory=list)     # trace: window's steps
    prefill_ms: list = field(default_factory=list)  # trace: (ms, tokens)
    profile: Optional[dict] = None                 # trace: the sub-window
    slot_of: dict = field(default_factory=dict)    # rid -> its decode slot
    marks: list = field(default_factory=list)      # set-up: (phase, t)
    memory_peak_bytes: int = 0

    @property
    def window_s(self) -> float:
        return self.t_close - self.t_open

    @property
    def setup_s(self) -> float:
        return self.t_open - self.t_start

    def in_window(self, t) -> bool:
        return t is not None and self.t_open <= t <= self.t_close

    def completed(self) -> List[Sent]:
        """Requests that finished, done, inside the window."""
        return [s for s in self.sent
                if s.done and self.in_window(s.req.finished_s)]

    def attempted(self) -> List[Sent]:
        """Requests sent inside the window."""
        return [s for s in self.sent if self.in_window(s.sent_s)]


class ClosedLoop:
    """``clients`` clients, each with one request in flight: when it
    ends, the client sends the stream's next request at once."""

    def __init__(self, srv, stream: Stream, clients: int, clock,
                 span=tracing.no_span):
        self.srv, self.stream, self.clock = srv, stream, clock
        self.span = span
        self.sent: List[Sent] = []
        self.current: List[Optional[Sent]] = [None] * clients
        self.ended = [0] * clients      # requests each client saw end
        self.sending = True
        self._next = 0

    def send(self, client: int):
        prompt, max_new = self.stream.request(self._next)
        t = self.clock()
        rid = self.srv.submit(prompt, max_new)
        req = self.srv.queue[-1]
        if req.rid != rid:
            raise RuntimeError("the server did not queue the request last")
        s = Sent(client, t, req)
        self._next += 1
        self.sent.append(s)
        self.current[client] = s

    def start(self):
        for c in range(len(self.current)):
            self.send(c)

    def iterate(self) -> float:
        """One scheduler iteration; clients whose request ended send
        their next one (while ``sending``)."""
        self.srv.step_once()
        now = self.clock()
        with self.span("clients"):
            for c, s in enumerate(self.current):
                if s is not None and s.req.status in ("done", "failed",
                                                      "cancelled"):
                    s.end_s = now
                    self.ended[c] += 1
                    self.current[c] = None
                    if self.sending:
                        self.send(c)
        return now

    def in_flight(self) -> bool:
        return any(s is not None for s in self.current)

    def delivered(self) -> int:
        return sum(len(s.req.output) for s in self.sent)


def _instrument(srv, run: Run, trace: bool, cuda: bool, clock):
    """Set the benchmark's wrappers on the server instance: records of
    every serve step's active slots, every prefill group's prompt
    lengths and the slot each request was admitted to; with ``trace``
    profiler ranges around the host's phases and, on the card, CUDA
    events around the step's replay and each prefill call (a call
    prefills one group, in the order the records list them)."""
    span = tracing.span if trace else tracing.no_span
    pending = collections.deque()
    decode_step, admit_batched = srv._decode_step, srv._admit_batched
    admit, reap = srv._admit, srv._reap

    def decode_step_rec():
        active = srv._active.copy()
        if active.any():
            run.steps.append((clock(),
                              [int(n) for n in srv._len_host[active]]))
        with span("step"):
            decode_step()

    def admit_batched_rec(pairs):
        groups = {}
        for _, _, p_ext in pairs:
            groups.setdefault(srv._bucket(len(p_ext)), []).append(len(p_ext))
        run.prefills.append((clock(), list(groups.values())))
        pending.extend(sum(g) for g in groups.values())
        admit_batched(pairs)

    def admit_rec():
        with span("admission"):
            admit()
        for i, slot in enumerate(srv.slots):
            if slot.request is not None:
                run.slot_of.setdefault(slot.request.rid, i)

    def reap_rec():
        with span("reap"):
            reap()

    srv._decode_step, srv._admit_batched = decode_step_rec, admit_batched_rec
    srv._admit, srv._reap = admit_rec, reap_rec
    if not (trace and cuda):
        return
    step_fn, admit_fn = srv._step_fn, srv._admit_fn

    def step_timed(level):
        a, b = tracing.event_pair()
        with span("replay"):
            a.record()
            out = step_fn(level)
            b.record()
        run.step_events.append((clock(), a, b))
        return out

    def admit_timed(*args, **kw):
        a, b = tracing.event_pair()
        with span("prefill"):
            a.record()
            admit_fn(*args, **kw)
            b.record()
        run.prefill_events.append((clock(), a, b, pending.popleft()))

    srv._step_fn, srv._admit_fn = step_timed, admit_timed


def named_tree_rows(name: str, heads: int) -> int:
    """The rows T of the verify tree a configuration's ``serving.tree``
    names: Medusa's sparse 63-node tree (with the root) or a chain of
    ``heads``; any other name is refused."""
    rows = {"medusa_63": 64, "chain": heads + 1}
    if name not in rows:
        raise ValueError(f"serving.tree {name!r}: the port's engine builds "
                         f"only {sorted(rows)}")
    return rows[name]


def build(cfg: dict, mix: dict, seed: int, device):
    """(weights, engine, server) for a configuration and a mix; the
    engine's tree has to be the one ``serving.tree`` names."""
    from repro_torch.core.engine import build_engine
    from repro_torch.serving.scheduler import SpecServer
    sv = cfg["serving"]
    want = named_tree_rows(sv["tree"], sv["medusa_heads"])
    fam = family(cfg["family"])
    w = fam.draw(cfg, seed, device)
    pcfg, params, heads = fam.to_port(cfg, w)
    engine = build_engine(pcfg, sv["proposer"], use_kernel=sv["use_kernel"],
                          verify_fusion=sv["verify_fusion"],
                          accept=sv["accept"], device=device,
                          seed=sub_seed(seed, "engine") % 2**63)
    if (engine.dtree.T, engine.dtree.K) != (want, sv["medusa_heads"]):
        raise ValueError(f"serving.tree {sv['tree']!r} has {want} rows over "
                         f"{sv['medusa_heads']} heads; the engine built "
                         f"{engine.dtree.T} over {engine.dtree.K}")
    srv = SpecServer(engine, params, heads, batch_slots=mix["clients"],
                     max_len=mix["max_len"],
                     prompt_buckets=tuple(mix["prompt_buckets"]))
    return w, engine, srv


def _warm(srv, cfg: dict, mix: dict, seed: int):
    """Every prefill shape of the mix, one group at a time, and the
    serve step's capture; then a fresh server with the graphs kept."""
    for group in warm_prompts(mix, seed, cfg["vocab_size"]):
        for prompt in group:
            srv.submit(prompt, WARM_NEW)
        srv.run()
    bad = [r.rid for r in srv.done.values() if r.status != "done"]
    if bad:
        raise RuntimeError(f"warm-up requests {bad} did not complete")
    srv.reset()


def drive(loop: ClosedLoop, run: Run, seconds: float, sync=lambda: None,
          profile=None):
    """The closed loop until every client has completed one request, the
    window, and the drain; fills ``run``'s window records.  ``sync`` waits
    for the device; ``profile(loop)``, if given, runs the profiled
    sub-window once the loop is steady, just before the window opens
    (the profiler's start and its collection take seconds of the host,
    which would otherwise fall inside the window), and returns its
    record."""
    clock, srv = loop.clock, loop.srv
    loop.start()
    while min(loop.ended) == 0:
        loop.iterate()
    run.marks.append(("every client served once", clock()))
    prof = profile(loop) if profile is not None else None
    sync()
    run.t_open = now = clock()
    d0, timing0 = loop.delivered(), dict(srv.timing)
    while now < run.t_open + seconds:
        now = loop.iterate()
    run.t_close = now
    run.delivered = loop.delivered() - d0
    run.timing = {k: srv.timing[k] - timing0[k] for k in timing0}
    loop.sending = False
    while loop.in_flight() and clock() < run.t_close + DRAIN_S:
        loop.iterate()
    run.sent = loop.sent
    return prof


def run_cell(cell: str, cfg: dict, mix: dict, seed: int, seconds: float,
             trace: bool, device, t_start: float,
             clock=time.monotonic) -> tuple:
    """Run one cell; -> (Run, weights).  The server, the engine and every
    tensor of the program are freed before it returns; the weights, the
    benchmark's own, are kept for the correctness check."""
    if mix["loop"] != "closed":
        raise ValueError(f"{mix['name']}: loop {mix['loop']!r}; the harness "
                         "drives closed loops only")
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    marks = [("start", t_start), ("imports", clock())]
    w, engine, srv = build(cfg, mix, seed, dev)
    marks.append(("weights and server", clock()))
    T = engine.dtree.T
    need = mix["prompt_tokens"][1] + mix["new_tokens"][1] + T + 2
    if need > mix["max_len"] or max(mix["prompt_buckets"]) + WARM_NEW + T \
            + 2 > mix["max_len"] or mix["prompt_tokens"][1] > \
            max(mix["prompt_buckets"]):
        raise ValueError(f"{mix['name']}: the longest request ({need} rows "
                         f"with one step's {T} tree rows) or the largest "
                         f"bucket does not fit max_len {mix['max_len']}")
    run = Run(cell=cell, cfg=cfg, mix=mix, seed=seed,
              family=family(cfg["family"]), slots=mix["clients"],
              tree_rows=T,
              device_kind=(torch.cuda.get_device_name(dev) if cuda
                           else "cpu"),
              t_start=t_start, marks=marks)
    _warm(srv, cfg, mix, seed)
    marks.append(("prefill shapes and capture", clock()))
    # what set-up made lives to the end: out of the collector's sight, so
    # its full passes inside the window stay short
    gc.collect()
    gc.freeze()
    _instrument(srv, run, trace, cuda, clock)
    loop = ClosedLoop(srv, Stream(mix, seed, cfg["vocab_size"]),
                      mix["clients"], clock,
                      tracing.span if trace else tracing.no_span)
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)
    prof = drive(loop, run, seconds, sync,
                 (lambda lp: tracing.profile_iterations(lp, dev))
                 if trace and cuda else None)
    sync()
    tracing.settle(run, dev)
    if cuda:
        run.memory_peak_bytes = torch.cuda.max_memory_allocated(dev)
    if prof is not None:
        run.profile = tracing.summarize(prof)
    del loop, srv, engine, prof
    gc.unfreeze()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return run, w


def percentile(values, q: float) -> Optional[float]:
    """The ``q``-th percentile (linear between ranks) of all ``values``;
    None for none."""
    if not values:
        return None
    return float(np.percentile(np.asarray(values, np.float64), q))
