"""Prefix-affinity routing over several serving replicas (the port's
copy of ``repro.serving.router``; numpy only).

``ReplicaRouter`` is the host-side front door of a multi-replica
deployment: N independent servers (``serving.scheduler.SpecServer``,
each with its own block pool and prefix cache) behind one submit/result
surface.  A prefix-cache hit is only possible on the replica whose pool
holds the prompt's blocks, so the router sends a request where its KV
already lives.

Routing is a two-level policy:

* **Affinity**: the router hashes the prompt's *full-block* prefixes with
  the exact chain key ``PrefixCache`` uses (``prompt[:n*page_size]``
  bytes, deepest chain first, never including the final token).  An
  ownership registry maps chain keys to the replica that last admitted
  that prefix; the deepest registered key wins.
* **Least-loaded fallback**: no registered prefix (or a dead owner)
  routes to the replica with the fewest queued + in-flight requests.

Backpressure caps affinity: when the owning replica's queue is already
``max_queue`` deep, the router *rebalances*: it routes to the
least-loaded replica and moves the ownership of the prompt's chain.
``mark_dead`` harvests a failed replica's finished results and requeues
everything else onto the survivors (the router keeps each request's
prompt and kwargs for this), so a replica death costs recompute, never
requests.

Replicas are duck-typed (``submit`` / ``result`` / ``busy`` /
``step_once`` / ``done`` / ``queue`` / ``slots``): tests drive the
router with stubs and ``launch/serve.py`` with ``SpecServer``s.
"""
from __future__ import annotations

from typing import Dict

import numpy as np


class ReplicaRouter:
    """Route requests across named replicas by prompt-prefix affinity."""

    def __init__(self, replicas: Dict[str, object], *, page_size: int = 16,
                 max_queue: int = 8):
        if not replicas:
            raise ValueError("need at least one replica")
        if page_size <= 0:
            raise ValueError(f"page_size must be positive, got {page_size}")
        self.replicas = dict(replicas)
        self.page_size = page_size
        self.max_queue = max_queue
        self.live = set(self.replicas)
        # chain key -> replica name that last admitted this prefix
        self.owners: Dict[bytes, str] = {}
        # global rid -> (replica name, inner rid, prompt, submit kwargs)
        self.routes: Dict[int, tuple] = {}
        self.harvested: Dict[int, object] = {}   # results of dead replicas
        self._rid = 0
        self.stats = {"affinity_hits": 0, "affinity_misses": 0,
                      "rebalances": 0, "requeues": 0,
                      "routed": {name: 0 for name in self.replicas}}

    # ------------------------------------------------------------- policy

    def _chain_keys(self, prompt: np.ndarray):
        """Chain keys deepest-first.  The last token is excluded from the
        deepest key on purpose: the request decodes *from* it, so a block
        containing it can never be reused by ``PrefixCache.match``."""
        prompt = np.asarray(prompt, np.int32)
        nmax = max(0, (prompt.shape[0] - 1)) // self.page_size
        return [prompt[: n * self.page_size].tobytes()
                for n in range(nmax, 0, -1)]

    def load(self, name: str) -> int:
        srv = self.replicas[name]
        return len(srv.queue) + sum(1 for s in srv.slots if not s.free)

    def _least_loaded(self) -> str:
        # name tiebreak keeps the choice deterministic across runs
        return min(sorted(self.live), key=self.load)

    def _pick(self, keys) -> str:
        owner = None
        for key in keys:                       # deepest registered key wins
            cand = self.owners.get(key)
            if cand is not None and cand in self.live:
                owner = cand
                break
        if owner is None:
            self.stats["affinity_misses"] += 1
            return self._least_loaded()
        if len(self.replicas[owner].queue) >= self.max_queue:
            self.stats["rebalances"] += 1      # backpressure beats affinity
            return self._least_loaded()
        self.stats["affinity_hits"] += 1
        return owner

    # ---------------------------------------------------------------- API

    def submit(self, prompt: np.ndarray, max_new: int, **kw) -> int:
        """Route and enqueue; returns a router-level rid."""
        prompt = np.asarray(prompt, np.int32)
        keys = self._chain_keys(prompt)
        name = self._pick(keys)
        inner = self.replicas[name].submit(prompt, max_new, **kw)
        for key in keys:                       # ownership follows placement
            self.owners[key] = name
        self._rid += 1
        self.routes[self._rid] = (name, inner, prompt, dict(kw, max_new=max_new))
        self.stats["routed"][name] += 1
        return self._rid

    def result(self, rid: int):
        if rid in self.harvested:
            return self.harvested[rid]
        name, inner, _, _ = self.routes[rid]
        if name not in self.live:
            return None                        # lost with its replica
        return self.replicas[name].result(inner)

    @property
    def busy(self) -> bool:
        return any(self.replicas[n].busy for n in self.live)

    def step_once(self):
        for name in sorted(self.live):
            if self.replicas[name].busy:
                self.replicas[name].step_once()

    def run(self, max_iters: int = 10_000) -> int:
        it = 0
        while self.busy and it < max_iters:
            self.step_once()
            it += 1
        return it

    # ------------------------------------------------------------- health

    def mark_dead(self, name: str):
        """Take ``name`` out of rotation: finished results are harvested,
        queued and in-flight requests requeue onto the survivors (their
        prompts and kwargs were kept at submit time), and the dead
        replica's prefix ownership is dropped so future prompts re-route
        instead of chasing a corpse."""
        if name not in self.live:
            raise ValueError(f"unknown or already-dead replica {name!r}")
        self.live.discard(name)
        if not self.live:
            raise RuntimeError("last live replica died; nothing to requeue "
                               "onto")
        self.owners = {k: v for k, v in self.owners.items() if v != name}
        srv = self.replicas[name]
        for rid, (owner, inner, prompt, kw) in list(self.routes.items()):
            if owner != name:
                continue
            req = srv.result(inner)
            if req is not None and req.status not in ("queued", "running"):
                self.harvested[rid] = req      # finished before the crash
                continue
            kw = dict(kw)
            max_new = kw.pop("max_new")
            keys = self._chain_keys(prompt)
            target = self._pick(keys)
            new_inner = self.replicas[target].submit(prompt, max_new, **kw)
            for key in keys:
                self.owners[key] = target
            self.routes[rid] = (target, new_inner, prompt,
                                dict(kw, max_new=max_new))
            self.stats["routed"][target] += 1
            self.stats["requeues"] += 1

    def snapshot(self) -> dict:
        """Stats plus live-set and per-replica load, for logs and benches."""
        return {**{k: v for k, v in self.stats.items() if k != "routed"},
                "routed": dict(self.stats["routed"]),
                "live": sorted(self.live),
                "load": {n: self.load(n) for n in sorted(self.live)}}
