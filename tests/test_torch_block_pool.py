"""The port's host-side serving allocators against the reference's, on
the CPU (numpy only, no model).

* ``BlockPool`` and ``PrefixCache`` (``serving/block_pool.py``): seeded
  random sequences of alloc / share / free / register / match / evict,
  applied to the port's pair and the reference's pair side by side, give
  the same return value at every operation and the same state after it
  (refcounts, free list, exhaustions, registry entries, children index,
  LRU ticks and stats).
* ``ReplicaRouter`` (``serving/router.py``): seeded random sequences of
  submit / step / mark_dead over stub replicas (the reference tests'
  ``StubReplica``) give the same routes, owners, harvested results and
  stats.
* The reference's own unit cases of the three classes
  (``tests/test_paging.py``'s allocator cases, every stub case of
  ``tests/test_router.py``), run with the port's classes in their place.

Every comparison is exact (the state is integers, bytes and lists)."""
import numpy as np
import pytest

import test_paging as JPG
import test_router as JRT
from repro.kernels import paging as JPaging
from repro.serving import block_pool as JBP
from repro.serving import router as JR
from repro_torch.kernels import paging as TPaging
from repro_torch.serving import block_pool as TBP
from repro_torch.serving import router as TR


def _pool_state(pool):
    return (pool.ref.tolist(), list(pool._free), pool.exhaustions,
            pool.available, pool.in_use)


def _prefix_state(pc):
    entries = {k: (e.block, e.tokens, e.parent, e.tick)
               for k, e in pc._entries.items()}
    kids = {k: sorted(v) for k, v in pc._kids.items()}
    return entries, kids, pc._tick, dict(pc.stats)


@pytest.mark.parametrize("seed", range(6))
def test_pool_and_prefix_cache_match_reference_on_random_ops(seed):
    """One random op sequence on both implementations: every return value
    and the whole state after every op are equal.  Prompts come from a
    3-token alphabet at page size 2-4, so chains share prefixes, diverge
    mid-block and get evicted."""
    rng = np.random.default_rng(seed)
    ps = int(rng.integers(2, 5))
    nb = int(rng.integers(8, 24))
    jpool, tpool = JBP.BlockPool(nb), TBP.BlockPool(nb)
    jpc, tpc = JBP.PrefixCache(ps), TBP.PrefixCache(ps)
    owned = []                      # block lists both sides hold
    for _ in range(120):
        op = rng.choice(["alloc", "share", "free", "register", "match",
                         "evict"])
        if op == "alloc":
            n = int(rng.integers(0, 5))
            got, want = tpool.alloc(n), jpool.alloc(n)
            if want is not None:
                owned.append(list(want))
        elif op == "share" and owned:
            blocks = owned[int(rng.integers(len(owned)))]
            got, want = tpool.share(blocks), jpool.share(blocks)
            owned.append(list(blocks))
        elif op == "free" and owned:
            blocks = owned.pop(int(rng.integers(len(owned))))
            got, want = tpool.free(blocks), jpool.free(blocks)
        elif op == "register" and owned:
            blocks = owned[int(rng.integers(len(owned)))]
            prompt = rng.integers(0, 3, size=int(rng.integers(
                1, ps * (len(blocks) + 1) + 1))).astype(np.int32)
            row = np.zeros((8,), np.int32)
            row[:len(blocks)] = blocks
            got = tpc.register(prompt, row, tpool)
            want = jpc.register(prompt, row, jpool)
        elif op == "match":
            prompt = rng.integers(0, 3, size=int(rng.integers(
                1, 4 * ps))).astype(np.int32)
            got, want = tpc.match(prompt), jpc.match(prompt)
        elif op == "evict":
            n = int(rng.integers(0, 4))
            got, want = tpc.evict(tpool, n), jpc.evict(jpool, n)
        else:
            continue
        assert got == want, op
        assert _pool_state(tpool) == _pool_state(jpool), op
        assert _prefix_state(tpc) == _prefix_state(jpc), op
        assert len(tpc) == len(jpc)


def _stub_router(mod, n, kw):
    reps = {f"r{i}": JRT.StubReplica() for i in range(n)}
    return mod.ReplicaRouter(reps, **kw)


def _router_state(router):
    routes = {rid: (name, inner, prompt.tobytes(), sorted(kw.items()))
              for rid, (name, inner, prompt, kw) in router.routes.items()}
    harvested = {rid: (r.status, r.rid)
                 for rid, r in router.harvested.items()}
    return (routes, dict(router.owners), harvested, sorted(router.live),
            router.snapshot())


@pytest.mark.parametrize("seed", range(4))
def test_router_matches_reference_on_random_ops(seed):
    """Random submits (prompts drawn from a few shared block chains),
    steps and replica deaths over stub replicas: the same placement,
    ownership, harvest and stats at every op."""
    rng = np.random.default_rng(100 + seed)
    n = int(rng.integers(2, 5))
    kw = dict(page_size=JRT.PS, max_queue=int(rng.integers(1, 4)))
    jr, tr = _stub_router(JR, n, kw), _stub_router(TR, n, kw)
    chains = [rng.integers(0, 4, size=int(rng.integers(1, 4))).tolist()
              for _ in range(3)]
    for _ in range(60):
        op = rng.choice(["submit", "submit", "step", "dead"])
        if op == "submit":
            chain = chains[int(rng.integers(len(chains)))]
            prompt = JRT._prompt(chain[:int(rng.integers(1, len(chain) + 1))],
                                 tail=int(rng.integers(1, 3)))
            mn = int(rng.integers(1, 9))
            assert tr.submit(prompt, max_new=mn) == \
                jr.submit(prompt, max_new=mn)
        elif op == "step":
            tr.step_once()
            jr.step_once()
        elif op == "dead" and len(tr.live) > 1:
            name = sorted(tr.live)[int(rng.integers(len(tr.live)))]
            tr.mark_dead(name)
            jr.mark_dead(name)
        assert _router_state(tr) == _router_state(jr), op
        assert tr.busy == jr.busy


# the reference's own unit cases with the port's classes in their place

POOL_CASES = ["test_block_pool_refcounts",
              "test_prefix_cache_register_match_evict",
              "test_evict_is_all_or_nothing"]
ROUTER_CASES = sorted(n for n in dir(JRT) if n.startswith("test_")
                      and n != "test_router_over_real_specservers")


@pytest.mark.parametrize("case", POOL_CASES)
def test_reference_allocator_case_on_port(case, monkeypatch, rng):
    monkeypatch.setattr(JPG, "BlockPool", TBP.BlockPool)
    monkeypatch.setattr(JPG, "PrefixCache", TBP.PrefixCache)
    monkeypatch.setattr(JPG, "P", TPaging)
    fn = getattr(JPG, case)
    fn(rng) if "rng" in fn.__code__.co_varnames[:fn.__code__.co_argcount] \
        else fn()


@pytest.mark.parametrize("case", ROUTER_CASES)
def test_reference_router_case_on_port(case, monkeypatch):
    monkeypatch.setattr(JRT, "ReplicaRouter", TR.ReplicaRouter)
    getattr(JRT, case)()


def test_trash_block_is_the_references():
    assert TPaging.TRASH_BLOCK == JPaging.TRASH_BLOCK == 0
    assert TBP.TRASH_BLOCK == TPaging.TRASH_BLOCK
