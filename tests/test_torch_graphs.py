"""The compiled decode step: the loop bodies over a static carry, and the
capture helper's launch bookkeeping, on the CPU.

* The static-carry loop bodies (``SpecEngine.generate`` and
  ``ar_generate``), run eagerly here, give the reference's tokens exactly
  on reduced openPangu-7B with shared weights: ``SpecEngine.generate``
  (tokens, true lengths, steps, accepted sum) on the dense, paged, int8,
  int8 + paged caches and with verify fusion, and ``ar_generate`` on the
  same layouts.  Integer outputs, so the tolerance is exact equality.
* ``runtime.StepGraph`` with its CUDA calls stubbed: the warm-up step
  runs eagerly and counts, a capture adds nothing to the launch counters,
  and each replay adds the launches and routes the capture recorded.
  Through the engine (stubbed graphs that keep a CUDA graph's semantics:
  the capture's run is the first replay's step) the totals are exactly
  ``chip_smoke.py``'s ``expected_counts``, the tokens are the eager
  step's, and a second run on the engine's reused cache replays without
  a new capture.
* A failed capture raises, and nothing runs the step eagerly in its
  place.
* ``_capture_graph`` registers the step's generators before the capture
  and keeps Python's cyclic collector off during it.
"""
import contextlib
import dataclasses
import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.core import medusa as JM
from repro.core.engine import SpecEngine as JaxSpecEngine
from repro.core.engine import ar_generate as jax_ar_generate
from repro.core.tree import medusa_63
from repro.distributed.sharding import split_params
from repro.models.api import get_model as jax_get_model
from repro_torch import bridge, runtime
from repro_torch.core.engine import SpecCarry, SpecEngine, ar_generate
from repro_torch.kernels import cache_update as CU
from repro_torch.kernels import tree_attention as TA
from test_torch_cuda import _expected_counts

B, S_P, MAX_NEW, S_MAX, PS = 2, 8, 16, 256, 16
# name: (cache_dtype, cache_layout, verify_fusion)
LAYOUTS = {"dense": ("", "dense", False), "paged": ("", "paged", False),
           "int8": ("int8", "dense", False),
           "int8+paged": ("int8", "paged", False),
           "fusion": ("", "dense", True)}


def _layout(cfg, name):
    dtype, layout, fused = LAYOUTS[name]
    return dataclasses.replace(cfg, cache_dtype=dtype, cache_layout=layout,
                               page_size=PS, verify_fusion=fused)


@pytest.fixture(scope="module")
def stack():
    cfg = jax_get_config("openpangu-7b", reduced=True)
    params, _ = split_params(
        jax_get_model(cfg).init_params(jax.random.PRNGKey(1), cfg))
    tb = medusa_63()
    mp, _ = split_params(JM.init_medusa(jax.random.PRNGKey(2), cfg, tb.K,
                                        base_lm_head=params["lm_head"]))
    tparams = bridge.to_torch(jax.tree.map(np.asarray, params), device="cpu")
    tmp = bridge.to_torch(jax.tree.map(np.asarray, mp), device="cpu")
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, cfg.vocab_size, size=(B, S_P)).astype(np.int32)
    lengths = np.array([S_P, 6], np.int32)
    return cfg, tb, params, mp, tparams, tmp, tokens, lengths


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_static_carry_loop_matches_reference(stack, name):
    """Both loops of the port, eagerly on their static carries, against
    the reference's ``SpecEngine.generate`` and ``ar_generate``: every
    token, the true lengths, the steps and the accepted sum exactly."""
    cfg, tb, params, mp, tparams, tmp, tokens, lengths = stack
    c = _layout(cfg, name)
    jm = jax_get_model(c)
    jout, jn, jst = JaxSpecEngine(c, tb, use_kernel=True).generate(
        params, mp, jnp.asarray(tokens), jnp.asarray(lengths),
        jm.init_cache(c, B, S_MAX), MAX_NEW)
    jar, jlen = jax_ar_generate(c, params, jnp.asarray(tokens),
                                jnp.asarray(lengths),
                                jm.init_cache(c, B, S_MAX), MAX_NEW)
    eng = SpecEngine(c, tb, use_kernel=True, device="cpu")
    out, n_out, st = eng.generate(tparams, tmp, _t(tokens), _t(lengths),
                                  eng.init_cache(B, S_MAX), MAX_NEW)
    ar, ar_len = ar_generate(c, tparams, _t(tokens), _t(lengths),
                             eng.init_cache(B, S_MAX), MAX_NEW,
                             use_kernel=True)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(n_out.numpy(), np.asarray(jn))
    assert (st.steps, int(st.accepted_sum)) == (int(jst.steps),
                                                int(jst.accepted_sum))
    np.testing.assert_array_equal(st.accepted_per_slot.numpy(),
                                  np.asarray(jst.accepted_per_slot))
    np.testing.assert_array_equal(ar.numpy(), np.asarray(jar))
    np.testing.assert_array_equal(ar_len.numpy(), np.asarray(jlen))
    np.testing.assert_array_equal(out.numpy(), ar.numpy())
    assert st.steps < MAX_NEW           # multi-token paths were accepted


# ---------------------------------------------------------------------------
# the capture helper, its CUDA calls stubbed
# ---------------------------------------------------------------------------

class _FakeGraph:
    """A captured graph's semantics on the CPU: the capture ran the step's
    work once, which stands for the first replay's; every later replay
    runs it again without counting (a replay runs no Python)."""

    def __init__(self, fn):
        self.fn, self.fresh = fn, True

    def replay(self):
        if self.fresh:
            self.fresh = False
            return
        before = runtime.launch_counts()
        self.fn()
        runtime._set_counts(before)


@pytest.fixture
def stub_cuda(monkeypatch):
    """Stand-ins for the capture's CUDA calls; returns the list of
    captured step functions."""
    captured = []

    def capture(fn, pool, device, generators=()):
        captured.append(fn)
        fn()
        return _FakeGraph(fn)

    monkeypatch.setattr(runtime, "_capturable", lambda device: True)
    monkeypatch.setattr(runtime, "_on_side_stream",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(runtime, "_capture_graph", capture)
    monkeypatch.setattr(runtime, "_graph_pool", lambda: None)
    return captured


WRAPPERS = {"K1": TA.flash_decode, "K2": TA.unembed_verify_stats,
            "K3": CU.fused_qkv_rope_commit, "K4": CU.commit_rows_stacked,
            "K5": CU.commit_rows_paged_stacked}


@pytest.fixture
def counters(monkeypatch):
    """Every wrapper's counters at 0 for the test (restored after it)."""
    for fn in WRAPPERS.values():
        monkeypatch.setattr(fn, "launches", 0)
        if hasattr(fn, "launches_by_route"):
            monkeypatch.setattr(fn, "launches_by_route",
                                dict.fromkeys(fn.launches_by_route, 0))


def _counts():
    return {k: f.launches for k, f in WRAPPERS.items()}


def _routes():
    return {k: dict(f.launches_by_route) for k, f in WRAPPERS.items()
            if hasattr(f, "launches_by_route")}


def test_capture_adds_nothing_and_each_replay_adds_its_counts(stub_cuda,
                                                              counters):
    """A step that 'launches' K1 on the split route (with its merge), K2 on
    the tile route and K4 twice: the warm-up step counts once, the capture
    adds 0, and each of k replays adds the recorded counts and routes."""
    ran = []

    def step():
        ran.append(1)
        TA.flash_decode.launches += 1
        TA.flash_decode.launches_by_route["split"] += 1
        TA.flash_decode.launches_by_route["merge"] += 1
        TA.unembed_verify_stats.launches += 1
        TA.unembed_verify_stats.launches_by_route["tile"] += 1
        CU.commit_rows_stacked.launches += 2

    graph = runtime.StepGraph(step, "cuda")
    per_step = {"K1": 1, "K2": 1, "K3": 0, "K4": 2, "K5": 0}
    graph()                                     # warm-up: eager, counted
    assert graph.graph is None and _counts() == per_step and len(ran) == 1
    graph()                                     # capture (+0), one replay
    assert len(stub_cuda) == 1 and graph.replays == 1
    assert _counts() == {k: 2 * n for k, n in per_step.items()}
    for k in range(1, 5):
        graph()
        assert graph.replays == 1 + k
        assert _counts() == {n: (2 + k) * v for n, v in per_step.items()}
    assert len(stub_cuda) == 1 and len(ran) == 6   # warm-up, capture, 4
    assert _routes() == {"K1": {"single": 0, "split": 6, "merge": 6},
                         "K2": {"wgmma": 0, "tile": 6},
                         "K3": {"wgmma": 0, "tile": 0}}
    assert graph.launches[TA.flash_decode] == (1, {"single": 0, "split": 1,
                                                   "merge": 1})


def test_failed_capture_raises_and_runs_nothing_in_its_place(monkeypatch,
                                                             counters):
    """A capture that fails (as CUDA refuses a host copy inside one) raises
    out of the step; the counters keep only the warm-up's launch, and the
    step does not run eagerly instead."""
    ran = []

    def step():
        ran.append(1)
        CU.commit_rows_stacked.launches += 1

    def capture(fn, pool, device, generators=()):
        fn()
        raise RuntimeError("operation not permitted when stream is "
                           "capturing")

    monkeypatch.setattr(runtime, "_capturable", lambda device: True)
    monkeypatch.setattr(runtime, "_on_side_stream",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(runtime, "_capture_graph", capture)
    graph = runtime.StepGraph(step, "cuda")
    graph()
    with pytest.raises(RuntimeError, match="no eager fallback") as err:
        graph()
    assert "stream is capturing" in str(err.value.__cause__)
    assert graph.graph is None and graph.replays == 0
    assert len(ran) == 2 and _counts()["K4"] == 1


def test_capture_registers_generators_and_holds_off_the_collector(
        monkeypatch):
    """``_capture_graph`` with ``torch.cuda``'s graph calls stubbed: the
    step's generators are registered before the capture begins, and
    Python's cyclic collector stays off during it (a dead graph destroyed
    mid-capture invalidates the capture), also when the capture fails; no
    collection is forced (it cost more than half a second a capture)."""
    events = []

    class FakeCUDAGraph:
        def register_generator_state(self, gen):
            events.append(("register", gen))

    @contextlib.contextmanager
    def fake_graph(graph, pool=None):
        events.append(("begin", gc.isenabled()))
        yield
        events.append(("end", gc.isenabled()))

    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeCUDAGraph)
    monkeypatch.setattr(torch.cuda, "graph", fake_graph)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(gc, "collect",
                        lambda *a: events.append(("collect",)) or 0)
    gen = torch.Generator()
    runtime._capture_graph(lambda: events.append(("step", gc.isenabled())),
                           None, "cuda", (gen,))
    assert events == [("register", gen), ("begin", False),
                      ("step", False), ("end", False)]
    assert gc.isenabled()

    def failing():
        raise RuntimeError("operation not permitted when stream is "
                           "capturing")

    with pytest.raises(RuntimeError, match="stream is capturing"):
        runtime._capture_graph(failing, None, "cuda")
    assert gc.isenabled()


def test_engine_raises_when_its_capture_fails(stack, monkeypatch):
    cfg, tb, _, _, tparams, tmp, tokens, lengths = stack

    def capture(fn, pool, device, generators=()):
        raise RuntimeError("operation not permitted when stream is "
                           "capturing")

    monkeypatch.setattr(runtime, "_capturable", lambda device: True)
    monkeypatch.setattr(runtime, "_on_side_stream",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(runtime, "_capture_graph", capture)
    monkeypatch.setattr(runtime, "_graph_pool", lambda: None)
    eng = SpecEngine(cfg, tb, use_kernel=True, device="cpu")
    with pytest.raises(RuntimeError, match="no eager fallback"):
        eng.generate(tparams, tmp, _t(tokens), _t(lengths),
                     eng.init_cache(B, S_MAX), MAX_NEW)


def _count_on_cpu(monkeypatch):
    """Make each wrapper's plain version (what it runs on the CPU) count
    the launch, and route, the wrapper would make on the card."""
    plain = {n: getattr(TA, n) for n in ("flash_decode_plain",
                                         "unembed_verify_stats_plain")}
    plain |= {n: getattr(CU, n) for n in ("fused_qkv_rope_commit_plain",
                                          "commit_rows_stacked_plain",
                                          "commit_rows_paged_stacked_plain")}

    def k1(q, k, v, lengths, **kw):
        Bq, Hkv, R, _ = q.shape
        table = kw.get("block_tables")
        S = k.shape[1] * (table.shape[1] if table is not None else 1)
        plan = TA.decode_plan(Bq, Hkv, R, S, q.dtype)
        TA.flash_decode.launches += 1
        TA.flash_decode.launches_by_route[plan.route] += 1
        if plan.n_splits > 1:
            TA.flash_decode.launches_by_route["merge"] += 1
        return plain["flash_decode_plain"](q, k, v, lengths, **kw)

    def k2(hidden, w, cand, tmax):
        Bh, T, d = hidden.shape
        route, _ = TA.stats_plan(Bh * T, d, w.shape[1], hidden.dtype)
        TA.unembed_verify_stats.launches += 1
        TA.unembed_verify_stats.launches_by_route[route] += 1
        return plain["unembed_verify_stats_plain"](hidden, w, cand, tmax)

    def k3(x, p, *args, **kw):
        route, _, _ = CU.qkv_plan(x.shape[0] * x.shape[1], x.shape[2],
                                  p["wq"].shape[2], x.dtype)
        CU.fused_qkv_rope_commit.launches += 1
        CU.fused_qkv_rope_commit.launches_by_route[route] += 1
        return plain["fused_qkv_rope_commit_plain"](x, p, *args, **kw)

    def commit(wrapper, name):
        def fn(*args):
            wrapper.launches += 1
            return plain[name](*args)
        return fn

    monkeypatch.setattr(TA, "flash_decode_plain", k1)
    monkeypatch.setattr(TA, "unembed_verify_stats_plain", k2)
    monkeypatch.setattr(CU, "fused_qkv_rope_commit_plain", k3)
    monkeypatch.setattr(CU, "commit_rows_stacked_plain",
                        commit(CU.commit_rows_stacked,
                               "commit_rows_stacked_plain"))
    monkeypatch.setattr(CU, "commit_rows_paged_stacked_plain",
                        commit(CU.commit_rows_paged_stacked,
                               "commit_rows_paged_stacked_plain"))


@pytest.mark.parametrize("name", ["dense", "fusion", "paged", "int8"])
def test_graph_counts_and_tokens_through_the_engine(stack, stub_cuda,
                                                    counters, monkeypatch,
                                                    name):
    """The engine's loops through stubbed graphs: spec and AR tokens equal
    the eager engine's, the launch totals are exactly ``expected_counts``
    on every run, and a second run on the engine's reused cache replays
    every step with no new capture."""
    cfg, tb, _, _, tparams, tmp, tokens, lengths = stack
    _count_on_cpu(monkeypatch)
    c = _layout(cfg, name)
    eng = SpecEngine(c, tb, use_kernel=True, device="cpu")
    eager = SpecEngine(c, tb, use_kernel=True, device="cpu", graphs=False)
    tok, plen = _t(tokens), _t(lengths)

    def run(e):
        for fn in WRAPPERS.values():
            fn.launches = 0
            for r in getattr(fn, "launches_by_route", ()):
                fn.launches_by_route[r] = 0
        sp, n_out, st = e.generate(tparams, tmp, tok, plen,
                                   e.init_cache(B, S_MAX), MAX_NEW)
        ar, _ = ar_generate(e.cfg, tparams, tok, plen,
                            e.init_cache(B, S_MAX), MAX_NEW, use_kernel=True,
                            graphs=e.step_graphs)
        assert _counts() == _expected_counts(e.cfg, st.steps, MAX_NEW)
        k1 = _routes()["K1"]
        assert k1["single"] + k1["split"] == _counts()["K1"]
        assert k1["merge"] == k1["split"]
        return sp, ar, st

    want, want_ar, want_st = run(eager)
    assert stub_cuda == [] and eager.step_graphs.kept()[0][0].graph is None
    sp, ar, st = run(eng)
    graphs = {isinstance(carry, SpecCarry): g
              for g, carry in eng.step_graphs.kept()}
    assert len(stub_cuda) == 2 and all(g.graph for g in graphs.values())
    assert (graphs[True].replays, graphs[False].replays) == (st.steps - 1,
                                                             MAX_NEW - 1)
    sp2, ar2, st2 = run(eng)
    assert len(stub_cuda) == 2 and len(eng.step_graphs.kept()) == 2
    assert (graphs[True].replays, graphs[False].replays) == (
        2 * st.steps - 1, 2 * MAX_NEW - 1)
    for got in (sp, ar, sp2, ar2, want_ar):
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert st.steps == st2.steps == want_st.steps < MAX_NEW
    assert int(st.accepted_sum) == int(want_st.accepted_sum)


def test_a_new_cache_recaptures(stack, stub_cuda, counters):
    """A graph bakes in the cache's addresses: a cache the engine did not
    hand out gets a graph of its own, captured anew, and the same
    tokens."""
    cfg, tb, _, _, tparams, tmp, tokens, lengths = stack
    eng = SpecEngine(cfg, tb, use_kernel=True, device="cpu")
    tok, plen = _t(tokens), _t(lengths)
    first = eng.generate(tparams, tmp, tok, plen, eng.init_cache(B, S_MAX),
                         MAX_NEW)[0]
    own = SpecEngine(cfg, tb, use_kernel=True, device="cpu").init_cache(
        B, S_MAX)
    second = eng.generate(tparams, tmp, tok, plen, own, MAX_NEW)[0]
    assert len(stub_cuda) == 2 and len(eng.step_graphs.kept()) == 1
    np.testing.assert_array_equal(first.numpy(), second.numpy())


@pytest.mark.parametrize("accept", ["greedy", "sample"])
def test_a_dropped_engine_frees_its_graphs_at_once(stack, stub_cuda, accept):
    """The engine holds its graphs and their steps hold no strong reference
    back: dropping the engine frees it and its captured graphs at once,
    with the cyclic collector off (a cycle would leave them to the
    collector, which may destroy a graph in the middle of another
    capture)."""
    cfg, tb, _, _, tparams, tmp, tokens, lengths = stack
    eng = SpecEngine(cfg, tb, use_kernel=True, device="cpu", accept=accept)
    eng.generate(tparams, tmp, _t(tokens), _t(lengths),
                 eng.init_cache(B, S_MAX), MAX_NEW)
    (step, _), = eng.step_graphs.kept()
    assert step.graph is not None and len(stub_cuda) == 1
    dead = weakref.ref(eng), weakref.ref(step.graph)
    del step
    collecting = gc.isenabled()
    gc.disable()
    try:
        del eng
        assert [r() for r in dead] == [None, None]
    finally:
        if collecting:
            gc.enable()


def test_init_cache_hands_back_one_zeroed_cache(stack):
    cfg, tb = stack[0], stack[1]
    eng = SpecEngine(_layout(cfg, "int8+paged"), tb, device="cpu")
    cache = eng.init_cache(B, S_MAX)
    table = cache["_pages"]["table"].clone()
    cache["pos0"]["k"].fill_(3)
    cache["pos0"]["k_scale"].fill_(0.5)
    cache["_pages"]["table"].zero_()
    again = eng.init_cache(B, S_MAX)
    assert again is cache
    assert not again["pos0"]["k"].any() and not again["pos0"]["k_scale"].any()
    assert torch.equal(again["_pages"]["table"], table)
    assert eng.init_cache(B, 2 * S_MAX) is not cache
