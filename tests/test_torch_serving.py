"""The port's serving scheduler against the JAX reference on reduced
openPangu-7B, on the CPU, with shared weights (``bridge``), in float32.

* ``transformer.commit(active=)``: every leaf bitwise the reference's and
  the lengths equal, on the dense, int8 and paged caches (inactive rows
  written where the dead-write rule sends them, their lengths frozen).
* ``SpecEngine.suffix_prefill``: the committed cache rows, lengths and
  base token within 3e-5 of the reference's, on a dense cache and on a
  paged pool through an allocator's shuffled table, with slots outside
  the mask run at capacity; ``step_dtrees``: every level's tree equal.
* ``SpecServer`` against the reference ``SpecServer`` on one request
  trace each: every request's tokens and status, and the whole stats
  dict, equal on (a) dense batched admission with EOS and a step budget,
  (b) serial admission, (c) paged with the prefix cache, a copy on write
  and a deferral, (d) paged n-gram with chunked prefill, preemption and
  adaptive gamma.
* Port only, against the port's ``ar_generate``: the int8 cache, verify
  fusion, the deferred write, the draft-model proposer, a
  ``FamilySpecServer`` with medusa, ngram and draft lanes, a sample engine
  with temperature-0 requests mixed in, the reference's rejects and
  refusals, and recovery from a failure injected after the real call at
  each seam the reference's tests inject at (admission, chunk call,
  decode step after a preemption, the victim's block release, the step
  hook).
* The serve step through stubbed capture calls (as
  ``test_torch_graphs.py``): one capture per adaptive level, none on
  admission or reap, the tokens the eager server gives, launches one
  commit per step and per chunk call.
* The launcher (``--reduced --device cpu``) under the scheduler's flags.

Token ids, statuses and stats are compared exactly; float32 rows within
3e-5 in units of their largest magnitude."""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import SchedulerParams as JSchedulerParams
from repro.configs.registry import get_config as jax_get_config
from repro.core import medusa as JM
from repro.core.engine import build_engine as jax_build_engine
from repro.distributed.sharding import split_params
from repro.models import transformer as JT
from repro.models.api import get_model as jax_get_model
from repro.serving.scheduler import SpecServer as JaxSpecServer
from repro_torch import bridge, runtime
from repro_torch.configs.base import SchedulerParams
from repro_torch.configs.registry import get_config
from repro_torch.core.engine import ar_generate, build_engine
from repro_torch.launch import serve
from repro_torch.models import transformer as TT
from repro_torch.serving.scheduler import (FamilySpecServer,
                                          ServerStepFailure, SpecServer)
from test_torch_graphs import WRAPPERS, _count_on_cpu, _FakeGraph

TOL = 3e-5
PS = 8


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module's torch work (the suite runs in
    several workers on a few cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want):
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=TOL)


def _paged(cfg):
    return dataclasses.replace(cfg, cache_layout="paged", page_size=PS)


@pytest.fixture(scope="module")
def stack():
    """Reduced openPangu-7B (4 layers), its Medusa heads (K 4) and a
    2-layer draft made of the target's first two layers, in both
    frameworks, and the port's AR answers, memoised."""
    cfg = jax_get_config("openpangu-7b", reduced=True)
    params, _ = split_params(
        jax_get_model(cfg).init_params(jax.random.PRNGKey(1), cfg))
    mp, _ = split_params(JM.init_medusa(jax.random.PRNGKey(2), cfg, 4,
                                        base_lm_head=params["lm_head"]))
    dparams = dict(params, units=jax.tree.map(lambda x: x[:2],
                                              params["units"]))
    to = lambda t: bridge.to_torch(jax.tree.map(np.asarray, t),  # noqa
                                   device="cpu")
    memo = {}

    def ar(c, prompt, n):
        """The port's greedy AR continuation of ``prompt`` on config c."""
        key = (c, prompt.tobytes(), n)
        if key not in memo:
            out, _ = ar_generate(
                c, s["tparams"], _t(prompt)[None],
                torch.tensor([len(prompt)], dtype=torch.int32),
                TT.init_cache(c, 1, len(prompt) + n + 8, device="cpu"), n,
                use_kernel=True, graphs=False)
            memo[key] = out[0].tolist()
        return memo[key]

    s = dict(cfg=cfg, params=params, mp=mp, tparams=to(params), tmp=to(mp),
             tdparams=to(dparams), ar=ar)
    return s


def _prompts(seed, lens, vocab=256):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in lens]


def _run(srv, reqs, **run_kw):
    """Submit (prompt, max_new, kwargs) requests, run, -> [(status,
    output)]."""
    rids = [srv.submit(p, max_new=n, **kw) for p, n, kw in reqs]
    srv.run(**run_kw)
    return [(srv.result(r).status, list(srv.result(r).output)) for r in rids]


# ---------------------------------------------------------------- the model

@pytest.mark.parametrize("layout", ["dense", "int8", "paged"])
def test_commit_active_matches_reference(layout):
    """The masked commit: every leaf bitwise, lengths advanced by acc on
    active rows only (inactive rows still written: dense at their frozen
    length, paged through a zeroed table row into trash block 0)."""
    kw = {"dense": {}, "int8": dict(cache_dtype="int8"),
          "paged": dict(cache_layout="paged", page_size=PS)}[layout]
    jcfg = dataclasses.replace(jax_get_config("openpangu-7b", reduced=True),
                               **kw)
    B, T, K1, S = 4, 6, 4, 32
    rng = np.random.default_rng(7)
    cache = JT.init_cache(jcfg, B, S)
    leaves = {}
    for name, leaf in cache["pos0"].items():
        if leaf.dtype == jnp.int8:
            leaves[name] = rng.integers(-127, 128, leaf.shape).astype(np.int8)
        elif name.endswith("_scale"):
            leaves[name] = rng.uniform(0.01, 1, leaf.shape).astype(np.float32)
        else:
            leaves[name] = rng.standard_normal(leaf.shape).astype(np.float32)
    nu, H, D = leaves["k"].shape[0], leaves["k"].shape[-2], \
        leaves["k"].shape[-1]
    new = {n: rng.standard_normal((nu, B, T, H, D)).astype(np.float32)
           for n in ("k_new", "v_new")}
    lengths = np.array([3, 10, 0, 20], np.int32)
    path = rng.integers(0, T, (B, K1)).astype(np.int32)
    acc = np.array([2, 4, 1, 3], np.int32)
    active = np.array([True, False, True, False])
    jspec = {"pos0": {n: jnp.asarray(a) for n, a in {**leaves,
                                                       **new}.items()}}
    tspec = {"pos0": {n: _t(a) for n, a in {**leaves, **new}.items()}}
    if layout == "paged":
        mb = S // PS
        table = (rng.permutation(B * mb) + 1).reshape(B, mb).astype(np.int32)
        table[~active] = 0                       # reaped slots: zeroed rows
        jspec[JT.PAGES_KEY] = {"table": jnp.asarray(table)}
        tspec[TT.PAGES_KEY] = {"table": _t(table)}
    tcfg = dataclasses.replace(get_config("openpangu-7b", reduced=True),
                               **kw)
    jc, jlen = JT.commit(jcfg, jspec, jnp.asarray(lengths),
                         jnp.asarray(path), jnp.asarray(acc),
                         active=jnp.asarray(active))
    tc, tlen = TT.commit(tcfg, tspec, _t(lengths), _t(path), _t(acc),
                         active=_t(active))
    np.testing.assert_array_equal(tlen.numpy(), np.asarray(jlen))
    np.testing.assert_array_equal(tlen.numpy(),
                                  lengths + np.where(active, acc, 0))
    for name in leaves:
        got, want = tc["pos0"][name].numpy(), np.asarray(jc["pos0"][name])
        if layout == "paged":       # dead rows race on trash block 0
            got, want = got[:, 1:], want[:, 1:]
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_suffix_prefill_matches_reference(stack, layout):
    """A causal suffix decode over cached prefix rows: prefill 2 slots'
    prefixes, then continue slots 0 and 2 by their suffixes (slot 1 and
    3 outside the mask run at capacity).  Lengths and base exactly, the
    committed rows within 3e-5; paged through an allocator's table."""
    jcfg = stack["cfg"] if layout == "dense" else _paged(stack["cfg"])
    je = jax_build_engine(jcfg, "medusa")
    te = build_engine(jcfg, "medusa", device="cpu", use_kernel=True,
                      graphs=False)
    B, S, T = 4, 64, 16
    rng = np.random.default_rng(5)
    pre = rng.integers(0, 256, size=(B, 16)).astype(np.int32)
    plens = np.array([9, 16, 5, 12], np.int32)
    suf = rng.integers(0, 256, size=(B, T)).astype(np.int32)
    nv = np.array([7, 1, 16, 1], np.int32)
    smask = np.array([True, False, True, False])
    n_blocks = None
    table = None
    if layout == "paged":
        n_blocks = 1 + B * (S // PS)
        table = (rng.permutation(B * (S // PS)) + 1).reshape(
            B, S // PS).astype(np.int32)
    jcache = je.init_cache(B, S, n_blocks=n_blocks)
    tcache = te.init_cache(B, S, n_blocks=n_blocks)
    if table is not None:
        jcache[JT.PAGES_KEY] = {"table": jnp.asarray(table)}
        tcache[TT.PAGES_KEY]["table"].copy_(_t(table))
    jcache, _, _, _ = je.prefill(stack["params"], stack["mp"],
                                 jnp.asarray(pre), jnp.asarray(plens),
                                 jcache)
    te.prefill(stack["tparams"], stack["tmp"], _t(pre), _t(plens), tcache)
    cap = S
    lens_in = np.where(smask, plens, cap).astype(np.int32)
    jcache, jlen, jbase, _ = je.suffix_prefill(
        stack["params"], stack["mp"], jcache, jnp.asarray(lens_in),
        jnp.asarray(suf), jnp.asarray(nv), jnp.asarray(smask))
    _, tlen, tbase, tstate = te.suffix_prefill(
        stack["tparams"], stack["tmp"], tcache, _t(lens_in), _t(suf),
        _t(nv), _t(smask))
    np.testing.assert_array_equal(tlen.numpy(), np.asarray(jlen))
    np.testing.assert_array_equal(tbase.numpy()[smask],
                                  np.asarray(jbase)[smask])
    for name in ("k", "v"):
        got = tcache["pos0"][name].numpy()
        want = np.asarray(jcache["pos0"][name])
        if layout == "paged":
            got, want = got[:, 1:], want[:, 1:]
        _close(got, want)


def test_step_dtrees_match_reference(stack):
    cfg = stack["cfg"]
    for kind, kw in (("medusa", {}), ("ngram", dict(gamma=4))):
        je = jax_build_engine(cfg, kind, **kw)
        te = build_engine(cfg, kind, device="cpu", **kw)
        for levels in ((), (1, 2, 3), (2, 9)):
            jf, tf = je.step_dtrees(levels), te.step_dtrees(levels)
            assert [g for g, _ in tf] == [g for g, _ in jf]
            for (_, jd), (_, td) in zip(jf, tf):
                assert (td.T, td.K, td.P, td.max_topk, td.Cmax) == \
                    (jd.T, jd.K, jd.P, jd.max_topk, jd.Cmax)
                for name in ("mask", "depths", "node_head", "node_choice",
                             "retrieve", "retrieve_valid", "children"):
                    np.testing.assert_array_equal(
                        getattr(td, name).numpy(),
                        np.asarray(getattr(jd, name)))


# ------------------------------------------------- the server vs reference

def _scenario(name, cfg, ar):
    """(config, proposer, server kwargs, requests) of scenario ``name``."""
    pcfg = _paged(cfg)
    if name in ("a", "b"):
        ps = _prompts(11, (5, 40, 9, 100, 17, 3))
        eos = ar(cfg, ps[2], 12)[4]          # an EOS hit at token 5
        reqs = [(ps[0], 10, {}), (ps[1], 8, {}),
                (ps[2], 12, dict(eos_id=eos)), (ps[3], 6, {}),
                (ps[4], 20, dict(max_steps=2)),   # cancelled on its budget
                (ps[5], 9, {})]
        kw = dict(batch_slots=3, max_len=256)
        if name == "b":
            kw["admission"] = "serial"
        return cfg, "medusa", kw, reqs
    if name == "c":
        base = _prompts(12, (20,))[0]
        sfx = _prompts(13, (3, 5, 4, 9))
        reqs = [(np.concatenate([base, sfx[0]]), 8, {}),
                (np.concatenate([base, sfx[1]]), 8, {}),
                (np.concatenate([base[:13], sfx[3]]), 8, {}),  # CoW at 13
                (np.concatenate([base, sfx[2]]), 8, {})]
        return pcfg, "medusa", dict(batch_slots=2, max_len=160, n_blocks=24,
                                    prefix_cache=True), reqs
    ps = _prompts(14, (40, 16, 12))
    reqs = [(ps[0], 20, {}), (ps[1], 24, {}), (ps[2], 16, {})]
    return pcfg, "ngram", dict(batch_slots=2, max_len=96, n_blocks=12,
                               sched=dict(chunk_size=16, preemption=True,
                                          adaptive_gamma=True)), reqs


@pytest.mark.parametrize("name", ["a", "b", "c", "d"])
def test_server_matches_reference(stack, name):
    """One request trace through the reference's ``SpecServer`` and the
    port's: every request's status and tokens, and the whole stats dict,
    equal; each scenario's mechanism fired."""
    cfg, kind, kw, reqs = _scenario(name, stack["cfg"], stack["ar"])
    sched = kw.pop("sched", None)
    pp_j = stack["mp"] if kind == "medusa" else None
    pp_t = stack["tmp"] if kind == "medusa" else None
    jsrv = JaxSpecServer(jax_build_engine(cfg, kind, gamma=4), stack["params"],
                         pp_j, sched=sched and JSchedulerParams(**sched), **kw)
    tsrv = SpecServer(build_engine(cfg, kind, gamma=4, device="cpu",
                                   use_kernel=True), stack["tparams"], pp_t,
                      sched=sched and SchedulerParams(**sched), **kw)
    want = _run(jsrv, reqs)
    got = _run(tsrv, reqs)
    assert got == want
    assert tsrv.stats == jsrv.stats
    st = tsrv.stats
    if name in ("a", "b"):
        assert [s for s, _ in got].count("cancelled") == 1
        assert got[2][1][-1] == reqs[2][2]["eos_id"]
    if name == "a":
        assert st["prefill_calls"] < len(reqs)
    if name == "c":
        assert st["cow_copies"] >= 1 and st["deferred"] >= 1
        assert st["cached_tokens"] > 0
    if name == "d":
        assert st["chunk_calls"] >= 1 and st["preemptions"] >= 1
        assert sum(1 for n in st["gamma_steps"].values() if n) >= 2
    for (status, out), (p, n, rkw) in zip(got, reqs):
        if status == "done" and "eos_id" not in rkw:
            assert out == stack["ar"](cfg, p, n)


# ---------------------------------------------------- port-only scenarios

def _server(stack, cfg, kind="medusa", engine_kw=None, **kw):
    eng = build_engine(cfg, kind, gamma=4, device="cpu", use_kernel=True,
                       **(engine_kw or {}))
    pp = {"medusa": stack["tmp"], "draft": stack["tdparams"],
          "ngram": None}[kind]
    if kind == "draft":
        eng = build_engine(cfg, kind, gamma=4, device="cpu", use_kernel=True,
                           draft_cfg=dataclasses.replace(cfg, num_layers=2),
                           **(engine_kw or {}))
    return SpecServer(eng, stack["tparams"], pp, **kw)


def _assert_ar(stack, cfg, reqs, got):
    for (status, out), (p, n, _) in zip(got, reqs):
        assert status == "done" and out == stack["ar"](cfg, p, n)


@pytest.mark.parametrize("variant", ["int8", "fused", "deferred", "draft",
                                     "draft-paged"])
def test_server_variant_matches_ar(stack, variant):
    """The server over the int8 cache, verify fusion, the deferred write
    and the draft-model proposer (dense and paged): every answer the
    port's AR on the same config."""
    cfg = stack["cfg"]
    engine_kw, kind = {}, "medusa"
    if variant == "int8":
        cfg = dataclasses.replace(cfg, cache_dtype="int8")
    elif variant == "fused":
        engine_kw = dict(verify_fusion=True)
    elif variant == "deferred":
        engine_kw = dict(deferred=True)
    elif variant.startswith("draft"):
        kind = "draft"
        if variant == "draft-paged":
            cfg = _paged(cfg)
    srv = _server(stack, cfg, kind, engine_kw, batch_slots=2, max_len=160)
    reqs = [(p, n, {}) for p, n in zip(_prompts(21, (7, 30, 12)),
                                       (9, 6, 11))]
    _assert_ar(stack, srv.engine.cfg, reqs, _run(srv, reqs))


def test_family_server_lanes_match_ar(stack):
    """One façade over a medusa, an n-gram and a draft lane sharing the
    target's weights: every answer its AR, each lane did its own work."""
    cfg = stack["cfg"]
    fam = FamilySpecServer({k: _server(stack, cfg, k, batch_slots=2,
                                       max_len=160)
                            for k in ("medusa", "ngram", "draft")})
    ps = _prompts(22, (6, 14, 9, 20, 4, 11))
    rids = [fam.submit(p, max_new=8, group=["medusa", "ngram",
                                            "draft"][i % 3])
            for i, p in enumerate(ps)]
    fam.run()
    for i, (rid, p) in enumerate(zip(rids, ps)):
        req = fam.result(rid)
        assert req.status == "done" and req.output == stack["ar"](cfg, p, 8)
        assert fam.group_of(rid) == ["medusa", "ngram", "draft"][i % 3]
    assert all(st["steps"] > 0 for st in fam.stats.values())
    with pytest.raises(KeyError):
        fam.submit(ps[0], max_new=4, group="nope")


def test_sampled_server_mixes_greedy_requests(stack):
    """A sample engine at temperature 0.8 with temperature-0 requests
    mixed in: those give the AR tokens exactly, the sampled ones finish
    with their full budget."""
    cfg = stack["cfg"]
    from repro_torch.configs.base import SamplingParams
    srv = _server(stack, cfg, engine_kw=dict(
        accept="sample", sampling=SamplingParams(temperature=0.8), seed=3),
        batch_slots=3, max_len=160)
    ps = _prompts(23, (8, 13, 5, 17))
    reqs = [(p, 10, dict(temperature=0.0 if i % 2 == 0 else None))
            for i, p in enumerate(ps)]
    got = _run(srv, reqs)
    for i, ((status, out), (p, n, _)) in enumerate(zip(got, reqs)):
        assert status == "done" and len(out) == n
        if i % 2 == 0:
            assert out == stack["ar"](cfg, p, n)


def test_rejects_and_refusals(stack):
    """The reference's rejects (oversized, beyond the largest bucket) fail
    the request and serve the rest; a bucket wider than the cache is
    clamped; the refusals raise."""
    cfg = stack["cfg"]
    srv = _server(stack, cfg, batch_slots=1, max_len=128)
    big, ok = _prompts(24, (60, 12))
    assert _run(srv, [(big, 40, {}), (ok, 4, {})])[0][0] == "failed"
    srv = _server(stack, cfg, batch_slots=1, max_len=256,
                  prompt_buckets=(8, 16))
    got = _run(srv, [(_prompts(25, (40,))[0], 4, {}), (ok, 4, {})])
    assert got[0][0] == "failed" and got[1] == ("done",
                                                stack["ar"](cfg, ok, 4))
    srv = _server(stack, cfg, batch_slots=2, max_len=256)
    assert srv.buckets == (32, 128, 256)
    wide = _prompts(26, (150,))[0]
    got = _run(srv, [(wide, 8, {}), (ok, 4, {})])
    assert got == [("done", stack["ar"](cfg, wide, 8)),
                   ("done", stack["ar"](cfg, ok, 4))]
    with pytest.raises(ValueError, match="encdec-only"):
        srv.submit(ok, max_new=4, extra_embeds=np.zeros((8, 64), np.float32))
    for kw in (dict(prefix_cache=True), dict(n_blocks=9),
               dict(sched=SchedulerParams(preemption=True))):
        with pytest.raises(ValueError):
            _server(stack, cfg, batch_slots=1, max_len=64, **kw)
    with pytest.raises(ValueError, match="suffix"):
        _server(stack, cfg, "draft", batch_slots=1, max_len=64,
                sched=SchedulerParams(chunk_size=16))
    from repro_torch.configs.base import SamplingParams
    fsrv = _server(stack, cfg, engine_kw=dict(
        accept="sample", sampling=SamplingParams(temperature=0.5),
        verify_fusion=True), batch_slots=1, max_len=64)
    with pytest.raises(ValueError, match="top_p"):
        fsrv.submit(ok, max_new=4, top_p=0.9)


class FailingCall:
    """Wraps one callable attribute of ``obj``: runs the real call, then
    raises once ``should_fail(n_calls, srv, args)`` holds (a device fault
    surfacing after the call's writes landed)."""

    def __init__(self, obj, attr, srv, should_fail):
        self.real = getattr(obj, attr)
        self.srv, self.should_fail = srv, should_fail
        self.calls, self.fired = 0, False
        setattr(obj, attr, self)

    def __call__(self, *args):
        out = self.real(*args)
        self.calls += 1
        if not self.fired and self.should_fail(self.calls, self.srv, args):
            self.fired = True
            raise ServerStepFailure("injected device failure")
        return out


@pytest.mark.parametrize("seam", ["admit", "chunk", "step-after-preempt",
                                  "victim-release", "hook"])
def test_recovery_at_each_seam(stack, seam):
    """A failure injected after the real call at each seam: every request
    still completes with its AR answer (at-least-once), and the paged
    pool ends fully reclaimed."""
    cfg = stack["cfg"]
    if seam in ("step-after-preempt", "victim-release"):
        srv = _server(stack, _paged(cfg), "ngram", batch_slots=2, max_len=64,
                      n_blocks=9, max_retries=2,
                      sched=SchedulerParams(preemption=True))
        reqs = [(p, 24, {}) for p in _prompts(27, (16, 16))]
        if seam == "step-after-preempt":
            inj = FailingCall(srv, "_step_fn", srv,
                              lambda n, s, a: s.stats["preemptions"] >= 1)
        else:
            inj = FailingCall(srv.pool, "free", srv,
                              lambda n, s, a: len(a[0]) > 0)
    else:
        sched = SchedulerParams(chunk_size=16) if seam == "chunk" else None
        srv = _server(stack, cfg, batch_slots=2, max_len=200, max_retries=2,
                      sched=sched)
        reqs = [(p, 8, {}) for p in _prompts(28, (70, 7, 12))]
        inj = None
        if seam == "admit":
            inj = FailingCall(srv, "_admit_fn", srv, lambda n, s, a: n == 1)
        elif seam == "chunk":
            inj = FailingCall(srv, "_suffix_fn", srv, lambda n, s, a: n == 2)
    run_kw = dict(fail_hook=lambda it: it == 1) if seam == "hook" else {}
    got = _run(srv, reqs, **run_kw)
    assert inj is None or inj.fired
    if seam == "step-after-preempt":
        assert srv.stats["preemptions"] >= 1
    _assert_ar(stack, srv.engine.cfg, reqs, got)
    if srv.paged:
        assert srv.pool.in_use == 0


def test_retry_budget_exhaustion(stack):
    srv = _server(stack, stack["cfg"], batch_slots=1, max_len=128,
                  max_retries=1)
    got = _run(srv, [(_prompts(29, (4,))[0], 8, {})],
               fail_hook=lambda it: it < 5)
    assert got[0][0] == "failed"
    assert srv.failures == ["ServerStepFailure('injected step failure')"] * 2


def test_other_errors_propagate(stack):
    """Only ``ServerStepFailure`` is recovered from: any other error in
    the step (a kernel that fails to launch, a bug) leaves ``run``
    unchanged, with no request re-queued."""
    srv = _server(stack, stack["cfg"], batch_slots=1, max_len=128)

    def broken(level):
        raise RuntimeError("device-side assert")
    srv._step_fn = broken
    srv.submit(_prompts(29, (4,))[0], max_new=8)
    with pytest.raises(RuntimeError, match="device-side assert"):
        srv.run()
    assert srv.failures == [] and srv.slots[0].request.retries == 0
    srv.reset()


def test_reset_reuses_the_server(stack):
    """``reset`` drops every request and zeroes the state in place: a
    second run of the same trace on the reset server gives the same
    answers and stats."""
    srv = _server(stack, _paged(stack["cfg"]), batch_slots=2, max_len=160,
                  prefix_cache=True)
    base = _prompts(30, (17,))[0]
    reqs = [(np.concatenate([base, p]), 6, {})
            for p in _prompts(31, (3, 6, 2))]
    first, st = _run(srv, reqs), srv.stats
    ptrs = [t.data_ptr() for t in srv._static_state()["cache"]["pos0"].values()]
    srv.reset()
    assert _run(srv, reqs) == first and srv.stats == st
    assert ptrs == [t.data_ptr()
                    for t in srv._static_state()["cache"]["pos0"].values()]


# ------------------------------------------------ the captured serve step

@pytest.fixture
def stub_cuda(monkeypatch):
    """Stand-ins for the capture's CUDA calls (as ``test_torch_graphs``):
    returns the list of captured step functions."""
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


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_captured_serve_step_one_graph_per_level(stack, stub_cuda,
                                                 monkeypatch, layout):
    """Adaptive gamma with chunked prefill through stubbed captures: one
    capture per level used, none on admission, reap or ``reset``; the
    tokens are the eager server's; K4 (dense) / K5 (paged)
    count one launch per decode step and per chunk call."""
    _count_on_cpu(monkeypatch)
    cfg = stack["cfg"] if layout == "dense" else _paged(stack["cfg"])
    kw = dict(batch_slots=2, max_len=200,
              sched=SchedulerParams(chunk_size=16, adaptive_gamma=True))
    reqs = [(p, 12, {}) for p in _prompts(32, (40, 6, 9))]
    eager = _server(stack, cfg, engine_kw=dict(graphs=False), **kw)
    want = _run(eager, reqs)
    srv = _server(stack, cfg, **kw)
    for f in WRAPPERS.values():
        monkeypatch.setattr(f, "launches", 0)
    got = _run(srv, reqs)
    assert got == want
    used = [g for g, n in srv.stats["gamma_steps"].items() if n]
    assert len(used) >= 2
    # a level's first step runs eagerly, its second is captured
    assert len(stub_cuda) <= len(used)
    assert len(stub_cuda) == sum(1 for g in used
                                 if srv.stats["gamma_steps"][g] >= 2)
    commits = WRAPPERS["K4" if layout == "dense" else "K5"].launches
    assert commits == srv.stats["steps"] + srv.stats["chunk_calls"]
    # a second run on the reset server: a level captures only once its
    # steps over both runs reach two, and never again
    first = dict(srv.stats["gamma_steps"])
    srv.reset()
    assert _run(srv, reqs) == want
    both = {g: n + srv.stats["gamma_steps"][g] for g, n in first.items()}
    assert len(stub_cuda) == sum(1 for n in both.values() if n >= 2)


# ------------------------------------------------------------ the launcher

@pytest.mark.parametrize("flags", [
    [],
    ["--admission", "serial", "--cache-dtype", "int8"],
    ["--cache-layout", "paged", "--page-size", "8", "--prefix-cache",
     "--shared-prefix", "20", "--preemption", "--n-blocks", "40",
     "--adaptive-gamma", "--min-new", "4"],
    ["--chunk-size", "16", "--max-prompt", "60"],
    ["--families", "medusa,ngram,draft"],
    ["--replicas", "2", "--cache-layout", "paged", "--page-size", "8",
     "--prefix-cache"],
])
def test_launcher_serves_through_the_scheduler(flags):
    srv = serve.main(["--reduced", "--device", "cpu", "--requests", "5",
                      "--slots", "2", "--max-new", "8", "--max-len", "160",
                      "--arch", "openpangu-7b"] + flags)
    assert srv.server is not None and srv.iterations > 0
    assert all(r["status"] == "done" for r in srv.results)
    if "--min-new" in flags:
        assert all(4 <= len(r["output"]) <= 8 for r in srv.results)
    else:
        assert all(len(r["output"]) == 8 for r in srv.results)
    if "--prefix-cache" in flags and "--replicas" not in flags:
        assert srv.server.stats["cached_tokens"] > 0
    if "--chunk-size" in flags:
        assert srv.server.stats["chunk_calls"] > 0


def test_launcher_static_flag_refuses_scheduler_flags():
    with pytest.raises(SystemExit):
        serve.main(["--reduced", "--device", "cpu", "--static",
                    "--prefix-cache"])


def test_launcher_exits_when_a_request_fails(monkeypatch):
    """A request that fails after its retries makes the launcher exit
    with the recovered failures named, instead of printing tok/s over the
    requests that finished."""
    class Failing(SpecServer):
        def run(self, max_iters=10_000, fail_hook=None):
            return super().run(max_iters, fail_hook=lambda it: True)

    monkeypatch.setattr(serve, "SpecServer", Failing)
    with pytest.raises(SystemExit, match="injected step failure"):
        serve.main(["--reduced", "--device", "cpu", "--requests", "1",
                    "--slots", "1", "--max-new", "4", "--max-len", "64",
                    "--arch", "openpangu-7b"])
