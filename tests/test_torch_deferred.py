"""The deferred tree-row write (``SpecEngine(deferred=True)``) against the
JAX reference on the CPU.

Under ``deferred`` the decode step writes no tree row into the cache:
attention is the sweep of the committed cache (columns below the lengths)
merged exactly with the in-flight block, and commit is the step's only
cache write.  The same numpy inputs and weights (carried across with
``repro_torch.bridge``) go through both packages:

* ``layers.gqa_two_part`` and the scalar-length ``layers.attention_decode``
  (plain and through ``ops.tree_attention``) against the reference's, in
  float32 and bfloat16; the cache ``attention_decode`` writes, too;
* one deferred decode layer (``transformer.decode(deferred=True)`` on one
  unit) against the reference's ``decode(deferred=True)`` on the dense,
  int8, paged and int8 + paged caches, on the plain path
  (``gqa_two_part``) and on the kernel path (``tree_attention`` with the
  in-flight rows, K1's plain version here): hidden states and in-flight
  rows within 3e-5, and the cache left bit for bit as prefill wrote it;
* the whole slice on reduced openPangu-7B: deferred spec tokens equal the
  reference's ``SpecEngine(deferred=True)``, the port's non-deferred
  engine and ``ar_generate``, on every layout, unfused and with verify
  fusion (the commit is the non-deferred engine's, unchanged);
* the captured step through ``test_torch_graphs.py``'s capture stubs:
  deferred graph tokens == eager tokens, launches exact (K1 once a layer
  and step, the commit once a spec step, K2 once a fused spec step, K3
  never), a second run replayed with no new capture, and the deferred
  step kept under a graph key of its own;
* the launcher's ``--deferred`` flag answers every request as the
  non-deferred launcher does.

Tolerances are the reference kernel tests': 3e-5 for float32, 2e-2 for
bfloat16; tokens must be equal."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.core import medusa as JM
from repro.core.engine import SpecEngine as JaxSpecEngine
from repro.core.tree import medusa_63
from repro.distributed.sharding import split_params
from repro.models import layers as JL
from repro.models.api import get_model as jax_get_model
from repro_torch import bridge
from repro_torch.core.engine import SpecCarry, SpecEngine, ar_generate
from repro_torch.launch import serve
from repro_torch.models import layers as L
from repro_torch.models import transformer as TT
from test_torch_cuda import _expected_counts
from test_torch_graphs import (WRAPPERS, _count_on_cpu, _counts,  # noqa: F401
                               counters, stub_cuda)

TOL = {"float32": 3e-5, "bfloat16": 2e-2}
B, S_P, MAX_NEW, S_MAX, PS = 2, 8, 16, 256, 16
LAYOUTS = {"dense": dict(), "int8": dict(cache_dtype="int8"),
           "paged": dict(cache_layout="paged", page_size=PS),
           "int8+paged": dict(cache_dtype="int8", cache_layout="paged",
                              page_size=PS)}


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


def _close(t, j, dtype="float32"):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), atol=TOL[dtype],
                               rtol=1e-5)


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


# ---------------------------------------------------------------------------
# the attention functions
# ---------------------------------------------------------------------------

def _as(a, dtype):
    return (jnp.asarray(a, jnp.bfloat16) if dtype == "bfloat16"
            else jnp.asarray(a))


def _tt(a, dtype):
    return _t(a).to(torch.bfloat16 if dtype == "bfloat16" else torch.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gqa_two_part_matches_reference(dtype):
    """Rows with a committed past, one with none (length 0) and one whose
    past reaches the cache's last row."""
    rng = np.random.default_rng(0)
    tb = medusa_63()
    Bq, T, Hq, Hkv, D, S = 3, tb.T, 8, 2, 32, 80
    q = rng.standard_normal((Bq, T, Hq, D)).astype(np.float32)
    ck, cv = (rng.standard_normal((Bq, S, Hkv, D)).astype(np.float32)
              for _ in range(2))
    kn, vn = (rng.standard_normal((Bq, T, Hkv, D)).astype(np.float32)
              for _ in range(2))
    lengths = np.array([37, 0, S], np.int32)
    scale = 1.0 / np.sqrt(D)
    ref = JL.gqa_two_part(*(_as(a, dtype) for a in (q, ck, cv, kn, vn)),
                          jnp.asarray(lengths), jnp.asarray(tb.mask), scale)
    got = L.gqa_two_part(*(_tt(a, dtype) for a in (q, ck, cv, kn, vn)),
                         _t(lengths), torch.from_numpy(tb.mask), scale)
    assert got.dtype == _tt(q, dtype).dtype and got.shape == (Bq, T, Hq, D)
    _close(got, ref.astype(jnp.float32), dtype)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_decode_matches_reference(stack, dtype, use_kernel):
    """The scalar-length form: output and the cache with the tree rows
    written at [length, length + T)."""
    cfg, tb = stack[0], stack[1]
    cfg = dataclasses.replace(cfg, dtype=dtype)
    params = jax.tree.map(lambda x: x[0], stack[2]["units"]["pos0"]["attn"])
    tparams = {k: v[0] for k, v in stack[4]["units"]["pos0"]["attn"].items()}
    rng = np.random.default_rng(5)
    hd, Hkv = cfg.resolved_head_dim, cfg.num_kv_heads
    T, S, length = tb.T, 128, 21
    x = rng.standard_normal((B, T, cfg.d_model)).astype(np.float32)
    ck, cv = (rng.standard_normal((B, S, Hkv, hd)).astype(np.float32)
              for _ in range(2))
    jy, jk, jv = JL.attention_decode(
        params, _as(x, dtype), cfg, _as(ck, dtype), _as(cv, dtype), length,
        jnp.asarray(tb.mask), jnp.asarray(tb.depths), use_kernel=use_kernel)
    tk, tv = _tt(ck, dtype), _tt(cv, dtype)
    y, k_out, v_out = L.attention_decode(
        tparams, _tt(x, dtype), cfg, tk, tv, torch.tensor(length),
        torch.from_numpy(tb.mask), torch.from_numpy(tb.depths),
        use_kernel=use_kernel)
    assert k_out is tk and v_out is tv           # written in place
    # the reference's wo takes its fan-in from Hq, not Hq * hd, so y
    # reaches |y| ~ 25 and an element near 0 is the difference of terms
    # that large: held in units of its largest magnitude, as
    # test_torch_layers.py holds attention_full
    jy = np.asarray(jy.astype(jnp.float32))
    scale = max(1.0, float(np.abs(jy).max()))
    _close(y.float() / scale, jy / scale, dtype)
    _close(k_out, jk.astype(jnp.float32), dtype)
    _close(v_out, jv.astype(jnp.float32), dtype)


# ---------------------------------------------------------------------------
# one deferred decode layer
# ---------------------------------------------------------------------------

def _one_layer(stack, name):
    cfg, tb, params, _, tparams, _, tokens, lengths = stack
    cfg = dataclasses.replace(cfg, num_layers=1, **LAYOUTS[name])
    params = dict(params, units=jax.tree.map(lambda x: x[:1],
                                             params["units"]))
    tparams = dict(tparams, units=jax.tree.map(lambda x: x[:1],
                                               tparams["units"]))
    return cfg, tb, params, tparams, tokens, lengths


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("name", list(LAYOUTS))
def test_deferred_decode_layer_matches_reference(stack, name, use_kernel):
    cfg, tb, params, tparams, tokens, lengths = _one_layer(stack, name)
    jm = jax_get_model(cfg)
    jcache = jm.init_cache(cfg, B, S_MAX)
    tcache = TT.init_cache(cfg, B, S_MAX, device="cpu")
    _, jcache = jm.prefill(params, cfg, jnp.asarray(tokens),
                           jnp.asarray(lengths), jcache)
    _, tcache = TT.prefill(tparams, cfg, _t(tokens), _t(lengths), tcache)
    before = {n: t.clone() for n, t in tcache["pos0"].items()}
    cand = np.random.default_rng(3).integers(0, cfg.vocab_size,
                                             size=(B, tb.T)).astype(np.int32)
    jh, jspec = jm.decode(params, cfg, jcache, jnp.asarray(cand),
                          jnp.asarray(lengths), jnp.asarray(tb.mask),
                          jnp.asarray(tb.depths), use_kernel=use_kernel,
                          deferred=True)
    th, tspec = TT.decode(tparams, cfg, tcache, _t(cand), _t(lengths),
                          torch.from_numpy(tb.mask),
                          torch.from_numpy(tb.depths), use_kernel=use_kernel,
                          deferred=True)
    _close(th, jh)
    for n in ("k_new", "v_new"):
        _close(torch.stack(tspec["pos0"][n]), jspec["pos0"][n])
    for n, t in before.items():                  # no row was written
        assert torch.equal(tspec["pos0"][n], t), n


# ---------------------------------------------------------------------------
# the whole slice
# ---------------------------------------------------------------------------

def _cfg(cfg, name, fused):
    return dataclasses.replace(cfg, verify_fusion=fused, **LAYOUTS[name])


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("name", list(LAYOUTS))
def test_deferred_tokens_match_reference_and_ar(stack, name, fused):
    cfg, tb, params, mp, tparams, tmp, tokens, lengths = stack
    c = _cfg(cfg, name, fused)
    jout, jn, jst = JaxSpecEngine(c, tb, use_kernel=True,
                                  deferred=True).generate(
        params, mp, jnp.asarray(tokens), jnp.asarray(lengths),
        jax_get_model(c).init_cache(c, B, S_MAX), MAX_NEW)
    runs = {}
    for deferred in (True, False):
        eng = SpecEngine(c, tb, use_kernel=True, device="cpu", graphs=False,
                         deferred=deferred)
        runs[deferred] = eng.generate(tparams, tmp, _t(tokens), _t(lengths),
                                      eng.init_cache(B, S_MAX), MAX_NEW)
    ar, _ = ar_generate(c, tparams, _t(tokens), _t(lengths),
                        TT.init_cache(c, B, S_MAX, device="cpu"), MAX_NEW,
                        use_kernel=True)
    out, n_out, st = runs[True]
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(n_out.numpy(), np.asarray(jn))
    assert (st.steps, int(st.accepted_sum)) == (int(jst.steps),
                                                int(jst.accepted_sum))
    np.testing.assert_array_equal(out.numpy(), runs[False][0].numpy())
    np.testing.assert_array_equal(out.numpy(), ar.numpy())
    assert st.steps == runs[False][2].steps < MAX_NEW


@pytest.mark.parametrize("name", ["dense", "paged", "int8"])
def test_deferred_plain_path_tokens(stack, name):
    """Without the kernel path the deferred step attends through
    ``gqa_two_part`` over the cache view: the same tokens."""
    cfg, tb, _, _, tparams, tmp, tokens, lengths = stack
    c = _cfg(cfg, name, False)
    outs = []
    for use_kernel in (False, True):
        eng = SpecEngine(c, tb, use_kernel=use_kernel, device="cpu",
                         deferred=True)
        outs.append(eng.generate(tparams, tmp, _t(tokens), _t(lengths),
                                 eng.init_cache(B, S_MAX), MAX_NEW)[0])
    np.testing.assert_array_equal(outs[0].numpy(), outs[1].numpy())


# ---------------------------------------------------------------------------
# the captured step
# ---------------------------------------------------------------------------

def _reset():
    for fn in WRAPPERS.values():
        fn.launches = 0
        for r in getattr(fn, "launches_by_route", ()):
            fn.launches_by_route[r] = 0


@pytest.mark.parametrize("name,fused", [("dense", False), ("dense", True),
                                        ("paged", True), ("int8", False)])
def test_deferred_graph_counts_and_tokens(stack, stub_cuda, counters,
                                          monkeypatch, name, fused):
    cfg, tb, _, _, tparams, tmp, tokens, lengths = stack
    _count_on_cpu(monkeypatch)
    c = _cfg(cfg, name, fused)
    tok, plen = _t(tokens), _t(lengths)

    def run(e):
        _reset()
        sp, _, st = e.generate(tparams, tmp, tok, plen,
                               e.init_cache(B, S_MAX), MAX_NEW)
        want = _expected_counts(e.cfg, st.steps, 0) | {"K3": 0}
        assert _counts() == want
        return sp, st

    eager = SpecEngine(c, tb, use_kernel=True, device="cpu", graphs=False,
                       deferred=True)
    want, want_st = run(eager)
    eng = SpecEngine(c, tb, use_kernel=True, device="cpu", deferred=True)
    sp, st = run(eng)
    (graph, carry), = eng.step_graphs.kept()
    assert isinstance(carry, SpecCarry) and graph.graph is not None
    assert len(stub_cuda) == 1 and graph.replays == st.steps - 1
    sp2, st2 = run(eng)
    assert len(stub_cuda) == 1 and graph.replays == 2 * st.steps - 1
    for got in (sp, sp2):
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert st.steps == st2.steps == want_st.steps < MAX_NEW
    key, = eng.step_graphs._kept
    plain = SpecEngine(c, tb, use_kernel=True, device="cpu")
    plain.generate(tparams, tmp, tok, plen, plain.init_cache(B, S_MAX),
                   MAX_NEW)
    other, = plain.step_graphs._kept
    assert key != other        # the same shapes, only ``deferred`` differs


def test_launcher_deferred_answers_as_the_launcher(capsys):
    argv = ["--static", "--reduced", "--device", "cpu", "--requests", "3",
            "--slots", "2", "--max-new", "8", "--max-len", "128",
            "--verify-fusion"]
    want = serve.main(argv)
    got = serve.main(argv + ["--deferred"])
    assert got.engine.deferred and "deferred write" in capsys.readouterr().out
    assert [r["status"] for r in got.results] == ["done"] * 3
    for a, b in zip(got.results, want.results):
        np.testing.assert_array_equal(a["output"], b["output"])
