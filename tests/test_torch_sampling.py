"""The port's lossless stochastic acceptance against the JAX reference on
the CPU: ``core/sampling.py``, the typical and sampled tree walks, and the
engine's ``accept="sample"`` / ``"typical"`` modes on reduced openPangu-7B.

Randomness is an argument in the port (``core.sampling``): each walk takes
its acceptance uniforms ``u`` and the Gumbel noise ``g`` of its final draw
as tensors.  ``jax.random.categorical(k, x)`` is ``argmax(x +
jax.random.gumbel(k, x.shape))`` exactly (checked below), so the tests
split the reference's key as the reference does, pass its
``uniform(ku, (B, K, Cmax))`` and ``gumbel(kr, (B, V))`` into the port,
and compare every ``Verdict`` field exactly.

* Warps: masks exactly equal, probabilities within 1e-6 relative, on
  rows whose probabilities f32 resolves; at top_p 1.0 the reference's
  exclusive cumulative sum can round to 1.0 before the last tokens, and
  there the two frameworks (which sum in other orders) may mask different
  tokens of probability below 1e-6 (held by its own test).
* Walks: ``typical_verify``, ``sample_verify_tree`` and
  ``sample_verify_tree_stats`` on ``medusa_63`` and a small cartesian
  tree, at temperatures 0, 0.5, 1.0 and per-row mixed; the port's stats
  walk against its logits walk.
* Engine: at temperature 0 ``accept="sample"`` gives the greedy tokens
  and the reference's ``ar_generate`` tokens on the dense, int8 and paged
  caches, fused and unfused; at temperature 0.9 the sampled speculative
  tokens meet the reference's TVD gate (``TVD <= 1.5 * floor + 0.05``)
  against ``ar_generate_sampled`` on a 16-token vocabulary.
* The captured sampled step (its CUDA calls stubbed as in
  ``test_torch_graphs.py``): the engine registers its generator with the
  capture, graph tokens equal the eager tokens from the same generator
  state, replays draw fresh noise, and a new temperature replays the same
  graph.
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.core import medusa as JM
from repro.core import sampling as JS
from repro.core import verify as JV
from repro.core.engine import ar_generate as jax_ar_generate
from repro.core.tree import cartesian_tree as jax_cartesian_tree
from repro.core.tree import medusa_63 as jax_medusa_63
from repro.distributed.sharding import split_params
from repro.kernels import ref as JR
from repro.models.api import get_model as jax_get_model
from repro_torch import bridge, runtime
from repro_torch.configs.base import SamplingParams
from repro_torch.core import sampling as S
from repro_torch.core import tree as TT
from repro_torch.core import verify as V
from repro_torch.core.engine import (Draws, SpecCarry, SpecEngine,
                                     ar_generate_sampled)
from repro_torch.kernels.tree_attention import unembed_verify_stats_plain
from repro_torch.launch import serve

B, S_P, MAX_NEW, S_MAX, PS = 2, 8, 16, 256, 16
TREES = {"medusa_63": (jax_medusa_63, TT.medusa_63),
         "cartesian (3, 2)": (lambda: jax_cartesian_tree((3, 2)),
                              lambda: TT.cartesian_tree((3, 2)))}
MIXED = [0.0, 0.5, 1.0, 1.3]          # per-row temperatures, B 4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module's torch work: the suite runs in
    several workers on a few cores, and each worker's default pool
    oversubscribes them, which makes the thousands of small ops of the
    sampled walks some twenty times slower there."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.array(a))


def _temps(temp, n):
    """(JAX, port) temperature arguments: a float, or per-row [n]."""
    if temp == "mixed":
        t = np.array(MIXED[:n], np.float32)
        return jnp.asarray(t), _t(t)
    return temp, temp


# ---------------------------------------------------------------- warps

@pytest.mark.parametrize("top_p", [1.0, 0.8])
@pytest.mark.parametrize("top_k", [0, 5])
@pytest.mark.parametrize("temp", [0.0, 0.5, 1.0, "mixed"])
def test_warp_matches_reference(temp, top_k, top_p):
    """``warp_logits``/``warp_probs``/``sample`` against the reference on
    rows f32 resolves (unit-variance logits, V 64): the same masks, the
    same draws from the same Gumbel noise, probabilities within 1e-6."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 5, 64)).astype(np.float32)
    jt, tt = _temps(temp, 4)
    jw = np.asarray(JS.warp_logits(jnp.asarray(x), jt, top_k, top_p))
    tw = S.warp_logits(_t(x), tt, top_k, top_p).numpy()
    np.testing.assert_array_equal(np.isfinite(tw), np.isfinite(jw))
    jp = np.asarray(JS.warp_probs(jnp.asarray(x), jt, top_k, top_p))
    tp = S.warp_probs(_t(x), tt, top_k, top_p).numpy()
    np.testing.assert_allclose(tp, jp, rtol=1e-6, atol=0)
    key = jax.random.PRNGKey(7)
    g = np.asarray(jax.random.gumbel(key, x.shape))
    np.testing.assert_array_equal(
        S.sample(_t(g), _t(x), tt, top_k, top_p).numpy(),
        np.asarray(JS.sample(key, jnp.asarray(x), jt, top_k, top_p)))


def test_reference_categorical_is_gumbel_argmax():
    """The identity the injected draws rest on."""
    x = jax.random.normal(jax.random.PRNGKey(0), (16, 256)) * 2
    for seed in range(4):
        k = jax.random.PRNGKey(seed)
        np.testing.assert_array_equal(
            np.asarray(jax.random.categorical(k, x)),
            np.asarray(jnp.argmax(x + jax.random.gumbel(k, x.shape), -1)))


@pytest.mark.parametrize("temp", [0.5, 1.0])
def test_warp_top_p_one_tail_below_f32_resolution(temp):
    """At top_p 1.0 the reference keeps a token while the exclusive
    cumulative sum of the sorted probabilities is below 1.0; over a wide,
    peaked row that sum reaches 1.0 in f32 before the last tokens, at a
    point that depends on the order of the additions.  The two
    frameworks sum in other orders, so there (and only there) they may
    mask different tokens; every such token has probability below 1e-6,
    and every probability agrees within 1e-6."""
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((4, 6, 1000)) * 2).astype(np.float32)
    jp = np.asarray(JS.warp_probs(jnp.asarray(x), temp))
    tp = S.warp_probs(_t(x), temp).numpy()
    differ = (jp > 0) != (tp > 0)
    assert np.maximum(jp, tp)[differ].max(initial=0.0) < 1e-6
    np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-6)


def test_residual_and_typical_threshold_match_reference():
    rng = np.random.default_rng(5)
    p = jax.nn.softmax(jnp.asarray(rng.standard_normal((8, 32)),
                                   jnp.float32), axis=-1)
    q = jax.nn.softmax(jnp.asarray(rng.standard_normal((8, 32)),
                                   jnp.float32), axis=-1)
    tp, tq = _t(p), _t(q)
    np.testing.assert_allclose(S.residual_dist(tp, tq).numpy(),
                               np.asarray(JS.residual_dist(p, q)),
                               rtol=1e-6, atol=0)
    # no residual mass: falls back to p exactly
    np.testing.assert_array_equal(S.residual_dist(tp, tp).numpy(),
                                  np.asarray(p))
    logp = jax.nn.log_softmax(jnp.asarray(rng.standard_normal((3, 5, 40)),
                                          jnp.float32) * 3, axis=-1)
    np.testing.assert_allclose(S.typical_threshold(_t(logp)).numpy(),
                               np.asarray(JS.typical_threshold(logp)),
                               rtol=1e-6, atol=0)


# ---------------------------------------------------------------- walks

def _walk_inputs(tree, Bw=4, Vc=64, seed=0):
    """(JAX tree, port tree, logits, candidates, mprob) from one seed.  The
    even rows' candidates are their parent node's argmax (a proposer that
    often guesses right, so the walks descend), the odd rows' random."""
    jt_fn, pt_fn = TREES[tree]
    tb = jt_fn()
    jdt = JV.device_tree(tb)
    tdt = V.device_tree(pt_fn(), "cpu")
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((Bw, jdt.T, Vc)) * 2).astype(np.float32)
    cand = rng.integers(0, Vc, (Bw, jdt.T)).astype(np.int32)
    parent = np.asarray(tb.parent)[1:]
    cand[::2, 1:] = np.argmax(logits[::2][:, parent], axis=-1)
    mprob = rng.random((Bw, max(jdt.K, 1), jdt.max_topk)).astype(np.float32)
    return jdt, tdt, logits, cand, mprob


def _draws(key, Bw, dt, Vc):
    """The reference walk's own draws from ``key``: (u, g) as numpy."""
    ku, kr = jax.random.split(key)
    u = jax.random.uniform(ku, (Bw, max(dt.K, 1), dt.Cmax))
    return np.asarray(u), np.asarray(jax.random.gumbel(kr, (Bw, Vc)))


def _assert_same_verdict(got, want):
    """Every Verdict field exactly; path slots and tokens on the first acc
    columns (the rest is unused padding, filled differently by the walks
    and by ``_select``)."""
    acc = np.asarray(want.acc)
    np.testing.assert_array_equal(got.acc.numpy(), acc)
    np.testing.assert_array_equal(got.next_token.numpy(),
                                  np.asarray(want.next_token))
    np.testing.assert_array_equal(got.last_slot.numpy(),
                                  np.asarray(want.last_slot))
    for name in ("path_slots", "path_tokens"):
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        for b in range(acc.shape[0]):
            np.testing.assert_array_equal(g[b, :acc[b]], w[b, :acc[b]],
                                          f"{name} row {b}")


@pytest.mark.parametrize("temp", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("tree", list(TREES))
def test_typical_verify_matches_reference(tree, temp):
    for trial in range(3):
        jdt, tdt, logits, cand, _ = _walk_inputs(tree, seed=trial)
        key = jax.random.PRNGKey(50 + trial)
        g = np.asarray(jax.random.gumbel(key, (4, logits.shape[-1])))
        want = JV.typical_verify(jnp.asarray(cand), jnp.asarray(logits), jdt,
                                 key, temperature=temp)
        got = V.typical_verify(_t(cand), _t(logits), tdt, _t(g),
                               temperature=temp)
        _assert_same_verdict(got, want)


@pytest.mark.parametrize("temp", [0.0, 0.5, 1.0, "mixed"])
@pytest.mark.parametrize("tree", list(TREES))
def test_sample_verify_tree_matches_reference(tree, temp):
    accepted = 0
    for trial in range(3):
        jdt, tdt, logits, cand, mprob = _walk_inputs(tree, seed=trial)
        jt, tt = _temps(temp, 4)
        key = jax.random.PRNGKey(100 + trial)
        u, g = _draws(key, 4, jdt, logits.shape[-1])
        want = JV.sample_verify_tree(jnp.asarray(cand), jnp.asarray(logits),
                                     jnp.asarray(mprob), jdt, key,
                                     temperature=jt)
        got = V.sample_verify_tree(_t(cand), _t(logits), _t(mprob), tdt,
                                   _t(u), _t(g), temperature=tt)
        _assert_same_verdict(got, want)
        accepted += int((got.acc > 1).sum())
    if temp != 0.0:
        assert accepted > 0          # the walk descended somewhere


def _stats(logits, cand, temp_t):
    """The fused kernel's statistics of ``logits`` (an identity unembed),
    from the reference's oracle, as numpy."""
    Bw, _, Vc = logits.shape
    tmax = np.maximum(np.broadcast_to(np.asarray(temp_t, np.float32), (Bw,)),
                      np.float32(1e-6)).astype(np.float32)
    return [np.asarray(a) for a in JR.verify_stats_ref(
        jnp.asarray(logits), jnp.eye(Vc, dtype=jnp.float32),
        jnp.asarray(cand), jnp.asarray(tmax))]


@pytest.mark.parametrize("temp", [0.0, 0.5, 1.0, "mixed"])
@pytest.mark.parametrize("tree", list(TREES))
def test_sample_verify_tree_stats_matches_reference(tree, temp):
    """The fused walk on the same statistics and the same row function."""
    for trial in range(3):
        jdt, tdt, logits, cand, mprob = _walk_inputs(tree, seed=10 + trial)
        jt, tt = _temps(temp, 4)
        st = _stats(logits, cand, jt)
        key = jax.random.PRNGKey(200 + trial)
        u, g = _draws(key, 4, jdt, logits.shape[-1])
        rows = np.arange(4)
        want = JV.sample_verify_tree_stats(
            jnp.asarray(cand), JV.VerifyStats(*map(jnp.asarray, st)),
            jnp.asarray(mprob), jdt, key,
            lambda idx: jnp.asarray(logits)[rows, idx], temperature=jt)
        tl = _t(logits)
        got = V.sample_verify_tree_stats(
            _t(cand), V.VerifyStats(*map(_t, st)), _t(mprob), tdt, _t(u),
            _t(g), lambda idx: tl[torch.arange(4), idx], temperature=tt)
        _assert_same_verdict(got, want)


@pytest.mark.parametrize("temp", [0.0, 0.7, 1.3])
def test_port_stats_walk_equals_logits_walk(temp):
    """The port's two walks on the port's own statistics (K2's plain
    version over an identity unembed) and the port's own draws, as the
    reference's ``test_tree_walk_stats_equals_logits_walk`` holds its
    pair."""
    tdt = V.device_tree(TT.cartesian_tree((3, 2)), "cpu")
    Bw, Vc = 4, 33
    gen = torch.Generator().manual_seed(9)
    for trial in range(5):
        logits = torch.randn((Bw, tdt.T, Vc), generator=gen) * 2
        cand = torch.randint(0, Vc, (Bw, tdt.T), generator=gen,
                             dtype=torch.int32)
        mprob = torch.rand((Bw, tdt.K, tdt.max_topk), generator=gen)
        tmax = torch.full((Bw,), max(temp, 1e-6))
        stats = V.VerifyStats(*unembed_verify_stats_plain(
            logits, torch.eye(Vc), cand, tmax))
        u = S.uniform((Bw, tdt.K, tdt.Cmax), gen)
        g = S.gumbel((Bw, Vc), gen)
        ref = V.sample_verify_tree(cand, logits, mprob, tdt, u, g,
                                   temperature=temp)
        fused = V.sample_verify_tree_stats(
            cand, stats, mprob, tdt, u, g,
            lambda idx: logits[torch.arange(Bw), idx], temperature=temp)
        for name in ("acc", "next_token", "last_slot"):
            assert torch.equal(getattr(fused, name), getattr(ref, name))
        for b in range(Bw):
            n = int(ref.acc[b])
            assert torch.equal(fused.path_tokens[b, :n],
                               ref.path_tokens[b, :n])


def test_tree_walk_temperature_zero_is_greedy_verify():
    tdt = V.device_tree(TT.cartesian_tree((3, 2)), "cpu")
    Bw, Vc = 64, 16
    gen = torch.Generator().manual_seed(7)
    mtok = torch.stack([torch.randperm(Vc, generator=gen)[:3]
                        for _ in range(2 * Bw)]).reshape(Bw, 2, 3)
    mtok = mtok.to(torch.int32)
    cand = V.generate_candidates(torch.randint(0, Vc, (Bw,), generator=gen,
                                               dtype=torch.int32), mtok, tdt)
    logits = torch.randn((Bw, tdt.T, Vc), generator=gen) * 2
    mprob = torch.rand((Bw, 2, 3), generator=gen)
    gv = V.greedy_verify(cand, logits, tdt)
    sv = V.sample_verify_tree(cand, logits, mprob, tdt,
                              S.uniform((Bw, 2, tdt.Cmax), gen),
                              S.gumbel((Bw, Vc), gen), temperature=0.0)
    for name in ("acc", "next_token", "last_slot"):
        assert torch.equal(getattr(gv, name), getattr(sv, name))
    assert (gv.acc > 1).any()
    for b in range(Bw):
        n = int(gv.acc[b])
        assert torch.equal(gv.path_tokens[b, :n], sv.path_tokens[b, :n])


# ---------------------------------------------------------------- engine

LAYOUTS = {"dense": ("", "dense"), "int8": ("int8", "dense"),
           "paged": ("", "paged")}


@pytest.fixture(scope="module")
def stack():
    cfg = jax_get_config("openpangu-7b", reduced=True)
    params, _ = split_params(
        jax_get_model(cfg).init_params(jax.random.PRNGKey(1), cfg))
    tb = jax_medusa_63()
    mp, _ = split_params(JM.init_medusa(jax.random.PRNGKey(2), cfg, tb.K,
                                        base_lm_head=params["lm_head"]))
    tparams = bridge.to_torch(jax.tree.map(np.asarray, params), device="cpu")
    tmp = bridge.to_torch(jax.tree.map(np.asarray, mp), device="cpu")
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, cfg.vocab_size, size=(B, S_P)).astype(np.int32)
    lengths = np.array([S_P, 6], np.int32)
    return cfg, params, tparams, tmp, tokens, lengths, mp


def _layout(cfg, name, fused=False):
    dtype, layout = LAYOUTS[name]
    return dataclasses.replace(cfg, cache_dtype=dtype, cache_layout=layout,
                               page_size=PS, verify_fusion=fused)


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_sample_temperature_zero_is_greedy_and_reference_ar(stack, name):
    """accept="sample" at temperature 0, unfused and fused, gives exactly
    the port's greedy tokens and the reference's ``ar_generate`` tokens;
    the sampled AR oracle at temperature 0 gives them too."""
    cfg, params, tparams, tmp, tokens, lengths, mp = stack
    c = _layout(cfg, name)
    jout, _ = jax_ar_generate(c, params, jnp.asarray(tokens),
                              jnp.asarray(lengths),
                              jax_get_model(c).init_cache(c, B, S_MAX),
                              MAX_NEW)
    want = np.asarray(jout)
    tok, plen = _t(tokens), _t(lengths)
    tb = TT.medusa_63()
    for fused in (False, True):
        fc = _layout(cfg, name, fused)
        greedy = SpecEngine(fc, tb, use_kernel=True, device="cpu")
        samp = SpecEngine(fc, tb, use_kernel=True, device="cpu",
                          accept="sample",
                          sampling=SamplingParams(temperature=0.0), seed=3)
        g_out, _, g_st = greedy.generate(tparams, tmp, tok, plen,
                                         greedy.init_cache(B, S_MAX), MAX_NEW)
        s_out, n_out, s_st = samp.generate(tparams, tmp, tok, plen,
                                           samp.init_cache(B, S_MAX), MAX_NEW)
        np.testing.assert_array_equal(s_out.numpy(), want)
        np.testing.assert_array_equal(g_out.numpy(), want)
        assert (n_out == MAX_NEW).all() and s_st.steps == g_st.steps
        assert s_st.steps < MAX_NEW       # multi-token paths were accepted
    ar, _ = ar_generate_sampled(c, tparams, tok, plen,
                                greedy.init_cache(B, S_MAX), MAX_NEW,
                                torch.Generator().manual_seed(1),
                                SamplingParams(temperature=0.0),
                                use_kernel=True)
    np.testing.assert_array_equal(ar.numpy(), want)


def test_spec_step_matches_reference_with_its_draws(stack):
    """One sampled speculative step at per-row temperatures (0.7, 1.0),
    unfused and fused, against the reference's ``spec_step`` under one
    key: the port takes the reference's draws and gives the same Verdict
    and proposer state."""
    from repro.configs.base import SamplingParams as JaxSamplingParams
    from repro.core.engine import SpecEngine as JaxSpecEngine
    cfg, params, tparams, tmp, tokens, lengths, mp = stack
    temps = np.array([0.7, 1.0], np.float32)
    for fused in (False, True):
        c = dataclasses.replace(cfg, verify_fusion=fused)
        jm = jax_get_model(c)
        je = JaxSpecEngine(c, jax_medusa_63(), accept="sample",
                           sampling=JaxSamplingParams(temperature=1.0))
        jc, jl, jb, js = je.prefill(params, mp, jnp.asarray(tokens),
                                    jnp.asarray(lengths),
                                    jm.init_cache(c, B, S_MAX))
        key = jax.random.PRNGKey(31)
        _, _, jv, _ = je.spec_step(params, mp, jc, jl, jb, js, key,
                                   temperature=jnp.asarray(temps))
        eng = SpecEngine(c, TT.medusa_63(), use_kernel=True, device="cpu",
                         accept="sample")
        cache, tl, _, ts = eng.prefill(tparams, tmp, _t(tokens),
                                       _t(lengths), eng.init_cache(B, S_MAX))
        u, g = _draws(key, B, je.dtree, c.vocab_size)
        _, _, tv, _ = eng.spec_step(
            tparams, tmp, cache, tl, _t(np.asarray(jb)), ts,
            draws=Draws(_t(u), _t(g)), temperature=_t(temps))
        _assert_same_verdict(tv, jv)


def _tiny_vocab_stack(seed=2):
    """The reference's tiny-vocabulary TVD setup on openPangu-7B's reduced
    widths: vocabulary 16, 2 layers, cartesian (2, 2) tree, untrained
    heads (heavy rejection, so the residual path carries most of the
    mass), 1024 rows of one 4-token prompt."""
    cfg = dataclasses.replace(jax_get_config("openpangu-7b", reduced=True),
                              vocab_size=16, num_layers=2)
    params, _ = split_params(
        jax_get_model(cfg).init_params(jax.random.PRNGKey(seed), cfg))
    tb = jax_cartesian_tree((2, 2))
    mp, _ = split_params(JM.init_medusa(jax.random.PRNGKey(seed + 1), cfg,
                                        tb.K))
    mp["w1"] = jax.random.normal(jax.random.PRNGKey(seed + 2),
                                 mp["w1"].shape, mp["w1"].dtype) * 0.1
    tparams = bridge.to_torch(jax.tree.map(np.asarray, params), device="cpu")
    tmp = bridge.to_torch(jax.tree.map(np.asarray, mp), device="cpu")
    prompt = np.asarray(jax.random.randint(jax.random.PRNGKey(0), (1, 4), 0,
                                           cfg.vocab_size), np.int32)
    return cfg, tparams, tmp, np.repeat(prompt, 1024, axis=0)


@pytest.mark.parametrize("fused", [False, True])
def test_sampled_distribution_matches_ar_sampled(fused):
    """Tiny-vocabulary distribution equality: 1024 rows of sampled
    speculative decoding against the sampled AR oracle, gated against the
    AR-vs-AR sampling-noise floor (the reference's rule)."""
    cfg, tparams, tmp, toks = _tiny_vocab_stack()
    c = dataclasses.replace(cfg, verify_fusion=fused)
    Bt, NEW = toks.shape[0], 5
    SMAX = 4 + NEW + 7 + 8
    sp = SamplingParams(temperature=0.9)
    tok, plen = _t(toks), torch.full((Bt,), 4, dtype=torch.int32)
    eng = SpecEngine(c, TT.cartesian_tree((2, 2)), use_kernel=True,
                     device="cpu", accept="sample", sampling=sp, seed=21)
    spec, n_out, _ = eng.generate(tparams, tmp, tok, plen,
                                  eng.init_cache(Bt, SMAX), NEW)
    assert (n_out == NEW).all()
    ar1, ar2 = (ar_generate_sampled(c, tparams, tok, plen,
                                    eng.init_cache(Bt, SMAX), NEW,
                                    torch.Generator().manual_seed(s), sp,
                                    use_kernel=True)[0]
                for s in (22, 23))
    floor = S.max_marginal_tvd(ar1, ar2, c.vocab_size)
    tvd = S.max_marginal_tvd(spec, ar1, c.vocab_size)
    assert tvd <= 1.5 * floor + 0.05, (tvd, floor)
    assert not torch.equal(ar1, ar2)


# ---------------------------------------------------- the captured step

class _FakeGraph:
    """A captured graph's semantics on the CPU (``test_torch_graphs.py``):
    the capture's run stands for the first replay's step; every later
    replay runs the step again without counting."""

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
    """Stand-ins for the capture's CUDA calls; returns the (step,
    generators) of every capture."""
    captured = []

    def capture(fn, pool, device, generators=()):
        captured.append((fn, generators))
        fn()
        return _FakeGraph(fn)

    monkeypatch.setattr(runtime, "_capturable", lambda device: True)
    monkeypatch.setattr(runtime, "_on_side_stream",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(runtime, "_capture_graph", capture)
    monkeypatch.setattr(runtime, "_graph_pool", lambda: None)
    return captured


@pytest.mark.parametrize("fused", [False, True])
def test_captured_sampled_step_replays_the_eager_draws(stack, stub_cuda,
                                                       fused):
    """The sampled loop through stubbed graphs: the engine's generator is
    registered with its capture; the tokens equal the eager engine's from
    the same seed; a second run at another temperature (0: greedy)
    replays the same graph with no new capture and gives the greedy
    tokens, so the temperature is read from the carry, not frozen into
    the capture."""
    cfg, _, tparams, tmp, tokens, lengths, _ = stack
    c = dataclasses.replace(cfg, verify_fusion=fused)
    tb = TT.medusa_63()
    kw = dict(use_kernel=True, device="cpu", accept="sample",
              sampling=SamplingParams(temperature=0.7), seed=5)
    eng = SpecEngine(c, tb, **kw)
    eager = SpecEngine(c, tb, graphs=False, **kw)
    tok, plen = _t(tokens), _t(lengths)
    want, _, want_st = eager.generate(tparams, tmp, tok, plen,
                                      eager.init_cache(B, S_MAX), MAX_NEW)
    got, _, st = eng.generate(tparams, tmp, tok, plen,
                              eng.init_cache(B, S_MAX), MAX_NEW)
    assert len(stub_cuda) == 1 and stub_cuda[0][1] == (eng.generator,)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert st.steps == want_st.steps
    greedy = SpecEngine(c, tb, use_kernel=True, device="cpu", graphs=False)
    g_out = greedy.generate(tparams, tmp, tok, plen,
                            greedy.init_cache(B, S_MAX), MAX_NEW)[0]
    assert not torch.equal(got, g_out)   # temperature 0.7 left greedy
    (graph, carry), = eng.step_graphs.kept()
    replays = graph.replays
    t0, _, st0 = eng.generate(tparams, tmp, tok, plen,
                              eng.init_cache(B, S_MAX), MAX_NEW,
                              temperature=torch.zeros(B))
    assert len(stub_cuda) == 1 and graph.replays == replays + st0.steps
    assert isinstance(carry, SpecCarry) and not carry.temperature.any()
    np.testing.assert_array_equal(t0.numpy(), g_out.numpy())


def test_replays_draw_fresh_noise(stub_cuda):
    """A captured step that draws from its generator: each replay draws
    new numbers, the numbers the eager steps draw from the same state."""
    gen = torch.Generator().manual_seed(0)
    out = torch.zeros(6)
    graph = runtime.StepGraph(lambda: out.copy_(S.uniform((6,), gen)),
                              "cuda", generators=(gen,))
    seen = []
    for _ in range(4):
        graph()
        seen.append(out.clone())
    assert stub_cuda[0][1] == (gen,)
    gen.manual_seed(0)
    for k in range(4):
        assert torch.equal(seen[k], S.uniform((6,), gen))
    assert not torch.equal(seen[2], seen[3])


def test_capture_that_refuses_the_generator_raises(stack, monkeypatch):
    """A capture that fails on the generator (as CUDA refuses a draw from
    an unregistered generator) raises; the step does not run eagerly."""
    cfg, _, tparams, tmp, tokens, lengths, _ = stack

    def capture(fn, pool, device, generators=()):
        raise RuntimeError("Attempt to increase offset for a CUDA generator "
                           "not in capture mode")

    monkeypatch.setattr(runtime, "_capturable", lambda device: True)
    monkeypatch.setattr(runtime, "_on_side_stream",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(runtime, "_capture_graph", capture)
    monkeypatch.setattr(runtime, "_graph_pool", lambda: None)
    eng = SpecEngine(cfg, TT.medusa_63(), use_kernel=True, device="cpu",
                     accept="sample")
    with pytest.raises(RuntimeError, match="no eager fallback"):
        eng.generate(tparams, tmp, _t(tokens), _t(lengths),
                     eng.init_cache(B, S_MAX), MAX_NEW)


# ---------------------------------------------------------- refusals

def test_refusals(stack):
    cfg = dataclasses.replace(stack[0], verify_fusion=True)
    with pytest.raises(ValueError, match="typical"):
        SpecEngine(cfg, device="cpu", accept="typical")
    for sp in (SamplingParams(top_p=0.9), SamplingParams(top_k=5)):
        with pytest.raises(ValueError, match="top_k=0 and top_p=1.0"):
            SpecEngine(cfg, device="cpu", accept="sample", sampling=sp)
    with pytest.raises(ValueError, match="unknown accept"):
        SpecEngine(stack[0], device="cpu", accept="nucleus")
    with pytest.raises(ValueError, match="top_p=1.0"):
        serve.main(["--reduced", "--device", "cpu", "--accept", "sample",
                    "--verify-fusion", "--top-p", "0.9"])


def test_typical_engine_runs(stack):
    """accept="typical" on the unfused path: every request reaches its
    budget, and the stream differs from greedy (it samples)."""
    cfg, _, tparams, tmp, tokens, lengths, _ = stack
    tb = TT.medusa_63()
    eng = SpecEngine(cfg, tb, use_kernel=True, device="cpu",
                     accept="typical", temperature=0.7, seed=2)
    out, n_out, st = eng.generate(tparams, tmp, _t(tokens), _t(lengths),
                                  eng.init_cache(B, S_MAX), MAX_NEW)
    assert (n_out == MAX_NEW).all() and st.steps < MAX_NEW
    assert ((out >= 0) & (out < cfg.vocab_size)).all()


def test_launcher_sampled_temperature_zero_answers_as_greedy():
    argv = ["--static", "--reduced", "--device", "cpu", "--requests", "2",
            "--slots", "2", "--max-new", "8", "--min-prompt", "4",
            "--max-prompt", "12"]
    greedy = serve.main(argv)
    zero = serve.main(argv + ["--accept", "sample", "--temperature", "0"])
    hot = serve.main(argv + ["--accept", "sample", "--temperature", "0.7"],
                     weights=(greedy.params, greedy.proposer_params))
    for a, b in zip(greedy.results, zero.results):
        np.testing.assert_array_equal(a["output"], b["output"])
    assert all(r["status"] == "done" and len(r["output"]) == 8
               for r in hot.results)
