"""The port's draft-model and n-gram proposers, the chain walks that verify
them and the engine that serves them, against the JAX reference on
reduced openPangu-7B, on the CPU.

* ``NgramProposer``: ``prime`` / ``propose`` / ``observe`` /
  ``prime_tokens`` / ``reset_rows`` on both matchers, over long histories
  of a 4-token alphabet hashed into 8 buckets (every table bucket
  collides): history, lengths, candidates and hash tables bitwise equal to
  the reference's at every step.  The reference's four n-gram unit tests,
  ported.
* ``DraftModelProposer.propose`` (greedy, at the full chain and at a
  shorter one): candidates exactly, the draft logits and the draft
  cache's written rows within 3e-5 (f32, in units of their largest
  magnitude), the rolled-back length exactly.
* ``sample_verify_chain`` / ``sample_verify_chain_stats`` against the
  reference's walks on adversarial logits (argmax ties, near-one-hot
  rows, a row at 30x scale), the reference's draws injected (its key
  split into ``uniform(ku, (B, gamma))`` and ``gumbel(kr, (B, V))``):
  every Verdict field exactly, and the port's two walks equal.
* Engines: ``build_engine(cfg, "draft" | "ngram")`` token for token
  against the live reference ``SpecEngine(proposer=...)`` (equal steps and
  accepted sums) on the dense fp cache, the paged int8 cache, with verify
  fusion and deferred; the identity matrix (proposer x layout x dtype x
  {greedy, sample at temperature 0}) against the port's own
  ``ar_generate``; a self-draft accepts every proposal; the nested state
  through a stubbed capture (as ``test_torch_graphs.py``): graph tokens ==
  eager tokens, launches exact, greedy and sampled; the sampled chain's
  distribution gate on a 16-token vocabulary; the launcher's
  ``--proposer``; the refusals.

Integer outputs are compared exactly; float32 logits and cache rows within
3e-5 in units of their largest magnitude.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.core import medusa as JM
from repro.core import proposers as JP
from repro.core import verify as JV
from repro.core.engine import SpecEngine as JaxSpecEngine
from repro.core.tree import chain_tree as jax_chain_tree
from repro.distributed.sharding import split_params
from repro.kernels import ref as JR
from repro.models.api import get_model as jax_get_model
from repro_torch import bridge, runtime
from repro_torch.configs.base import SamplingParams
from repro_torch.core import proposers as P
from repro_torch.core import sampling as S
from repro_torch.core import verify as V
from repro_torch.core.draft_model import DraftSpecEngine
from repro_torch.core.engine import (SpecCarry, ar_generate,
                                     ar_generate_sampled, build_engine)
from repro_torch.core.tree import chain_tree
from repro_torch.launch import serve
from repro_torch.models import transformer
from test_torch_cuda import _expected_counts as _target_counts
from test_torch_graphs import WRAPPERS, _count_on_cpu
from test_torch_sampling import stub_cuda  # noqa: F401  (a fixture)

B, S_P, MAX_NEW, S_MAX, PS, GAMMA = 2, 8, 16, 64, 16, 4
TOL = 3e-5


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


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _jtree(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want):
    """Within ``TOL`` in units of ``want``'s largest magnitude (at least 1),
    ``test_torch_layers.py``'s rule: the residual stream of this reduced
    model reaches |x| ~ 34, so a logit or a cache row carries the f32
    rounding of sums that large, taken in other orders by the two
    frameworks."""
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=TOL)


@pytest.fixture(scope="module")
def stack():
    """Reduced openPangu-7B (4 layers), its Medusa heads, and a 2-layer
    draft that is the target's first two layers (so it agrees with the
    target often and chains of every length are accepted).  For the
    n-gram lookup, the same target with its attention output projection
    zeroed (each token then depends on the one before alone, so the
    greedy continuation runs into a cycle the lookup proposes), prompted
    with the starts of its own greedy chains."""
    cfg = jax_get_config("openpangu-7b", reduced=True)
    params, _ = split_params(
        jax_get_model(cfg).init_params(jax.random.PRNGKey(1), cfg))
    dcfg = dataclasses.replace(cfg, num_layers=2, name=cfg.name + "-draft")
    dparams = dict(params, units=jax.tree.map(lambda x: x[:2],
                                              params["units"]))
    mp, _ = split_params(JM.init_medusa(jax.random.PRNGKey(2), cfg, 4,
                                        base_lm_head=params["lm_head"]))
    attn = params["units"]["pos0"]["attn"]
    lparams = dict(params, units={"pos0": dict(
        params["units"]["pos0"], attn=dict(attn, wo=attn["wo"] * 0))})
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, cfg.vocab_size, size=(B, S_P)).astype(np.int32)
    lengths = np.array([S_P, 6], np.int32)
    to = lambda tree: bridge.to_torch(_jtree(tree), device="cpu")  # noqa
    chains, _ = ar_generate(cfg, to(lparams), _t(tokens[:, :1]),
                            torch.ones((B,), dtype=torch.int32),
                            transformer.init_cache(cfg, B, S_MAX,
                                                   device="cpu"), 24)
    return dict(cfg=cfg, dcfg=dcfg, params=params, dparams=dparams,
                tparams=to(params), tdparams=to(dparams), tmp=to(mp),
                tokens=tokens, lengths=lengths, lparams=lparams,
                tlparams=to(lparams), ltokens=chains[:, :S_P].numpy())


# ---------------------------------------------------------------- n-gram

def _verdict(acc, path_tokens, next_token, K1):
    """The same verdict for both frameworks (path slots unused here)."""
    Bv = len(acc)
    acc = np.asarray(acc, np.int32)
    pt = np.asarray(path_tokens, np.int32)
    nt = np.asarray(next_token, np.int32)
    j = JV.Verdict(jnp.asarray(acc), jnp.zeros((Bv, K1), jnp.int32),
                   jnp.asarray(pt), jnp.asarray(nt),
                   jnp.zeros((Bv,), jnp.int32))
    t = V.Verdict(_t(acc), torch.zeros((Bv, K1), dtype=torch.int64),
                  _t(pt), _t(nt), torch.zeros((Bv,), dtype=torch.int64))
    return j, t


def _assert_state_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(_np(got[k]), _np(want[k]), k)


@pytest.mark.parametrize("matcher", ["scan", "automaton"])
def test_ngram_state_bitwise_equals_reference(stack, matcher):
    """Prime, six propose/observe rounds with random accepted lengths,
    then ``prime_tokens`` on a row mask and ``reset_rows``: every state
    leaf (history, lengths, the hash tables) and every candidate bitwise
    the reference's.  A 4-token alphabet over 8 buckets makes every
    bucket hold colliding windows, and one row's history fills to its
    capacity (the clipped appends)."""
    cfg = stack["cfg"]
    rng = np.random.default_rng(5)
    Bn, H, Sp, vocab, bits = 3, 300, 296, 4, 3
    jp = JP.NgramProposer(cfg, gamma=GAMMA, max_n=3, min_n=1,
                          matcher=matcher, table_bits=bits)
    tp = P.NgramProposer(cfg, gamma=GAMMA, max_n=3, min_n=1,
                         matcher=matcher, table_bits=bits, device="cpu")
    tokens = rng.integers(0, vocab, (Bn, Sp)).astype(np.int32)
    tok_lens = np.array([Sp, 150, 3], np.int32)
    base = rng.integers(0, vocab, Bn).astype(np.int32)
    windows = {tuple(tokens[0, s:s + 3]) for s in range(Sp - 2)}
    assert len(windows) > 1 << bits            # the table must collide
    js = jp.prime(None, jp.init_state(Bn, H), jnp.asarray(tokens), None,
                  jnp.asarray(tok_lens), None, jnp.asarray(base))
    ts = tp.prime(None, tp.init_state(Bn, H), _t(tokens), None,
                  _t(tok_lens), None, _t(base))
    _assert_state_equal(ts, js)
    assert ("tab" in ts) == (matcher == "automaton")
    K1 = GAMMA + 1
    found = 0
    for step in range(6):
        jc, jq, _ = jp.propose(None, js, jnp.asarray(base),
                               jax.random.PRNGKey(0), 1.0, 0, 1.0, False)
        tc, tq, _ = tp.propose(None, ts, _t(base))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        found += int((tc[:, 1:] != 0).any(1).sum())
        acc = rng.integers(1, K1 + 1, Bn)
        nxt = rng.integers(0, vocab, Bn)
        jv, tv = _verdict(acc, np.asarray(jc), nxt, K1)
        js = jp.observe(None, js, jv, None, None)
        ts = tp.observe(None, ts, tv, None, None)
        _assert_state_equal(ts, js)
        base = nxt.astype(np.int32)
    assert found > 0                                  # lookups hit
    assert int(ts["hlen"][0]) == H                    # row 0 saturated
    mask = np.array([False, True, True])
    new = rng.integers(0, vocab, (Bn, 40)).astype(np.int32)
    nl = np.array([40, 12, 30], np.int32)
    js = jp.prime_tokens(js, jnp.asarray(new), jnp.asarray(nl),
                         jnp.asarray(base), jnp.asarray(mask))
    ts = tp.prime_tokens(ts, _t(new), _t(nl), _t(base), _t(mask))
    _assert_state_equal(ts, js)
    keep = np.array([True, False, True])
    _assert_state_equal(tp.reset_rows(ts, _t(keep)),
                        jp.reset_rows(js, jnp.asarray(keep)))


def test_ngram_auto_matcher_switches_at_capacity(stack):
    p = P.NgramProposer(stack["cfg"], matcher="auto", device="cpu")
    assert "tab" not in p.init_state(1, p.AUTO_THRESHOLD - 1)
    assert p.init_state(1, p.AUTO_THRESHOLD)["tab"].shape == (1, 3, 1 << 14)


@pytest.mark.parametrize("matcher", ["scan", "automaton"])
def test_ngram_propose_matches_longest_most_recent(stack, matcher):
    """Longest n wins; among equal-n matches the most recent occurrence
    wins; the history's own suffix never matches itself (the reference's
    unit test)."""
    p = P.NgramProposer(stack["cfg"], gamma=3, max_n=2, min_n=1,
                        matcher=matcher, device="cpu")
    hist = np.zeros((2, 16), np.int32)
    hist[0, :8] = [1, 2, 3, 1, 2, 9, 1, 2]
    hist[1, :5] = [9, 8, 6, 5, 6]
    hlen = _t(np.array([8, 5], np.int32))
    state = {"hist": _t(hist), "hlen": hlen}
    if matcher == "automaton":
        state["tab"] = p._tab_build(state["hist"], hlen)
    cand, q, _ = p.propose(None, state, _t(np.array([2, 6], np.int32)))
    np.testing.assert_array_equal(cand[0].numpy(), [2, 9, 1, 2])
    np.testing.assert_array_equal(cand[1].numpy(), [6, 5, 6, 0])
    assert q.shape == (2, 3, 1) and float(q.min()) == 1.0


@pytest.mark.parametrize("matcher", ["scan", "automaton"])
def test_ngram_propose_no_match_and_short_history(stack, matcher):
    """Rows without any match (or with a history shorter than min_n + 1)
    propose the zero token."""
    p = P.NgramProposer(stack["cfg"], gamma=2, max_n=3, min_n=2,
                        matcher=matcher, device="cpu")
    hist = np.zeros((2, 8), np.int32)
    hist[0, :4] = [1, 2, 3, 4]
    hist[1, :1] = [5]
    hlen = _t(np.array([4, 1], np.int32))
    state = {"hist": _t(hist), "hlen": hlen}
    if matcher == "automaton":
        state["tab"] = p._tab_build(state["hist"], hlen)
    cand, _, _ = p.propose(None, state, _t(np.array([4, 5], np.int32)))
    np.testing.assert_array_equal(cand.numpy(), [[4, 0, 0], [5, 0, 0]])


def test_ngram_observe_appends_accepted_path(stack):
    """observe() appends path_tokens[1:acc] + next_token (acc tokens); the
    garbage beyond the claim is overwritten by the next append."""
    p = P.NgramProposer(stack["cfg"], gamma=2, device="cpu")
    state = p.prime(None, p.init_state(1, 12), _t([[7, 8]]), None,
                    _t(np.array([2], np.int32)), None,
                    _t(np.array([9], np.int32)))
    np.testing.assert_array_equal(state["hist"][0, :3].numpy(), [7, 8, 9])
    assert int(state["hlen"][0]) == 3
    _, v = _verdict([2], [[9, 4, 99]], [5], 3)
    state = p.observe(None, state, v, None, None)
    np.testing.assert_array_equal(state["hist"][0, :5].numpy(),
                                  [7, 8, 9, 4, 5])
    assert int(state["hlen"][0]) == 5
    _, v2 = _verdict([1], [[5, 88, 88]], [6], 3)
    state = p.observe(None, state, v2, None, None)
    np.testing.assert_array_equal(state["hist"][0, :6].numpy(),
                                  [7, 8, 9, 4, 5, 6])
    assert int(state["hlen"][0]) == 6


def test_ngram_lossless_on_self_repeating_prompt(stack):
    """A prompt of repeated segments maximises n-gram matches (every suffix
    recurs), and the output is still exactly the greedy AR continuation:
    proposals can only shorten accepted paths, never change tokens."""
    cfg, tparams = stack["cfg"], stack["tparams"]
    toks = _t(stack["tokens"][:1])
    lens = torch.tensor([S_P], dtype=torch.int32)
    eng = build_engine(cfg, "ngram", gamma=4, device="cpu")
    ar, _ = ar_generate(cfg, tparams, toks, lens, eng.init_cache(1, 64), 12)
    big = torch.cat([toks, ar[:, :8], toks, ar[:, :8]], dim=1)
    blens = torch.tensor([big.shape[1]], dtype=torch.int32)
    smax = big.shape[1] + 12 + 16
    ar2, _ = ar_generate(cfg, tparams, big, blens, eng.init_cache(1, smax),
                         12)
    out, _, _ = eng.generate(tparams, None, big, blens,
                             eng.init_cache(1, smax), 12)
    np.testing.assert_array_equal(out.numpy(), ar2.numpy())


# ----------------------------------------------------------------- draft

@pytest.mark.parametrize("short", [False, True])
def test_draft_propose_matches_reference(stack, short):
    """One greedy propose of the 2-layer draft after its prefill: the
    candidates exactly, the draft's logits and the cache rows it wrote
    within 3e-5 in units of their largest magnitude (``_close``), its
    length rolled back to lengths + gamma; ``short`` proposes on a
    2-token chain (2 + 1 decode steps)."""
    cfg, dcfg = stack["cfg"], stack["dcfg"]
    tokens, lengths = stack["tokens"], stack["lengths"]
    base = np.array([3, 17], np.int32)
    jp = JP.DraftModelProposer(cfg, dcfg, gamma=GAMMA)
    tp = P.DraftModelProposer(cfg, dcfg, gamma=GAMMA, device="cpu",
                              use_kernel=True)
    g = 2 if short else GAMMA
    jdt = JV.device_tree(jax_chain_tree(2)) if short else None
    tdt = V.device_tree(chain_tree(2), "cpu") if short else None
    js = jp.prime(stack["dparams"], jp.init_state(B, S_MAX),
                  jnp.asarray(tokens), jnp.asarray(lengths),
                  jnp.asarray(lengths), None, jnp.asarray(base))
    ts = tp.prime(stack["tdparams"], tp.init_state(B, S_MAX), _t(tokens),
                  _t(lengths), _t(lengths), None, _t(base))
    jc, jq, js = jp.propose(stack["dparams"], js, jnp.asarray(base),
                            jax.random.PRNGKey(0), 1.0, 0, 1.0, False,
                            dtree=jdt)
    tc, tq, ts = tp.propose(stack["tdparams"], ts, _t(base), dtree=tdt)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert tc.shape == (B, g + 1) and tq.shape == (B, g, cfg.vocab_size)
    _close(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts["len"].numpy(), lengths + g)
    np.testing.assert_array_equal(ts["len"].numpy(), np.asarray(js["len"]))
    for name in ("k", "v"):
        want = np.asarray(js["cache"]["pos0"][name])
        got = ts["cache"]["pos0"][name].numpy()
        for b, n in enumerate(lengths + g + 1):   # + the extra step's row
            _close(got[:, b, :n], want[:, b, :n])
    keep = np.array([False, True])
    want = jp.reset_rows(js, jnp.asarray(keep))
    got = tp.reset_rows(ts, _t(keep))
    np.testing.assert_array_equal(got["len"].numpy(), np.asarray(want["len"]))
    assert not got["cache"]["pos0"]["k"][:, 0].any()
    assert torch.equal(got["cache"]["pos0"]["k"][:, 1],
                       ts["cache"]["pos0"]["k"][:, 1])


# ----------------------------------------------------------- chain walks

def _adversarial_logits(rng, Bw, T, Vc):
    """``tests/test_verify_fusion.py``'s recipe: random logits with
    injected argmax ties, near-one-hot rows and a huge-scale row."""
    logits = rng.standard_normal((Bw, T, Vc)).astype(np.float32) * 3
    logits[0, :, 1] = logits[0].max(-1)
    logits[0, :, 0] = logits[0, :, 1]
    logits[1] = -1e9
    logits[1, :, rng.integers(0, Vc)] = 0.0
    logits[2] *= 30.0
    return logits


def _stats(logits, cand, temp_t):
    """The fused kernel's statistics of ``logits`` (an identity unembed),
    from the reference's oracle, as numpy."""
    Bw, _, Vc = logits.shape
    tmax = np.maximum(np.broadcast_to(np.asarray(temp_t, np.float32), (Bw,)),
                      np.float32(1e-6)).astype(np.float32)
    return [np.asarray(a) for a in JR.verify_stats_ref(
        jnp.asarray(logits), jnp.eye(Vc, dtype=jnp.float32),
        jnp.asarray(cand), jnp.asarray(tmax))]


def _assert_same_verdict(got, want):
    for name in JV.Verdict._fields:
        np.testing.assert_array_equal(_np(getattr(got, name)),
                                      np.asarray(getattr(want, name)), name)


@pytest.mark.parametrize("temp", [0.0, 1e-4, 0.9, "mixed"])
def test_sample_verify_chain_matches_reference(temp):
    """Both chain walks against the reference's on adversarial logits with
    its draws injected, and the port's stats walk equal to its logits
    walk on every row whose drafted tokens the draft could have drawn
    (q(x) > 0 at every position, the walk's contract); rows 3..5 propose
    the draft's argmax, so long chains are accepted.  Rows 0..2 draft
    random tokens: where q(x) = 0 and the f32 nucleus trim (top_p 1.0)
    zeroes p(x) in the warped row, the logits walk rejects (0 < 0 fails)
    while the stats walk, whose p(x) is exp(cand_w - m) / l > 0,
    accepts; the reference's two walks part there the same way."""
    Bw, Vc = 6, 33
    jdt = JV.device_tree(jax_chain_tree(GAMMA))
    tdt = V.device_tree(chain_tree(GAMMA), "cpu")
    accepted = 0
    for trial in range(4):
        rng = np.random.default_rng(100 + trial)
        logits = _adversarial_logits(rng, Bw, GAMMA + 1, Vc)
        dlog = _adversarial_logits(rng, Bw, GAMMA, Vc)
        dlog[3:] = logits[3:, :GAMMA] + rng.standard_normal(
            (Bw - 3, GAMMA, Vc)).astype(np.float32) * 0.3
        cand = rng.integers(0, Vc, (Bw, GAMMA + 1)).astype(np.int32)
        cand[0] = np.argmax(logits[0], -1)
        cand[3:, 1:] = np.argmax(dlog[3:], -1)
        if temp == "mixed":
            t_np = np.array([0.0, 0.5, 1.0, 1.3, 0.7, 1e-4], np.float32)
            jt, tt = jnp.asarray(t_np), _t(t_np)
        else:
            t_np, jt, tt = temp, temp, temp
        key = jax.random.PRNGKey(7 + trial)
        ku, kr = jax.random.split(key)
        u = np.asarray(jax.random.uniform(ku, (Bw, GAMMA)))
        g = np.asarray(jax.random.gumbel(kr, (Bw, Vc)))
        want = JV.sample_verify_chain(jnp.asarray(cand), jnp.asarray(logits),
                                      jnp.asarray(dlog), jdt, key,
                                      temperature=jt)
        got = V.sample_verify_chain(_t(cand), _t(logits), _t(dlog), tdt,
                                    _t(u), _t(g), temperature=tt)
        _assert_same_verdict(got, want)
        st = _stats(logits, cand, t_np)
        rows = np.arange(Bw)
        jwant = JV.sample_verify_chain_stats(
            jnp.asarray(cand), JV.VerifyStats(*map(jnp.asarray, st)),
            jnp.asarray(dlog), jdt, key,
            lambda idx: jnp.asarray(logits)[rows, idx], temperature=jt)
        tl = _t(logits)
        fused = V.sample_verify_chain_stats(
            _t(cand), V.VerifyStats(*map(_t, st)), _t(dlog), tdt, _t(u),
            _t(g), lambda idx: tl[torch.arange(Bw), idx], temperature=tt)
        _assert_same_verdict(fused, jwant)
        q = S.warp_probs(_t(dlog), tt)
        qx = torch.gather(q, -1, _t(cand[:, 1:]).long()[..., None])[..., 0]
        drawable = (qx > 0).all(1)
        assert drawable[3:].all()
        for name in V.Verdict._fields:
            a, b = getattr(fused, name), getattr(got, name)
            assert torch.equal(a[drawable], b[drawable]), name
        accepted += int((got.acc[drawable] > 2).sum())
    assert accepted > 0


# --------------------------------------------------------------- engines

# name: (cache_dtype, cache_layout, verify_fusion, deferred)
VS_JAX = {"dense": ("", "dense", False, False),
          "paged int8": ("int8", "paged", False, False),
          "fused": ("", "dense", True, False),
          "deferred": ("", "dense", False, True)}


def _cfg(cfg, dtype="", layout="dense", fused=False):
    return dataclasses.replace(cfg, cache_dtype=dtype, cache_layout=layout,
                               page_size=PS, verify_fusion=fused)


@pytest.mark.parametrize("name", list(VS_JAX))
@pytest.mark.parametrize("kind", ["draft", "ngram"])
def test_engine_matches_live_reference(stack, kind, name):
    """``build_engine(cfg, kind)`` against the reference ``SpecEngine`` with
    the same proposer and weights: every token, the steps and the
    accepted sum exactly; chains are accepted (the n-gram lookup on the
    stack's lookup target and prompts)."""
    dtype, layout, fused, deferred = VS_JAX[name]
    c = _cfg(stack["cfg"], dtype, layout, fused)
    draft = kind == "draft"
    params, tparams, tokens = (
        (stack["params"], stack["tparams"], stack["tokens"]) if draft else
        (stack["lparams"], stack["tlparams"], stack["ltokens"]))
    jp = JP.make_proposer(kind, c, draft_cfg=stack["dcfg"], gamma=GAMMA)
    jeng = JaxSpecEngine(c, proposer=jp, deferred=deferred)
    jout, jn, jst = jeng.generate(
        params, stack["dparams"] if draft else None, jnp.asarray(tokens),
        jnp.asarray(stack["lengths"]),
        jax_get_model(c).init_cache(c, B, S_MAX), MAX_NEW)
    eng = build_engine(c, kind, draft_cfg=stack["dcfg"], gamma=GAMMA,
                       use_kernel=True, device="cpu", deferred=deferred)
    out, n_out, st = eng.generate(tparams,
                                  stack["tdparams"] if draft else None,
                                  _t(tokens), _t(stack["lengths"]),
                                  eng.init_cache(B, S_MAX), MAX_NEW)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(n_out.numpy(), np.asarray(jn))
    assert (st.steps, int(st.accepted_sum)) == (int(jst.steps),
                                                int(jst.accepted_sum))
    np.testing.assert_array_equal(st.accepted_per_slot.numpy(),
                                  np.asarray(jst.accepted_per_slot))
    assert st.steps < MAX_NEW


_AR = {}


@pytest.mark.parametrize("accept", ["greedy", "sample"])
@pytest.mark.parametrize("dtype", ["", "int8"])
@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("kind", ["medusa", "draft", "ngram"])
def test_identity_matrix_equals_port_ar(stack, kind, layout, dtype, accept):
    """Greedy, and sampled at temperature 0, equal the port's own greedy
    ``ar_generate`` for every proposer on every cache layout and dtype."""
    c = _cfg(stack["cfg"], dtype, layout)
    tok, plen = _t(stack["tokens"]), _t(stack["lengths"])
    if (layout, dtype) not in _AR:
        _AR[layout, dtype] = ar_generate(
            c, stack["tparams"], tok, plen,
            transformer.init_cache(c, B, S_MAX, device="cpu"), MAX_NEW,
            use_kernel=True)[0]
    sampling = SamplingParams(temperature=0.0) if accept == "sample" else None
    eng = build_engine(c, kind, draft_cfg=stack["dcfg"], gamma=3,
                       use_kernel=True, device="cpu", accept=accept,
                       sampling=sampling)
    pp = {"medusa": stack["tmp"], "draft": stack["tdparams"],
          "ngram": None}[kind]
    out, n_out, st = eng.generate(stack["tparams"], pp, tok, plen,
                                  eng.init_cache(B, S_MAX), MAX_NEW)
    np.testing.assert_array_equal(out.numpy(), _AR[layout, dtype].numpy())
    assert (n_out == MAX_NEW).all() and st.steps <= MAX_NEW


def test_self_draft_accepts_everything(stack):
    """Draft == target: every proposal is accepted, gamma + 1 tokens a
    step, which holds only if the draft's extra step writes the last
    proposal's row and the length rollback keeps the cache aligned."""
    cfg, tparams = stack["cfg"], stack["tparams"]
    eng = DraftSpecEngine(cfg, cfg, gamma=GAMMA, use_kernel=True,
                          device="cpu")
    toks, lens, new = _t(stack["tokens"][:1]), _t(stack["lengths"][:1]), 15
    tcache, dcache = eng.init_caches(1, S_MAX)
    out, n_out, steps = eng.generate(tparams, tparams, toks, lens, tcache,
                                     dcache, new)
    ar, _ = ar_generate(cfg, tparams, toks, lens,
                        transformer.init_cache(cfg, 1, S_MAX, device="cpu"),
                        new, use_kernel=True)
    np.testing.assert_array_equal(out.numpy(), ar.numpy())
    assert steps <= -(-new // (GAMMA + 1)) + 1


def test_refusals(stack):
    cfg = stack["cfg"]
    bad = dataclasses.replace(stack["dcfg"], vocab_size=cfg.vocab_size + 1)
    with pytest.raises(ValueError, match="tokenizer alignment"):
        P.DraftModelProposer(cfg, bad, device="cpu")
    with pytest.raises(ValueError, match="tokenizer alignment"):
        DraftSpecEngine(cfg, bad, device="cpu")
    with pytest.raises(ValueError, match="unknown proposer"):
        P.make_proposer("eagle", cfg, device="cpu")
    with pytest.raises(ValueError, match="draft_cfg"):
        P.make_proposer("draft", cfg, device="cpu")
    with pytest.raises(ValueError, match="min_n"):
        P.NgramProposer(cfg, max_n=1, min_n=2, device="cpu")
    with pytest.raises(ValueError, match="matcher"):
        P.NgramProposer(cfg, matcher="trie", device="cpu")


# ------------------------------------------------- the captured step

def _expected_counts(eng, steps):
    """``chip_smoke.py``'s ``expected_counts`` for a draft engine: the
    target's launches, plus the draft's gamma + 1 T=1 decodes a step on
    each of its layers (K1, and K3 on its fused fp write side)."""
    want = _target_counts(eng.cfg, steps, 0)
    t1 = eng.proposer.dc.num_layers * (eng.dtree.K + 1) * steps
    want["K1"] += t1
    if want["K3"]:
        want["K3"] += t1
    return want


@pytest.mark.parametrize("accept", ["greedy", "sample"])
@pytest.mark.parametrize("name", ["dense fused", "paged int8"])
def test_nested_state_through_stubbed_capture(stack, stub_cuda, monkeypatch,
                                              name, accept):
    """The draft engine's loop through stubbed graphs: its state (the
    draft's cache inside a nested dict) rides in the carry; one capture
    (registering the generator when sampled), tokens equal to the eager
    engine's from the same seed, launches exact; a second run on the
    engine's reused cache replays the same graph with no new capture."""
    _count_on_cpu(monkeypatch)
    c = _cfg(stack["cfg"], *(("", "dense", True) if name == "dense fused"
                             else ("int8", "paged", False)))
    kw = dict(draft_cfg=stack["dcfg"], gamma=GAMMA, use_kernel=True,
              device="cpu", accept=accept, seed=4,
              sampling=SamplingParams(temperature=0.7))
    eng = build_engine(c, "draft", **kw)
    eager = build_engine(c, "draft", graphs=False, **kw)
    tok, plen = _t(stack["tokens"]), _t(stack["lengths"])

    def run(e):
        for fn in WRAPPERS.values():
            fn.launches = 0
            for r in getattr(fn, "launches_by_route", ()):
                fn.launches_by_route[r] = 0
        out, _, st = e.generate(stack["tparams"], stack["tdparams"], tok,
                                plen, e.init_cache(B, S_MAX), MAX_NEW)
        assert {k: f.launches for k, f in WRAPPERS.items()} == \
            _expected_counts(e, st.steps)
        return out, st

    want, want_st = run(eager)
    got, st = run(eng)
    (graph, carry), = eng.step_graphs.kept()
    assert isinstance(carry, SpecCarry) and graph.graph is not None
    assert set(carry.state) == {"cache", "len"}
    assert carry.state["cache"]["pos0"]["k"].shape[1] == B
    gens = (eng.generator,) if accept == "sample" else ()
    assert len(stub_cuda) == 1 and stub_cuda[0][1] == gens
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert st.steps == want_st.steps
    replays = graph.replays
    again, st2 = run(eng)
    assert len(stub_cuda) == 1 and graph.replays == replays + st2.steps
    if accept == "greedy":
        np.testing.assert_array_equal(again.numpy(), got.numpy())


@pytest.mark.parametrize("fused", [False, True])
def test_sampled_chain_distribution_matches_ar_sampled(fused):
    """The reference's tiny-vocabulary gate for the draft's sampled chain:
    1024 rows of one 4-token prompt, a 2-layer target and a 1-layer draft
    of other random weights (vocabulary 16), 5 tokens at temperature 0.9
    against ``ar_generate_sampled``: max marginal TVD <= 1.5 * floor +
    0.05, the floor being two AR runs' TVD."""
    from repro_torch.configs.registry import get_config

    cfg = dataclasses.replace(get_config("openpangu-7b", reduced=True),
                              vocab_size=16, num_layers=2, dtype="float32",
                              verify_fusion=fused)
    gen = torch.Generator().manual_seed(2)
    params = transformer.init_params(gen, cfg, dtype="float32")
    eng = build_engine(cfg, "draft", draft_layers=1, gamma=GAMMA,
                       use_kernel=True, device="cpu", accept="sample",
                       sampling=SamplingParams(temperature=0.9), seed=21)
    dparams = transformer.init_params(gen, eng.proposer.dc, dtype="float32")
    Bt, new = 1024, 5
    tok = torch.randint(0, 16, (1, 4), generator=gen,
                        dtype=torch.int32).expand(Bt, 4).contiguous()
    plen = torch.full((Bt,), 4, dtype=torch.int32)
    smax = 4 + new + 2 * GAMMA + 8
    spec, n_out, st = eng.generate(params, dparams, tok, plen,
                                   eng.init_cache(Bt, smax), new)
    # every row reached its budget; some rows took more than a token a step
    assert (n_out == new).all() and (st.tokens_out > st.steps + 1).any()
    ar1, ar2 = (ar_generate_sampled(cfg, params, tok, plen,
                                    eng.init_cache(Bt, smax), new,
                                    torch.Generator().manual_seed(s),
                                    eng.sampling, use_kernel=True)[0]
                for s in (22, 23))
    floor = S.max_marginal_tvd(ar1, ar2, 16)
    tvd = S.max_marginal_tvd(spec, ar1, 16)
    assert tvd <= 1.5 * floor + 0.05, (tvd, floor)


@pytest.mark.parametrize("kind", ["draft", "ngram"])
def test_launcher_serves_each_proposer(kind, capsys):
    """``--proposer draft|ngram``: every request answered with the AR
    baseline's tokens, and the printout names the proposer and its
    tokens a step."""
    srv = serve.main(["--static", "--reduced", "--device", "cpu",
                      "--requests", "3", "--slots", "2", "--max-new", "8",
                      "--max-len", "128", "--proposer", kind, "--gamma",
                      "3"])
    assert [r["status"] for r in srv.results] == ["done"] * 3
    assert srv.engine.dtree.K == 3
    assert (srv.proposer_params is None) == (kind == "ngram")
    printed = capsys.readouterr().out
    assert f"{kind} proposer" in printed and "tokens a step" in printed
    for r, p in zip(srv.results, srv.prompts):
        ar, _ = ar_generate(srv.cfg, srv.params, torch.from_numpy(p[None]),
                            torch.tensor([len(p)], dtype=torch.int32),
                            srv.engine.init_cache(1, 128), 8,
                            use_kernel=True)
        np.testing.assert_array_equal(ar[0].numpy(), r["output"])
