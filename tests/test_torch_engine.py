"""The port's Medusa heads, greedy verification and whole speculative slice
against the JAX reference on reduced openPangu-7B, on the CPU.

Head top-k and verification are integer outputs and must match exactly.
The whole slice must give the same tokens in four ways: the port's
speculative engine (kernel path and plain path), the port's AR baseline,
and the reference ``SpecEngine`` on both of its paths (its Pallas kernel
runs in interpret mode here, as ``tests/test_equivalence.py`` runs it).
Medusa heads are seeded from the lm head (Medusa's init recipe), which on
this random backbone accepts several tokens per step, so the tree path
and the commit of multi-token paths are exercised."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.core import medusa as JM
from repro.core import verify as JV
from repro.core.engine import SpecEngine as JaxSpecEngine
from repro.core.tree import medusa_63
from repro.distributed.sharding import split_params
from repro.models.api import get_model as jax_get_model
from repro_torch import bridge
from repro_torch.core import medusa as M
from repro_torch.core import verify as V
from repro_torch.core.engine import SpecEngine, ar_generate, build_engine
from repro_torch.launch import serve

B, S_P, MAX_NEW, S_MAX = 2, 8, 16, 256


@pytest.fixture
def rng():
    """Each test's inputs from its own seed, whatever ran before it (the
    shared fixture is one generator for the whole session)."""
    return np.random.default_rng(0)


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


@pytest.fixture(scope="module")
def jax_runs(stack):
    cfg, tb, params, mp, _, _, tokens, lengths = stack
    m = jax_get_model(cfg)
    runs = {}
    for use_kernel in (True, False):
        out, n_out, st = JaxSpecEngine(cfg, tb, use_kernel=use_kernel).generate(
            params, mp, jnp.asarray(tokens), jnp.asarray(lengths),
            m.init_cache(cfg, B, S_MAX), MAX_NEW)
        runs[use_kernel] = (np.asarray(out), np.asarray(n_out),
                            int(st.steps), int(st.accepted_sum))
    return runs


def test_medusa_topk_matches_reference(stack, rng):
    cfg, tb, _, _, _, _, _, _ = stack
    mp = {"w1": rng.standard_normal((tb.K, cfg.d_model, cfg.d_model)) * 0.1,
          "b1": rng.standard_normal((tb.K, cfg.d_model)) * 0.1,
          "lm": rng.standard_normal((tb.K, cfg.d_model, cfg.vocab_size)) / 8}
    mp = {k: v.astype(np.float32) for k, v in mp.items()}
    hidden = rng.standard_normal((3, cfg.d_model)).astype(np.float32)
    tok, prob = M.medusa_topk(bridge.to_torch(mp, device="cpu"),
                              torch.from_numpy(hidden), tb.max_topk)
    jtok, jprob = JM.medusa_topk({k: jnp.asarray(v) for k, v in mp.items()},
                                 jnp.asarray(hidden), tb.max_topk)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    np.testing.assert_allclose(prob.numpy(), np.asarray(jprob), atol=1e-6)


def test_greedy_verify_matches_reference(rng):
    tb = medusa_63()
    Bv, V_ = 6, 50
    logits = rng.standard_normal((Bv, tb.T, V_)).astype(np.float32)
    argm = logits.argmax(-1)
    # candidates follow the argmax of their parent, corrupted at random, so
    # accepted paths of every length occur
    cand = argm[:, np.maximum(tb.parent, 0)].astype(np.int32)
    cand[:, 0] = rng.integers(0, V_, size=Bv)
    flip = rng.random(cand.shape) < 0.3
    cand[flip] = rng.integers(0, V_, size=int(flip.sum()))
    mtok = rng.integers(0, V_, size=(Bv, tb.K, tb.max_topk)).astype(np.int32)
    got = V.greedy_verify(torch.from_numpy(cand), torch.from_numpy(logits),
                          V.device_tree(tb, "cpu"))
    ref = JV.greedy_verify(jnp.asarray(cand), jnp.asarray(logits),
                           JV.device_tree(tb))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert len(set(np.asarray(ref.acc).tolist())) > 1
    base = torch.from_numpy(cand[:, 0])
    np.testing.assert_array_equal(
        V.generate_candidates(base, torch.from_numpy(mtok),
                              V.device_tree(tb, "cpu")).numpy(),
        np.asarray(JV.generate_candidates(jnp.asarray(cand[:, 0]),
                                          jnp.asarray(mtok),
                                          JV.device_tree(tb))))


@pytest.mark.parametrize("use_kernel", [True, False])
def test_spec_equals_ar_equals_reference(stack, jax_runs, use_kernel):
    cfg, tb, _, _, tparams, tmp, tokens, lengths = stack
    eng = SpecEngine(cfg, tb, use_kernel=use_kernel, device="cpu")
    tok, plen = torch.from_numpy(tokens), torch.from_numpy(lengths)
    out, n_out, st = eng.generate(tparams, tmp, tok, plen,
                                  eng.init_cache(B, S_MAX), MAX_NEW)
    ar, _ = ar_generate(cfg, tparams, tok, plen, eng.init_cache(B, S_MAX),
                        MAX_NEW, use_kernel=use_kernel)
    jout, jn, jsteps, jacc = jax_runs[use_kernel]
    np.testing.assert_array_equal(out.numpy(), ar.numpy())
    np.testing.assert_array_equal(out.numpy(), jout)
    np.testing.assert_array_equal(out.numpy(), jax_runs[not use_kernel][0])
    np.testing.assert_array_equal(n_out.numpy(), jn)
    assert (st.steps, int(st.accepted_sum)) == (jsteps, jacc)
    assert st.steps < MAX_NEW          # multi-token paths were accepted


def test_build_engine_is_the_medusa_engine(stack):
    cfg, tb, _, _, tparams, tmp, tokens, lengths = stack
    eng = build_engine(cfg, "medusa", use_kernel=True, device="cpu")
    assert eng.tb.T == tb.T and eng.use_kernel
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_engine(cfg, "ngram", device="cpu")


def test_launcher_answers_every_request(capsys):
    srv = serve.main(["--reduced", "--device", "cpu", "--requests", "5",
                      "--slots", "2", "--max-new", "8", "--max-len", "128"])
    assert [r["status"] for r in srv.results] == ["done"] * 5
    assert all(len(r["output"]) == 8 for r in srv.results)
    assert srv.tokens == 40
    printed = capsys.readouterr().out
    assert printed.count(": done ") == 5 and "tok/s on CPU" in printed
    # the launcher's answer is the AR baseline's for the same prompt
    first = srv.prompts[0]
    ar, _ = ar_generate(srv.cfg, srv.params, torch.from_numpy(first[None]),
                        torch.tensor([len(first)], dtype=torch.int32),
                        srv.engine.init_cache(1, 128), 8, use_kernel=True)
    np.testing.assert_array_equal(ar[0].numpy(), srv.results[0]["output"])


def test_launcher_rejects_requests_that_do_not_fit():
    srv = serve.main(["--reduced", "--device", "cpu", "--requests", "2",
                      "--max-new", "8", "--max-len", "64"])
    assert [r["status"] for r in srv.results] == ["rejected"] * 2
    assert srv.tokens == 0
