"""The port's verify-fusion path against the JAX reference on the CPU.

The two kernels of the path take their plain PyTorch versions on CPU
tensors, and are held against the Pallas kernels run in interpret mode
(and the reference's oracle), with the same numpy inputs:

* ``unembed_verify_stats`` (K2): one vocabulary block and several, a
  vocabulary that is not a multiple of the block, tied lm-head columns in
  different blocks (argmax exact: the first index wins), tmax != 1;
* ``fused_qkv_rope_commit`` (K3, dense): with and without biases, at the
  spec step's T 64 and the AR step's T 1, in f32 and bf16, on in-range
  rows; and a case with rows past the cache's end, which the port drops
  as its own and the reference's ``_update_rows`` do (the Pallas kernel's
  interpret-mode write clamps its start instead, and is not the oracle
  there).

Tolerances are the reference kernel tests': 3e-5 for float32, 2e-2 for
bfloat16 (bf16 products round at other places in the two frameworks);
``l`` is held relative.  Greedy verification from the statistics must
give a Verdict bit-identical to ``greedy_verify``'s and to the
reference's, and on reduced openPangu-7B the fused engine must give the
same tokens as the unfused engine, AR, and the reference's fused engine.
The CUDA kernels run only on the card: ``test_cuda_kernels_match_plain``
skips without one, and ``chip_smoke.py`` holds them at full width."""
import dataclasses

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
from repro.kernels import cache_update as JCU
from repro.kernels import ops as JO
from repro.kernels import ref as JR
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.models.api import get_model as jax_get_model
from repro_torch import bridge
from repro_torch.core import verify as V
from repro_torch.core.engine import SpecEngine, ar_generate
from repro_torch.kernels import ref as TR
from repro_torch.kernels.cache_update import (fused_qkv_rope_commit,
                                              fused_qkv_rope_commit_plain)
from repro_torch.kernels.tree_attention import (unembed_verify_stats,
                                                unembed_verify_stats_plain)
from repro_torch.launch import serve
from repro_torch.models import transformer as TT

TOL = {"float32": 3e-5, "bfloat16": 2e-2}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
B, S_P, MAX_NEW, S_MAX = 2, 8, 16, 256


@pytest.fixture
def rng():
    """Each test's inputs from its own seed, whatever ran before it (the
    shared fixture is one generator for the whole session)."""
    return np.random.default_rng(0)


def _np(t):
    return t.float().numpy()


def _stats_close(got, ref, dt, exact_argm=True):
    argm, m, l, cw = got
    rargm, rm, rl, rcw = (np.asarray(x, np.float32) for x in ref)
    tol = TOL[dt]
    if exact_argm:
        np.testing.assert_array_equal(argm.numpy(), rargm)
    np.testing.assert_allclose(_np(m), rm, atol=tol, rtol=0)
    np.testing.assert_allclose(_np(l) / rl, np.ones_like(rl), atol=tol,
                               rtol=0)
    np.testing.assert_allclose(_np(cw), rcw, atol=tol, rtol=0)


# --------------------------------------------------------------------- K2

# name, B, T, d, V, block_v (None: one block), tmax, dtype
STATS_CASES = [
    ("one block", 3, 6, 16, 256, None, "ones", "float32"),
    ("several blocks", 2, 4, 8, 512, 128, "ones", "float32"),
    ("V not a multiple of the block", 2, 5, 16, 300, 128, "ones", "float32"),
    ("tmax != 1", 3, 6, 16, 384, 128, "mixed", "float32"),
    ("bf16 several blocks", 2, 8, 32, 640, 128, "ones", "bfloat16"),
]


@pytest.mark.parametrize("name,Bs,T,d,Vc,block_v,tm,dt", STATS_CASES,
                         ids=[c[0] for c in STATS_CASES])
def test_plain_stats_match_pallas_and_oracle(rng, name, Bs, T, d, Vc,
                                             block_v, tm, dt):
    hidden = rng.standard_normal((Bs, T, d)).astype(np.float32)
    w = (rng.standard_normal((d, Vc)) * 0.3).astype(np.float32)
    cand = rng.integers(0, Vc, (Bs, T)).astype(np.int32)
    cand[:, -1] = Vc - 1                        # a candidate in the last block
    tmax = (np.ones((Bs,)) if tm == "ones"
            else np.resize([1.0, 0.7, 1e-6], Bs)).astype(np.float32)
    jh, jw = jnp.asarray(hidden, dt), jnp.asarray(w, dt)
    jc, jt = jnp.asarray(cand), jnp.asarray(tmax)
    pallas = JO.verify_stats(jh, jw, jc, jt, block_v=block_v, interpret=True)
    oracle = JR.verify_stats_ref(jh, jw, jc, jt)
    th = torch.from_numpy(hidden).to(TDT[dt])
    tw = torch.from_numpy(w).to(TDT[dt])
    tc, tt = torch.from_numpy(cand), torch.from_numpy(tmax)
    kw = {} if block_v is None else {"block_v": block_v}
    got = unembed_verify_stats_plain(th, tw, tc, tt, **kw)
    exact = dt == "float32"
    _stats_close(got, pallas, dt, exact)
    _stats_close(got, oracle, dt, exact)
    _stats_close(TR.verify_stats_ref(th, tw, tc, tt), oracle, dt, exact)
    # the wrapper takes the plain version on the CPU
    for a, b in zip(unembed_verify_stats(th, tw, tc, tt),
                    unembed_verify_stats_plain(th, tw, tc, tt)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    if not exact:
        # bf16: where the argmax differs, the oracle's logit at the port's
        # argmax lies within the tolerance of the oracle's max
        rows = np.asarray(oracle[1])
        wv = np.asarray(jnp.einsum("btd,dv->btv", jh, jw).astype(jnp.float32))
        wv = wv / tmax[:, None, None]
        at = np.take_along_axis(wv, got[0].numpy()[..., None].astype(int),
                                axis=-1)[..., 0]
        assert np.max(rows - at) < TOL[dt]


def test_tied_columns_first_wins(rng):
    """Equal lm-head columns in different vocabulary blocks tie exactly;
    the lowest index must win in every row, as in torch/jnp argmax."""
    Bs, T, d, Vc = 2, 5, 16, 700
    hidden = rng.standard_normal((Bs, T, d)).astype(np.float32)
    hidden[..., 0] = 8.0
    w = (rng.standard_normal((d, Vc)) * 0.1).astype(np.float32)
    tied = [131, 390, 650]                       # three different blocks
    w[:, tied] = 0.0
    w[0, tied] = 4.0                             # logit 32: every row's max
    cand = rng.integers(0, Vc, (Bs, T)).astype(np.int32)
    cand[:, :3] = tied
    tmax = np.ones((Bs,), np.float32)
    args = [torch.from_numpy(a) for a in (hidden, w, cand, tmax)]
    got = unembed_verify_stats_plain(*args, block_v=128)
    assert (got[0] == tied[0]).all()
    jargs = [jnp.asarray(a) for a in (hidden, w, cand, tmax)]
    _stats_close(got, JO.verify_stats(*jargs, block_v=128, interpret=True),
                 "float32")
    _stats_close(got, JR.verify_stats_ref(*jargs), "float32")
    np.testing.assert_array_equal(got[3][:, :, 0].numpy(),
                                  got[3][:, :, 1].numpy())


def test_greedy_verify_stats_is_bit_identical(rng):
    tb = medusa_63()
    Bv, Vc = 6, 50
    logits = rng.standard_normal((Bv, tb.T, Vc)).astype(np.float32)
    argm = logits.argmax(-1)
    # candidates follow the argmax of their parent, corrupted at random, so
    # accepted paths of every length occur
    cand = argm[:, np.maximum(tb.parent, 0)].astype(np.int32)
    cand[:, 0] = rng.integers(0, Vc, size=Bv)
    flip = rng.random(cand.shape) < 0.3
    cand[flip] = rng.integers(0, Vc, size=int(flip.sum()))
    tl, tc = torch.from_numpy(logits), torch.from_numpy(cand)
    ones = torch.ones((Bv,))
    stats = V.VerifyStats(*TR.verify_stats_ref(tl, torch.eye(Vc), tc, ones))
    dt = V.device_tree(tb, "cpu")
    fused = V.greedy_verify_stats(tc, stats, dt)
    unfused = V.greedy_verify(tc, tl, dt)
    jstats = JV.VerifyStats(*JR.verify_stats_ref(
        jnp.asarray(logits), jnp.eye(Vc), jnp.asarray(cand), jnp.ones((Bv,))))
    ref = JV.greedy_verify_stats(jnp.asarray(cand), jstats, JV.device_tree(tb))
    for f, u, r in zip(fused, unfused, ref):
        assert f.dtype == u.dtype
        np.testing.assert_array_equal(f.numpy(), u.numpy())
        np.testing.assert_array_equal(f.numpy(), np.asarray(r))
    assert len(set(np.asarray(ref.acc).tolist())) > 1


# --------------------------------------------------------------------- K3

def _qkv_inputs(rng, T, dt, bias, S=128, lengths=(5, 40),
                dims=(64, 4, 2, 16)):
    Bs = 2
    d, Hq, Hkv, hd = dims
    p = {"wq": rng.standard_normal((d, Hq, hd)) / 8,
         "wk": rng.standard_normal((d, Hkv, hd)) / 8,
         "wv": rng.standard_normal((d, Hkv, hd)) / 8}
    if bias:
        p |= {"bq": rng.standard_normal((Hq, hd)),
              "bk": rng.standard_normal((Hkv, hd)),
              "bv": rng.standard_normal((Hkv, hd))}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.standard_normal((Bs, T, d)).astype(np.float32)
    kc = rng.standard_normal((Bs, S, Hkv, hd)).astype(np.float32)
    vc = rng.standard_normal((Bs, S, Hkv, hd)).astype(np.float32)
    lengths = np.asarray(lengths, np.int32)
    depths = np.arange(T, dtype=np.int32)
    cos, sin = JL.rope_cos_sin(jnp.asarray(lengths[:, None] + depths[None]),
                               hd, 10000.0)
    cos, sin = np.array(cos), np.array(sin)

    def jx(a):
        return jnp.asarray(a, dt)

    def tx(a):
        return torch.from_numpy(np.array(a)).to(TDT[dt])

    jin = (jx(x), {k: jx(v) for k, v in p.items()}, jnp.asarray(lengths),
           jx(kc), jx(vc), jnp.asarray(cos), jnp.asarray(sin))
    tin = (tx(x), {k: tx(v) for k, v in p.items()}, torch.from_numpy(lengths),
           tx(kc), tx(vc), torch.from_numpy(cos), torch.from_numpy(sin))
    return jin, tin


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", [64, 1])
@pytest.mark.parametrize("bias", [False, True])
def test_plain_fused_qkv_matches_pallas(rng, bias, T, dt):
    (jx, jp, jl, jk, jv, jcos, jsin), (x, p, lengths, kc, vc, cos, sin) = \
        _qkv_inputs(rng, T, dt, bias)
    k0, v0 = kc.clone(), vc.clone()
    ref = JCU.fused_qkv_rope_commit(jx, jp, jl, jk, jv, cos=jcos, sin=jsin,
                                    interpret=True)
    got = fused_qkv_rope_commit_plain(x, p, lengths, kc, vc, cos=cos,
                                      sin=sin)
    for g, r in zip((*got, kc, vc), ref):
        np.testing.assert_allclose(_np(g), np.asarray(r, np.float32),
                                   atol=TOL[dt], rtol=0)
    # outside the written rows the caches are unchanged, bit for bit
    for b, n in enumerate(lengths.tolist()):
        for new, old in ((kc, k0), (vc, v0)):
            assert torch.equal(new[b, :n], old[b, :n])
            assert torch.equal(new[b, n + T:], old[b, n + T:])
    # the wrapper takes the plain version on the CPU
    kc2, vc2 = k0.clone(), v0.clone()
    got2 = fused_qkv_rope_commit(x, p, lengths, kc2, vc2, cos=cos, sin=sin)
    for a, b in zip((*got, kc, vc), (*got2, kc2, vc2)):
        assert torch.equal(a, b)


def test_fused_qkv_drops_rows_past_the_end(rng):
    """lengths[b] + T > S: the rows past S are dropped, as the port's and
    the reference's ``_update_rows`` drop them."""
    T, S = 4, 16
    (jx, jp, jl, jk, jv, jcos, jsin), (x, p, lengths, kc, vc, cos, sin) = \
        _qkv_inputs(rng, T, "float32", False, S=S, lengths=(14, 3))
    k0, v0 = kc.clone(), vc.clone()
    q, k, v = fused_qkv_rope_commit_plain(x, p, lengths, kc, vc, cos=cos,
                                          sin=sin)
    jq, jkr, jvr, _, _ = JCU.fused_qkv_rope_commit(
        jx, jp, jl, jk, jv, cos=jcos, sin=jsin, interpret=True)
    for g, r in ((q, jq), (k, jkr), (v, jvr)):
        np.testing.assert_allclose(_np(g), np.asarray(r), atol=3e-5, rtol=0)
    for got, old, rows, jold in ((kc, k0, k, jk), (vc, v0, v, jv)):
        mine = old.clone()
        TT._update_rows(mine, rows, lengths)
        assert torch.equal(got, mine)
        ref = JT._update_rows(jold, jnp.asarray(rows.numpy()), jl)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        assert torch.equal(got[0, :14], old[0, :14])       # 2 rows kept
        assert not torch.equal(got[0, 14:], old[0, 14:])


# ----------------------------------------------------------- whole slice

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
def jax_fused(stack):
    cfg, tb, params, mp, _, _, tokens, lengths = stack
    out, n_out, st = JaxSpecEngine(cfg, tb, use_kernel=True,
                                   verify_fusion=True).generate(
        params, mp, jnp.asarray(tokens), jnp.asarray(lengths),
        jax_get_model(cfg).init_cache(cfg, B, S_MAX), MAX_NEW)
    return np.asarray(out), np.asarray(n_out), int(st.steps)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_fused_spec_equals_unfused_ar_and_reference(stack, jax_fused,
                                                    use_kernel):
    """use_kernel=True: K2 and K3 (plain versions here); False: K2 only."""
    cfg, tb, _, _, tparams, tmp, tokens, lengths = stack
    tok, plen = torch.from_numpy(tokens), torch.from_numpy(lengths)
    outs = {}
    for vf in (True, False):
        eng = SpecEngine(cfg, tb, use_kernel=use_kernel, device="cpu",
                         verify_fusion=vf)
        assert eng.cfg.verify_fusion == vf and cfg.verify_fusion is False
        outs[vf] = eng.generate(tparams, tmp, tok, plen,
                                eng.init_cache(B, S_MAX), MAX_NEW)
    fcfg = dataclasses.replace(cfg, verify_fusion=True)
    ar, _ = ar_generate(fcfg, tparams, tok, plen,
                        TT.init_cache(fcfg, B, S_MAX, device="cpu"), MAX_NEW,
                        use_kernel=use_kernel)
    out, n_out, st = outs[True]
    jout, jn, jsteps = jax_fused
    np.testing.assert_array_equal(out.numpy(), outs[False][0].numpy())
    np.testing.assert_array_equal(out.numpy(), ar.numpy())
    np.testing.assert_array_equal(out.numpy(), jout)
    np.testing.assert_array_equal(n_out.numpy(), jn)
    assert st.steps == jsteps == outs[False][2].steps < MAX_NEW


def test_launcher_verify_fusion_answers_every_request(capsys):
    argv = ["--reduced", "--device", "cpu", "--requests", "5", "--slots",
            "2", "--max-new", "8", "--max-len", "128"]
    fused = serve.main(argv + ["--verify-fusion"])
    assert fused.cfg.verify_fusion and fused.engine.cfg.verify_fusion
    assert [r["status"] for r in fused.results] == ["done"] * 5
    assert "with verify fusion" in capsys.readouterr().out
    # the same weights served without fusion give the same answers
    plain = serve.main(argv, weights=(fused.params, fused.medusa_params))
    assert not plain.cfg.verify_fusion
    for a, b in zip(fused.results, plain.results):
        np.testing.assert_array_equal(a["output"], b["output"])
        assert len(a["output"]) == 8


@pytest.mark.cuda
def test_cuda_kernels_match_plain(rng):
    """K2 and K3 against their plain versions on the card, f32 (needs a
    GPU and nvcc; skipped without them)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    dev = "cuda"
    h = torch.from_numpy(rng.standard_normal((2, 64, 256))).float().to(dev)
    w = torch.from_numpy(rng.standard_normal((256, 1000)) / 16).float().to(dev)
    cand = torch.from_numpy(rng.integers(0, 1000, (2, 64))).int().to(dev)
    tmax = torch.ones((2,), device=dev)
    before = unembed_verify_stats.launches
    got = unembed_verify_stats(h, w, cand, tmax)
    assert unembed_verify_stats.launches == before + 1
    _stats_close([x.cpu() for x in got],
                 [x.cpu().numpy() for x in
                  unembed_verify_stats_plain(h, w, cand, tmax)], "float32")
    _, tin = _qkv_inputs(rng, 64, "float32", True, dims=(256, 4, 2, 64))
    x, p, lengths, kc, vc, cos, sin = (
        {k: v.to(dev) for k, v in t.items()} if isinstance(t, dict)
        else t.to(dev) for t in tin)
    kc2, vc2 = kc.clone(), vc.clone()
    before = fused_qkv_rope_commit.launches
    got = fused_qkv_rope_commit(x, p, lengths, kc, vc, cos=cos, sin=sin)
    assert fused_qkv_rope_commit.launches == before + 1
    ref = fused_qkv_rope_commit_plain(x, p, lengths, kc2, vc2, cos=cos,
                                      sin=sin)
    for g, r in zip((*got, kc, vc), (*ref, kc2, vc2)):
        assert (g - r).abs().max().item() < 3e-5
