"""The port's int8 KV-cache layout against the JAX reference on the CPU.

The same numpy inputs go through both packages:

* ``quant.quantize_rows``/``dequantize``: bitwise equal to the
  reference's, and idempotent on dequantized rows (commit re-quantizes
  the fake-quantized in-flight rows and must reproduce the cached bytes);
* ``flash_decode`` (K1) on an int8 cache: its plain version against the
  Pallas kernel's int8 branch in interpret mode over the reference kernel
  tests' shape sweep (``tests/test_kernels.py::CASES``), and
  ``ops.tree_attention`` against the reference wrapper and
  ``tree_attention_ref_int8`` on three of those shapes;
* the dense commit (K4): ``commit_rows_stacked`` and its plain version
  on CPU tensors, one cache as the unit view ``cache[None]``, against the
  interpret-mode Pallas ``commit_rows`` and ``commit_rows_stacked`` for
  starts in range, and against the reference's ``_update_rows`` for rows
  past the cache's end, which both ports drop (the interpret-mode Pallas
  write clamps its start there instead); the model's int8 commit
  (quantize, then one K4 write for the values and one for the scales)
  against the Pallas ``commit_rows_quantized``;
* one layer's prefill / decode / commit under int8, and the whole slice:
  torch spec == torch AR == the reference's ``SpecEngine(use_kernel=True)``
  token for token on reduced openPangu-7B with an int8 cache.

Tolerances are the reference kernel tests': 3e-5 for float32, 2e-2 for
bfloat16.  Integer and quantized outputs must match exactly."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.core import medusa as JM
from repro.core.engine import SpecEngine as JaxSpecEngine
from repro.core.tree import chain_tree, medusa_63
from repro.distributed.sharding import split_params
from repro.kernels import cache_update as JCU
from repro.kernels import ops as JO
from repro.kernels import quant as JQ
from repro.kernels import ref as JR
from repro.kernels.tree_attention import flash_decode as jax_flash_decode
from repro.models import transformer as JT
from repro.models.api import get_model as jax_get_model
from repro_torch import bridge
from repro_torch.configs.registry import get_config
from repro_torch.core.engine import SpecEngine, ar_generate
from repro_torch.kernels import cache_update as CU
from repro_torch.kernels import ops as TO
from repro_torch.kernels import quant as Q
from repro_torch.kernels import ref as TR
from repro_torch.kernels.tree_attention import flash_decode
from repro_torch.models import transformer as TT


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module's torch work: the suite runs in
    several workers on a few cores, and each worker's default pool
    oversubscribes them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# B, S, Hq, Hkv, D, tree, dtype — tests/test_kernels.py::CASES
CASES = [
    (2, 1024, 8, 2, 64, "medusa", "float32"),
    (1, 512, 4, 4, 128, "chain", "float32"),
    (3, 2048, 8, 1, 128, "medusa", "bfloat16"),
    (2, 640, 6, 2, 64, "chain", "float32"),
    (1, 256, 2, 2, 256, "chain", "bfloat16"),
    (2, 512, 16, 8, 64, "medusa", "float32"),
]
# the whole tree attention on three of them (a medusa tree with 4 query
# heads per kv head, bf16 with one kv head, and a chain whose fold pads T):
# the fold and the merge do not depend on the cache layout, and the cache
# sweep is held over every case above
TREE_CASES = [CASES[0], CASES[2], CASES[3]]
TOL = {"float32": 3e-5, "bfloat16": 2e-2}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
B, S_P, MAX_NEW, S_MAX = 2, 8, 16, 256


@pytest.fixture
def rng():
    """Each test's inputs from its own seed, whatever ran before it (the
    shared fixture is one generator for the whole session)."""
    return np.random.default_rng(0)


def _t(a):
    return torch.from_numpy(np.array(a))


def _quantized(rng, shape):
    """int8 rows and scales of numpy normals (quantized by the port, which
    is bitwise the reference's quantization)."""
    q, s = Q.quantize_rows(torch.from_numpy(rng.standard_normal(shape)))
    return q.numpy(), s.numpy()


def _stats_err(got, ref):
    """acc / l (what the merge consumes), m, and l relative."""
    acc, m, l = (x.float().numpy() for x in got)
    racc, rm, rl = (np.asarray(x, np.float32) for x in ref)
    return max(np.max(np.abs(acc / l - racc / rl)), np.max(np.abs(m - rm)),
               np.max(np.abs(l / rl - 1)))


# ------------------------------------------------------------------ quant

@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_quantize_rows_bitwise_and_idempotent(rng, dt):
    x = rng.standard_normal((3, 17, 4, 64)).astype(np.float32) * 3
    x[0, 0] = 0.0                                   # an all-zero row
    x[1, 2, 0, :4] = [0.5, -0.5, 1.5, 2.5]          # halves: round to even
    x[1, 2, 0, 4] = 127.0
    jq, js = JQ.quantize_rows(jnp.asarray(x, dt))
    q, s = Q.quantize_rows(torch.from_numpy(x).to(TDT[dt]))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    for out in (jnp.float32, jnp.bfloat16):
        tout = torch.float32 if out == jnp.float32 else torch.bfloat16
        np.testing.assert_array_equal(
            Q.dequantize(q, s, tout).float().numpy(),
            np.asarray(JQ.dequantize(jq, js, out), np.float32))
    q2, s2 = Q.quantize_rows(Q.dequantize(q, s))
    assert torch.equal(q2, q) and torch.equal(s2, s)
    assert (q[0, 0] == 0).all() and torch.isfinite(s).all()


def test_cache_bytes_per_token_matches_reference():
    for change in ({}, {"cache_dtype": "int8"}, {"dtype": "float32"}):
        cfg = dataclasses.replace(get_config("openpangu-7b"), **change)
        jcfg = dataclasses.replace(jax_get_config("openpangu-7b"), **change)
        assert cfg.kv_cache_bytes_per_token() == \
            jcfg.kv_cache_bytes_per_token()
        assert Q.is_quantized(cfg.resolved_cache_dtype) == \
            JQ.is_quantized(jcfg.resolved_cache_dtype)
    # int8 sweeps (D + 4) / (2 D) of the bf16 bytes
    cfg = get_config("openpangu-7b")
    assert cfg.kv_cache_bytes_per_token() == 34 * 2 * 8 * 128 * 2
    assert dataclasses.replace(cfg, cache_dtype="int8") \
        .kv_cache_bytes_per_token() == 34 * 2 * 8 * (128 + 4)


# ------------------------------------------------------------------- K1

@pytest.mark.parametrize("B,S,Hq,Hkv,D,tree,dt", CASES)
def test_plain_flash_decode_int8_matches_pallas(rng, B, S, Hq, Hkv, D, tree,
                                                dt):
    T, G = (medusa_63() if tree == "medusa" else chain_tree(4)).T, Hq // Hkv
    T_pad = T
    while (G * T_pad) % 8:
        T_pad += 1
    q = rng.standard_normal((B, Hkv, G * T_pad, D)).astype(np.float32)
    q /= np.sqrt(D)
    k, ks = _quantized(rng, (B, S, Hkv, D))
    v, vs = _quantized(rng, (B, S, Hkv, D))
    lengths = rng.integers(1, S + 1, size=(B,)).astype(np.int32)
    lengths[0] = 0 if B > 1 else lengths[0]         # an empty row
    k_, v_, ks_, vs_ = (jnp.asarray(np.ascontiguousarray(
        a.transpose(0, 2, 1, 3))) for a in (k, v, ks, vs))   # [B, Hkv, S, .]
    ref = jax_flash_decode(jnp.asarray(q, dt), k_, v_, jnp.asarray(lengths),
                           k_scale=ks_, v_scale=vs_, interpret=True)
    got = flash_decode(_t(q).to(TDT[dt]), _t(k), _t(v), _t(lengths),
                       k_scale=_t(ks), v_scale=_t(vs))
    acc, m, l = got
    live = lengths > 0
    assert _stats_err([x[live] for x in got],
                      [np.asarray(x)[live] for x in ref]) < TOL[dt]
    if not live.all():
        assert (acc[~live] == 0).all() and (l[~live] == 0).all()
        assert (m[~live] == -1e30).all()


@pytest.mark.parametrize("B,S,Hq,Hkv,D,tree,dt", TREE_CASES)
def test_tree_attention_int8_matches_reference(rng, B, S, Hq, Hkv, D, tree,
                                               dt):
    tb = medusa_63() if tree == "medusa" else chain_tree(4)
    q = rng.standard_normal((B, tb.T, Hq, D)).astype(np.float32)
    k, ks = _quantized(rng, (B, S, Hkv, D))
    v, vs = _quantized(rng, (B, S, Hkv, D))
    lengths = rng.integers(1, S - tb.T - 1, size=(B,)).astype(np.int32)
    scale = 1.0 / np.sqrt(D)
    jargs = (jnp.asarray(q, dt), jnp.asarray(k), jnp.asarray(v))
    jmask, jl = jnp.asarray(tb.mask), jnp.asarray(lengths)
    targs = (_t(q).to(TDT[dt]), _t(k), _t(v))
    tmask, tl = torch.from_numpy(tb.mask), _t(lengths)
    out = TO.tree_attention(*targs, tmask, tl, scale, k_scale=_t(ks),
                            v_scale=_t(vs))
    ref_kernel = JO.tree_attention(*jargs, jmask, jl, scale,
                                   k_scale=jnp.asarray(ks),
                                   v_scale=jnp.asarray(vs), interpret=True)
    ref_oracle = JR.tree_attention_ref_int8(*jargs, jnp.asarray(ks),
                                            jnp.asarray(vs), jmask, jl, scale)
    oracle = TR.tree_attention_ref_int8(*targs, _t(ks), _t(vs), tmask, tl,
                                        scale)
    for got, ref in ((out, ref_kernel), (out, ref_oracle),
                     (oracle, ref_oracle)):
        assert float(np.max(np.abs(got.float().numpy()
                                   - np.asarray(ref, np.float32)))) < TOL[dt]


# ------------------------------------------------------------------- K4

def _commit_inputs(rng, dtype, nu=None, S=64, lengths=(0, 20, 59)):
    """Integer values in [-100, 100]: exact in f32, bf16 and int8, so every
    cast is exact in both frameworks."""
    lead = () if nu is None else (nu,)
    Bc, K1, H, D = len(lengths), 5, 2, 16
    cache = rng.integers(-100, 101, lead + (Bc, S, H, D))
    rows = rng.integers(-100, 101, lead + (Bc, K1, H, D))
    return (cache.astype(dtype), rows.astype(np.float32),
            np.asarray(lengths, np.int32))


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16, np.int8])
def test_commit_rows_matches_pallas_in_range(rng, dtype):
    tdt = {np.float32: torch.float32, jnp.bfloat16: torch.bfloat16,
           np.int8: torch.int8}[dtype]
    cache, rows, lengths = _commit_inputs(rng, np.float32)
    jcache = jnp.asarray(cache).astype(dtype)
    ref = JCU.commit_rows(jcache, jnp.asarray(rows), jnp.asarray(lengths),
                          interpret=True)
    got = CU.commit_rows_stacked(torch.from_numpy(cache).to(tdt)[None],
                                 _t(rows)[None], _t(lengths))[0]
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(ref, np.float32))
    # stacked: the units axis folded into the slots
    cache, rows, lengths = _commit_inputs(rng, np.float32, nu=3)
    jcache = jnp.asarray(cache).astype(dtype)
    ref = JCU.commit_rows_stacked(jcache, jnp.asarray(rows),
                                  jnp.asarray(lengths), interpret=True)
    for fn in (CU.commit_rows_stacked, CU.commit_rows_stacked_plain):
        got = fn(torch.from_numpy(cache).to(tdt), _t(rows), _t(lengths))
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(ref, np.float32))


def test_commit_rows_quantized_matches_pallas(rng):
    """The model's int8 commit of one unit, with the best path the first
    K1 in-flight rows, writes what the Pallas ``commit_rows_quantized``
    writes: the same values and the same scales."""
    cache, rows, lengths = _commit_inputs(rng, np.float32)
    c8 = cache.astype(np.int8)
    sc = np.abs(cache[..., :1]) / 127
    ref_c, ref_s = JCU.commit_rows_quantized(
        jnp.asarray(c8), jnp.asarray(sc), jnp.asarray(rows),
        jnp.asarray(lengths), interpret=True)
    B, K1 = rows.shape[:2]
    entry = {"k": _t(c8)[None], "k_scale": _t(sc)[None],
             "v": _t(c8)[None].clone(), "v_scale": _t(sc)[None].clone(),
             "k_new": _t(rows)[None], "v_new": _t(rows)[None]}
    path = torch.arange(K1)[None].expand(B, K1)
    got = TT._commit_attn_entry(entry, _t(lengths), path)
    for name in ("k", "v"):
        np.testing.assert_array_equal(got[name][0].numpy(),
                                      np.asarray(ref_c))
        np.testing.assert_array_equal(got[name + "_scale"][0].numpy(),
                                      np.asarray(ref_s))


def test_commit_rows_drops_rows_past_the_end(rng):
    """Starts whose K1 rows overrun S: the port drops the overrun, as the
    reference's ``_update_rows`` does (the Pallas write clamps instead)."""
    cache, rows, lengths = _commit_inputs(rng, np.float32,
                                          lengths=(62, 0, 64))
    ref = JT._update_rows(jnp.asarray(cache), jnp.asarray(rows),
                          jnp.asarray(lengths))
    got = CU.commit_rows_stacked(_t(cache)[None], _t(rows)[None],
                                 _t(lengths))[0]
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert torch.equal(got[2], _t(cache)[2])        # all five dropped
    cache, rows, lengths = _commit_inputs(rng, np.float32, nu=2,
                                          lengths=(61, 3, 70))
    ref = jax.vmap(JT._update_rows, in_axes=(0, 0, None))(
        jnp.asarray(cache), jnp.asarray(rows), jnp.asarray(lengths))
    got = CU.commit_rows_stacked(_t(cache), _t(rows), _t(lengths))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# ------------------------------------------------------ layer and engine

@pytest.fixture(scope="module")
def stack():
    cfg = dataclasses.replace(jax_get_config("openpangu-7b", reduced=True),
                              cache_dtype="int8")
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


def _close_cache(t_entry, j_entry, atol=3e-5):
    """int8 values equal, scales (and fp leaves) within ``atol``; decode's
    in-flight rows (a tuple, one tensor per unit) stacked."""
    for name, j in j_entry.items():
        t = t_entry[name]
        if isinstance(t, tuple):
            t = torch.stack(t)
        if t.dtype == torch.int8:
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        else:
            np.testing.assert_allclose(t.float().numpy(),
                                       np.asarray(j, np.float32), atol=atol,
                                       rtol=1e-5)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_prefill_decode_commit_int8_match_reference(stack, use_kernel):
    cfg, tb, params, _, tparams, _, tokens, lengths = stack
    cfg = dataclasses.replace(cfg, num_layers=1)
    params = dict(params, units=jax.tree.map(lambda x: x[:1],
                                             params["units"]))
    tparams = dict(tparams, units=jax.tree.map(lambda x: x[:1],
                                               tparams["units"]))
    jm = jax_get_model(cfg)
    jcache = jm.init_cache(cfg, B, S_MAX)
    tcache = TT.init_cache(cfg, B, S_MAX, device="cpu")
    jlast, jcache = jm.prefill(params, cfg, jnp.asarray(tokens),
                               jnp.asarray(lengths), jcache)
    tlast, tcache = TT.prefill(tparams, cfg, _t(tokens), _t(lengths), tcache)
    np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), atol=3e-5,
                               rtol=1e-5)
    _close_cache(tcache["pos0"], jcache["pos0"])

    cand = np.random.default_rng(3).integers(0, cfg.vocab_size,
                                             size=(B, tb.T)).astype(np.int32)
    jh, jspec = jm.decode(params, cfg, jcache, jnp.asarray(cand),
                          jnp.asarray(lengths), jnp.asarray(tb.mask),
                          jnp.asarray(tb.depths), use_kernel=use_kernel)
    th, tspec = TT.decode(tparams, cfg, tcache, _t(cand), _t(lengths),
                          torch.from_numpy(tb.mask),
                          torch.from_numpy(tb.depths), use_kernel=use_kernel)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=3e-5,
                               rtol=1e-5)
    _close_cache(tspec["pos0"], jspec["pos0"])

    path = np.stack([tb.retrieve[3], tb.retrieve[0]]).astype(np.int32)
    acc = np.array([2, 4], np.int32)
    jc, jlen = jm.commit(cfg, jspec, jnp.asarray(lengths), jnp.asarray(path),
                         jnp.asarray(acc))
    tc, tlen = TT.commit(cfg, tspec, _t(lengths), _t(path), _t(acc))
    np.testing.assert_array_equal(tlen.numpy(), np.asarray(jlen))
    assert set(tc["pos0"]) == {"k", "v", "k_scale", "v_scale"}
    _close_cache(tc["pos0"], jc["pos0"])


@pytest.fixture(scope="module")
def jax_int8(stack):
    cfg, tb, params, mp, _, _, tokens, lengths = stack
    out, n_out, st = JaxSpecEngine(cfg, tb, use_kernel=True).generate(
        params, mp, jnp.asarray(tokens), jnp.asarray(lengths),
        jax_get_model(cfg).init_cache(cfg, B, S_MAX), MAX_NEW)
    return np.asarray(out), np.asarray(n_out), int(st.steps)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_int8_spec_equals_ar_equals_reference(stack, jax_int8, use_kernel):
    cfg, tb, _, _, tparams, tmp, tokens, lengths = stack
    eng = SpecEngine(cfg, tb, use_kernel=use_kernel, device="cpu")
    cache = eng.init_cache(B, S_MAX)
    assert cache["pos0"]["k"].dtype == torch.int8
    tok, plen = _t(tokens), _t(lengths)
    out, n_out, st = eng.generate(tparams, tmp, tok, plen, cache, MAX_NEW)
    ar, _ = ar_generate(cfg, tparams, tok, plen, eng.init_cache(B, S_MAX),
                        MAX_NEW, use_kernel=use_kernel)
    jout, jn, jsteps = jax_int8
    np.testing.assert_array_equal(out.numpy(), ar.numpy())
    np.testing.assert_array_equal(out.numpy(), jout)
    np.testing.assert_array_equal(n_out.numpy(), jn)
    assert st.steps == jsteps < MAX_NEW


def test_int8_verify_fusion_keeps_the_unfused_write_side(stack, monkeypatch):
    """Under int8 the fused write side (K3, fp only) is not taken, as in
    the reference; verification still goes through the statistics, and
    the tokens are the unfused engine's."""
    cfg, tb, _, _, tparams, tmp, tokens, lengths = stack
    tok, plen = _t(tokens), _t(lengths)
    plain = SpecEngine(cfg, tb, use_kernel=True, device="cpu")
    want = plain.generate(tparams, tmp, tok, plen, plain.init_cache(B, S_MAX),
                          MAX_NEW)[0]

    def fused(*args, **kwargs):
        raise AssertionError("K3 called on an int8 cache")

    monkeypatch.setattr(TT, "fused_qkv_rope_commit", fused)
    eng = SpecEngine(cfg, tb, use_kernel=True, device="cpu",
                     verify_fusion=True)
    got = eng.generate(tparams, tmp, tok, plen, eng.init_cache(B, S_MAX),
                       MAX_NEW)[0]
    np.testing.assert_array_equal(got.numpy(), want.numpy())
