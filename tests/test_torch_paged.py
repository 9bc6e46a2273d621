"""The port's paged KV-cache layout (and int8 + paged) against the JAX
reference on the CPU.

The same numpy inputs go through both packages:

* every helper of ``kernels/paging.py``, including rows past the table,
  which land in trash block 0;
* ``init_cache`` leaves, shapes and dtypes for int8, paged, int8 + paged,
  and an explicit ``n_blocks`` (zero tables);
* ``flash_decode`` (K1) on a pool read through a shuffled, non-identity
  block table: its plain version against the Pallas paged kernel in
  interpret mode over ``tests/test_kernels.py::CASES`` with page sizes 8,
  16 and 64, fp and int8, with an idle slot (zero table, length 0) where
  there are two slots or more; ``ops.tree_attention`` against the
  reference wrapper and ``tree_attention_ref_paged`` on three of those
  shapes;
* ``fused_qkv_rope_commit`` (K3) with ``table=`` and the paged commit
  (K5: ``commit_rows_paged_stacked``, one pool as the unit view
  ``pool[None]``, and the model's int8 paged commit) against the
  interpret-mode Pallas ``commit_rows_paged`` and
  ``commit_rows_paged_quantized``, rows past the table included.  Several dead rows may land on
  one trash row in one write, in an order neither framework fixes, so
  pools are compared everywhere except block 0;
* one layer's prefill / decode / commit under paged and int8 + paged, and
  the whole slice: torch spec == torch AR == the reference's
  ``SpecEngine(use_kernel=True)`` for {paged} x {fp, int8}, paged ==
  dense token for token, paged fused == dense fused, and the launcher on
  the int8 paged cache.

Tolerances are the reference kernel tests': 3e-5 for float32, 2e-2 for
bfloat16.  The CUDA kernels run only on the card: ``test_torch_cuda.py``
(which imports no JAX, so it runs there) and ``chip_smoke.py`` hold them
to their plain versions."""
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
from repro.kernels import paging as JP
from repro.kernels import quant as JQ
from repro.kernels import ref as JR
from repro.kernels.tree_attention import flash_decode as jax_flash_decode
from repro.models import layers as JL
from repro.models.api import get_model as jax_get_model
from repro.models.transformer import cache_max_len as jax_cache_max_len
from repro_torch import bridge
from repro_torch.core.engine import SpecEngine, ar_generate
from repro_torch.kernels import cache_update as CU
from repro_torch.kernels import ops as TO
from repro_torch.kernels import paging as P
from repro_torch.kernels import quant as Q
from repro_torch.kernels import ref as TR
from repro_torch.kernels.tree_attention import flash_decode
from repro_torch.launch import serve
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
B, S_P, MAX_NEW, S_MAX, PS = 2, 8, 16, 256, 16


@pytest.fixture
def rng():
    """Each test's inputs from its own seed, whatever ran before it (the
    shared fixture is one generator for the whole session)."""
    return np.random.default_rng(0)


def _t(a):
    return torch.from_numpy(np.array(a))


def _shuffled_table(rng, Bt, mb):
    """[Bt, mb] int32: a random permutation of blocks 1 .. Bt*mb."""
    return (1 + rng.permutation(Bt * mb)).reshape(Bt, mb).astype(np.int32)


def _to_pool(rng, dense, table, ps):
    """Pool [1 + Bt*mb, ps, ...] holding ``dense`` [Bt, mb*ps, ...] through
    ``table``; block 0 holds garbage."""
    Bt, mb = table.shape
    pool = rng.standard_normal((1 + Bt * mb, ps) + dense.shape[2:])
    pool = pool.astype(dense.dtype)
    for b in range(Bt):
        for j in range(mb):
            pool[table[b, j]] = dense[b, j * ps:(j + 1) * ps]
    return pool


def _except_trash(a):
    return np.asarray(a, np.float32)[P.TRASH_BLOCK + 1:]


# ----------------------------------------------------------------- paging

def test_identity_table_and_blocks_for():
    for n, ps in ((0, 16), (1, 16), (16, 16), (17, 16), (2048, 64)):
        assert P.blocks_for(n, ps) == JP.blocks_for(n, ps)
    np.testing.assert_array_equal(P.identity_table(3, 5).numpy(),
                                  np.asarray(JP.identity_table(3, 5)))
    assert P.identity_table(3, 5).dtype == torch.int32


def test_phys_rows_and_gather_match_reference(rng):
    table = _shuffled_table(rng, 3, 4)
    starts = np.array([0, 2 * PS - 2, 4 * PS - 1], np.int32)  # straddle, past
    got = P.phys_rows(_t(table), _t(starts), 5, PS)
    ref = JP.phys_rows(jnp.asarray(table), jnp.asarray(starts), 5, PS)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert (got[2, 1:] // PS == P.TRASH_BLOCK).all()
    pool = rng.standard_normal((13, PS, 2, 8)).astype(np.float32)
    np.testing.assert_array_equal(
        P.gather_cache(_t(pool), _t(table)).numpy(),
        np.asarray(JP.gather_cache(jnp.asarray(pool), jnp.asarray(table))))


@pytest.mark.parametrize("stacked", [False, True])
def test_scatter_rows_match_reference(rng, stacked):
    table = _shuffled_table(rng, 3, 4)
    lead = (2,) if stacked else ()
    pool = rng.standard_normal(lead + (13, PS, 2, 8)).astype(np.float32)
    rows = rng.standard_normal(lead + (3, 5, 2, 8)).astype(np.float32)
    starts = np.array([3, 4 * PS - 2, 4 * PS + 6], np.int32)
    fn, jfn = ((P.scatter_rows_stacked, JP.scatter_rows_stacked) if stacked
               else (P.scatter_rows, JP.scatter_rows))
    got = _t(pool)
    out = fn(got, _t(table), _t(rows), _t(starts), PS)
    assert out is got                                  # in place
    ref = jfn(jnp.asarray(pool), jnp.asarray(table), jnp.asarray(rows),
              jnp.asarray(starts), PS)
    cut = (slice(None),) * len(lead) + (slice(1, None),)
    np.testing.assert_array_equal(got.numpy()[cut], np.asarray(ref)[cut])
    # slot 2's rows all lie past its table: its blocks are unchanged
    for blk in table[2]:
        np.testing.assert_array_equal(got.numpy()[..., blk, :, :, :],
                                      pool[..., blk, :, :, :])


@pytest.mark.parametrize("dtype,layout,n_blocks", [
    ("int8", "dense", None), ("", "paged", None), ("int8", "paged", None),
    ("int8", "paged", 7), ("", "paged", 9)])
def test_init_cache_matches_reference(dtype, layout, n_blocks):
    jcfg = dataclasses.replace(jax_get_config("openpangu-7b", reduced=True),
                               cache_dtype=dtype, cache_layout=layout,
                               page_size=PS)
    jcache = jax_get_model(jcfg).init_cache(jcfg, 3, 100, n_blocks=n_blocks)
    tcache = TT.init_cache(jcfg, 3, 100, device="cpu", n_blocks=n_blocks)
    flat = {f"{p}/{n}": a for p, e in jcache.items() for n, a in e.items()}
    tflat = {f"{p}/{n}": a for p, e in tcache.items() for n, a in e.items()}
    assert set(tflat) == set(flat)
    for name, j in flat.items():
        t = tflat[name]
        assert tuple(t.shape) == j.shape and str(t.dtype)[6:] == str(j.dtype)
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert TT.cache_max_len(tcache) == jax_cache_max_len(jcache)


# ------------------------------------------------------------------- K1

@pytest.mark.parametrize("ps", [8, 16, 64])
@pytest.mark.parametrize("B,S,Hq,Hkv,D,tree,dt", CASES)
def test_plain_flash_decode_paged_matches_pallas(rng, B, S, Hq, Hkv, D, tree,
                                                 dt, ps):
    T, G = (medusa_63() if tree == "medusa" else chain_tree(4)).T, Hq // Hkv
    T_pad = T
    while (G * T_pad) % 8:
        T_pad += 1
    q = rng.standard_normal((B, Hkv, G * T_pad, D)).astype(np.float32)
    q /= np.sqrt(D)
    table = _shuffled_table(rng, B, S // ps)
    lengths = rng.integers(1, S + 1, size=(B,)).astype(np.int32)
    if B > 1:                        # an idle slot: zero table, length 0
        table[0], lengths[0] = 0, 0
    live = lengths > 0
    kd = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    vd = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    k, v = _to_pool(rng, kd, table, ps), _to_pool(rng, vd, table, ps)
    jq, jl, jt = jnp.asarray(q, dt), jnp.asarray(lengths), jnp.asarray(table)
    tq, tl, tt = _t(q).to(TDT[dt]), _t(lengths), _t(table)

    def check(got, ref):
        acc, m, l = got
        racc, rm, rl = (np.asarray(x, np.float32)[live] for x in ref)
        acc, m, l = (x.float().numpy()[live] for x in got)
        err = max(np.max(np.abs(acc / l - racc / rl)),
                  np.max(np.abs(m - rm)), np.max(np.abs(l / rl - 1)))
        assert err < TOL[dt]
        if not live.all():
            assert (got[0][~live] == 0).all() and (got[2][~live] == 0).all()
            assert (got[1][~live] == -1e30).all()

    def jpool(t, dtype=None):
        # the TPU kernel's pool layout: [n_blocks, Hkv, page_size, ...]
        a = t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()
        return jnp.asarray(np.ascontiguousarray(a.transpose(0, 2, 1, 3)),
                           dtype)

    # fp pool
    k, v = _t(k).to(TDT[dt]), _t(v).to(TDT[dt])
    ref = jax_flash_decode(jq, jpool(k, dt), jpool(v, dt), jl,
                           block_tables=jt, interpret=True)
    check(flash_decode(tq, k, v, tl, block_tables=tt), ref)
    # int8 pool: the scale pools ride the same table (quantized by the
    # port, which is bitwise the reference's quantization)
    (k8, ks), (v8, vs) = Q.quantize_rows(k), Q.quantize_rows(v)
    ref = jax_flash_decode(jq, jpool(k8), jpool(v8), jl, k_scale=jpool(ks),
                           v_scale=jpool(vs), block_tables=jt, interpret=True)
    check(flash_decode(tq, k8, v8, tl, k_scale=ks, v_scale=vs,
                       block_tables=tt), ref)


@pytest.mark.parametrize("B,S,Hq,Hkv,D,tree,dt", TREE_CASES)
def test_tree_attention_paged_matches_reference(rng, B, S, Hq, Hkv, D, tree,
                                                dt):
    tb = medusa_63() if tree == "medusa" else chain_tree(4)
    ps = (8, 16, 64)[S % 3]
    table = _shuffled_table(rng, B, S // ps)
    lengths = rng.integers(1, S - tb.T - 1, size=(B,)).astype(np.int32)
    q = rng.standard_normal((B, tb.T, Hq, D)).astype(np.float32)
    kd = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    vd = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    scale = 1.0 / np.sqrt(D)
    jmask, jl, jt = (jnp.asarray(tb.mask), jnp.asarray(lengths),
                     jnp.asarray(table))
    tmask, tl, tt = torch.from_numpy(tb.mask), _t(lengths), _t(table)
    idx = (lengths[:, None] + np.arange(tb.T))[:, :, None, None]
    for quantized in (False, True):
        if quantized:
            (k8, ks), (v8, vs) = (Q.quantize_rows(_t(a)) for a in (kd, vd))
            kt, vt = Q.dequantize(k8, ks).numpy(), Q.dequantize(v8, vs).numpy()
            pools = [_to_pool(rng, a.numpy(), table, ps)
                     for a in (k8, v8, ks, vs)]
        else:
            kt, vt = kd, vd
            pools = [_to_pool(rng, a, table, ps) for a in (kd, vd)]
        kt = np.take_along_axis(kt, idx, axis=1)
        vt = np.take_along_axis(vt, idx, axis=1)
        jp = [jnp.asarray(a) for a in pools]
        tp = [_t(a) for a in pools]
        if not quantized:
            jp = [a.astype(dt) for a in jp]
            tp = [a.to(TDT[dt]) for a in tp]
        jsc = dict(zip(("k_scale", "v_scale"), jp[2:]))
        tsc = dict(zip(("k_scale", "v_scale"), tp[2:]))
        jq, tq = jnp.asarray(q, dt), _t(q).to(TDT[dt])
        out = TO.tree_attention(tq, tp[0], tp[1], tmask, tl, scale,
                                k_tree=_t(kt).to(TDT[dt]),
                                v_tree=_t(vt).to(TDT[dt]), block_tables=tt,
                                **tsc)
        ref_kernel = JO.tree_attention(
            jq, jp[0], jp[1], jmask, jl, scale, k_tree=jnp.asarray(kt, dt),
            v_tree=jnp.asarray(vt, dt), block_tables=jt, interpret=True,
            **jsc)
        ref_oracle = JR.tree_attention_ref_paged(jq, jp[0], jp[1], jt, jmask,
                                                 jl, scale, **jsc)
        oracle = TR.tree_attention_ref_paged(tq, tp[0], tp[1], tt, tmask, tl,
                                             scale, **tsc)
        for got, ref in ((out, ref_kernel), (out, ref_oracle),
                         (oracle, ref_oracle)):
            err = np.max(np.abs(got.float().numpy()
                                - np.asarray(ref, np.float32)))
            assert err < TOL[dt]
    with pytest.raises(ValueError, match="k_tree"):
        TO.tree_attention(tq, tp[0], tp[1], tmask, tl, scale,
                          block_tables=tt, **tsc)


# ------------------------------------------------------------ K3 and K5

def _pool_qkv_inputs(rng, T, dt, lengths, mb=3, ps=PS, dims=(64, 4, 2, 16)):
    d, Hq, Hkv, hd = dims
    Bs = len(lengths)
    p = {"wq": rng.standard_normal((d, Hq, hd)) / 8,
         "wk": rng.standard_normal((d, Hkv, hd)) / 8,
         "wv": rng.standard_normal((d, Hkv, hd)) / 8}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.standard_normal((Bs, T, d)).astype(np.float32)
    table = _shuffled_table(rng, Bs, mb)
    kc = rng.standard_normal((1 + Bs * mb, ps, Hkv, hd)).astype(np.float32)
    vc = rng.standard_normal((1 + Bs * mb, ps, Hkv, hd)).astype(np.float32)
    lengths = np.asarray(lengths, np.int32)
    cos, sin = JL.rope_cos_sin(
        jnp.asarray(lengths[:, None] + np.arange(T, dtype=np.int32)), hd,
        10000.0)
    jin = (jnp.asarray(x, dt), {k: jnp.asarray(v, dt) for k, v in p.items()},
           jnp.asarray(lengths), jnp.asarray(kc, dt), jnp.asarray(vc, dt),
           cos, sin, jnp.asarray(table))
    tin = (_t(x).to(TDT[dt]), {k: _t(v).to(TDT[dt]) for k, v in p.items()},
           _t(lengths), _t(kc).to(TDT[dt]), _t(vc).to(TDT[dt]), _t(cos),
           _t(sin), _t(table))
    return jin, tin


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", [8, 1])
def test_plain_fused_qkv_paged_matches_pallas(rng, T, dt):
    # slot 0 runs past its table (rows sink into block 0), slot 1 straddles
    # a block boundary, slot 2 starts at 0.  (T 8 stands for the spec
    # step: the interpret-mode Pallas kernel unrolls one copy per row.)
    lengths = (3 * PS - 2, PS - 3, 0) if T > 1 else (3 * PS, PS - 1, 0)
    (jx, jp, jl, jk, jv, jcos, jsin, jt), (x, p, tl, kc, vc, cos, sin, tt) = \
        _pool_qkv_inputs(rng, T, dt, lengths)
    ref = JCU.fused_qkv_rope_commit(jx, jp, jl, jk, jv, cos=jcos, sin=jsin,
                                    table=jt, interpret=True)
    k0 = kc.clone()
    got = CU.fused_qkv_rope_commit(x, p, tl, kc, vc, cos=cos, sin=sin,
                                   table=tt)
    for g, r in zip(got, ref[:3]):
        np.testing.assert_allclose(g.float().numpy(), np.asarray(r, np.float32),
                                   atol=TOL[dt], rtol=0)
    for g, r in ((kc, ref[3]), (vc, ref[4])):
        np.testing.assert_allclose(_except_trash(g.float().numpy()),
                                   _except_trash(r), atol=TOL[dt], rtol=0)
    assert not torch.equal(kc[1:], k0[1:])


def _commit_pool_inputs(rng, nu=None, lengths=(0, PS - 2, 3 * PS - 1)):
    """Integer values in [-100, 100] (exact in every dtype); slot 2's last
    four rows lie past its 3-block table."""
    lead = () if nu is None else (nu,)
    Bs, K1, H, D, mb = len(lengths), 5, 2, 16, 3
    table = _shuffled_table(rng, Bs, mb)
    pool = rng.integers(-100, 101, lead + (1 + Bs * mb, PS, H, D))
    rows = rng.integers(-100, 101, lead + (Bs, K1, H, D))
    return (pool.astype(np.float32), rows.astype(np.float32), table,
            np.asarray(lengths, np.int32))


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16, np.int8])
def test_commit_rows_paged_matches_pallas(rng, dtype):
    tdt = {np.float32: torch.float32, jnp.bfloat16: torch.bfloat16,
           np.int8: torch.int8}[dtype]
    pool, rows, table, lengths = _commit_pool_inputs(rng)
    jargs = (jnp.asarray(table), jnp.asarray(rows), jnp.asarray(lengths))
    ref = JCU.commit_rows_paged(jnp.asarray(pool).astype(dtype), *jargs,
                                interpret=True)
    got = CU.commit_rows_paged_stacked(_t(pool).to(tdt)[None], _t(table),
                                       _t(rows)[None], _t(lengths))[0]
    np.testing.assert_array_equal(_except_trash(got.float().numpy()),
                                  _except_trash(ref))
    # stacked: every unit's pool through the one table, in one write
    pool, rows, table, lengths = _commit_pool_inputs(rng, nu=3)
    jargs = (jnp.asarray(table), jnp.asarray(lengths))
    ref = np.stack([np.asarray(JCU.commit_rows_paged(
        jnp.asarray(pool[u]).astype(dtype), jargs[0], jnp.asarray(rows[u]),
        jargs[1], interpret=True), np.float32) for u in range(3)])
    for fn in (CU.commit_rows_paged_stacked,
               CU.commit_rows_paged_stacked_plain):
        got = fn(_t(pool).to(tdt), _t(table), _t(rows), _t(lengths))
        np.testing.assert_array_equal(got.float().numpy()[:, 1:], ref[:, 1:])


def test_commit_rows_paged_quantized_matches_pallas(rng):
    """The model's int8 paged commit of one unit, with the best path the
    first K1 in-flight rows, writes what the Pallas
    ``commit_rows_paged_quantized`` writes (block 0 excepted)."""
    pool, rows, table, lengths = _commit_pool_inputs(rng)
    p8, sc = pool.astype(np.int8), np.abs(pool[..., :1]) / 127
    ref_p, ref_s = JCU.commit_rows_paged_quantized(
        jnp.asarray(p8), jnp.asarray(sc), jnp.asarray(table),
        jnp.asarray(rows), jnp.asarray(lengths), interpret=True)
    B, K1 = rows.shape[:2]
    entry = {"k": _t(p8)[None], "k_scale": _t(sc)[None],
             "v": _t(p8)[None].clone(), "v_scale": _t(sc)[None].clone(),
             "k_new": _t(rows)[None], "v_new": _t(rows)[None]}
    path = torch.arange(K1)[None].expand(B, K1)
    got = TT._commit_attn_entry(entry, _t(lengths), path, table=_t(table))
    for name in ("k", "v"):
        np.testing.assert_array_equal(got[name][0].numpy()[1:],
                                      np.asarray(ref_p)[1:])
        np.testing.assert_array_equal(got[name + "_scale"][0].numpy()[1:],
                                      np.asarray(ref_s)[1:])


# ------------------------------------------------------ layer and engine

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


def _layout(cfg, dtype, layout="paged"):
    return dataclasses.replace(cfg, cache_dtype=dtype, cache_layout=layout,
                               page_size=PS)


def _close_cache(t_cache, j_cache):
    """Every leaf, pools without block 0: int8 values equal, the rest
    within 3e-5; decode's in-flight rows (a tuple, one tensor per unit)
    stacked."""
    for pos, j_entry in j_cache.items():
        for name, j in j_entry.items():
            t, j = t_cache[pos][name], np.asarray(j)
            if isinstance(t, tuple):
                t = torch.stack(t)
            if pos != TT.PAGES_KEY:
                t, j = t[:, 1:], j[:, 1:]
            if t.dtype in (torch.int8, torch.int32):
                np.testing.assert_array_equal(t.numpy(), j)
            else:
                np.testing.assert_allclose(t.float().numpy(), j, atol=3e-5,
                                           rtol=1e-5)


@pytest.mark.parametrize("dtype", ["", "int8"])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_prefill_decode_commit_paged_match_reference(stack, use_kernel,
                                                     dtype):
    cfg, tb, params, _, tparams, _, tokens, lengths = stack
    cfg = dataclasses.replace(_layout(cfg, dtype), num_layers=1)
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
    _close_cache(tcache, jcache)

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
    _close_cache(tspec, jspec)

    path = np.stack([tb.retrieve[3], tb.retrieve[0]]).astype(np.int32)
    acc = np.array([2, 4], np.int32)
    jc, jlen = jm.commit(cfg, jspec, jnp.asarray(lengths), jnp.asarray(path),
                         jnp.asarray(acc))
    tc, tlen = TT.commit(cfg, tspec, _t(lengths), _t(path), _t(acc))
    np.testing.assert_array_equal(tlen.numpy(), np.asarray(jlen))
    assert set(tc) == {"pos0", TT.PAGES_KEY}
    _close_cache(tc, jc)


@pytest.fixture(scope="module")
def jax_paged(stack):
    cfg, tb, params, mp, _, _, tokens, lengths = stack
    runs = {}
    for dtype in ("", "int8"):
        c = _layout(cfg, dtype)
        out, n_out, st = JaxSpecEngine(c, tb, use_kernel=True).generate(
            params, mp, jnp.asarray(tokens), jnp.asarray(lengths),
            jax_get_model(c).init_cache(c, B, S_MAX), MAX_NEW)
        runs[dtype] = (np.asarray(out), np.asarray(n_out), int(st.steps))
    return runs


def _generate(cfg, tb, tparams, tmp, tokens, lengths, **kw):
    eng = SpecEngine(cfg, tb, device="cpu", **kw)
    return eng.generate(tparams, tmp, _t(tokens), _t(lengths),
                        eng.init_cache(B, S_MAX), MAX_NEW)


@pytest.mark.parametrize("dtype", ["", "int8"])
def test_paged_spec_equals_ar_equals_reference(stack, jax_paged, dtype):
    cfg, tb, _, _, tparams, tmp, tokens, lengths = stack
    c = _layout(cfg, dtype)
    out, n_out, st = _generate(c, tb, tparams, tmp, tokens, lengths,
                               use_kernel=True)
    ar, _ = ar_generate(c, tparams, _t(tokens), _t(lengths),
                        TT.init_cache(c, B, S_MAX, device="cpu"), MAX_NEW,
                        use_kernel=True)
    dense = _generate(_layout(cfg, dtype, "dense"), tb, tparams, tmp, tokens,
                      lengths, use_kernel=True)[0]
    jout, jn, jsteps = jax_paged[dtype]
    np.testing.assert_array_equal(out.numpy(), ar.numpy())
    np.testing.assert_array_equal(out.numpy(), jout)
    np.testing.assert_array_equal(out.numpy(), dense.numpy())
    np.testing.assert_array_equal(n_out.numpy(), jn)
    assert st.steps == jsteps < MAX_NEW


def test_paged_fused_equals_dense_fused(stack):
    cfg, tb, _, _, tparams, tmp, tokens, lengths = stack
    outs = {lay: _generate(_layout(cfg, "", lay), tb, tparams, tmp, tokens,
                           lengths, use_kernel=True, verify_fusion=True)
            for lay in ("dense", "paged")}
    np.testing.assert_array_equal(outs["paged"][0].numpy(),
                                  outs["dense"][0].numpy())
    assert outs["paged"][2].steps == outs["dense"][2].steps < MAX_NEW


def test_launcher_int8_paged_answers_every_request(capsys):
    argv = ["--static", "--reduced", "--device", "cpu", "--requests", "5",
            "--slots", "2", "--max-new", "8", "--max-len", "128"]
    srv = serve.main(argv + ["--cache-dtype", "int8", "--cache-layout",
                             "paged", "--page-size", "16"])
    assert srv.cfg.resolved_cache_dtype == "int8" and srv.cfg.paged
    assert srv.cfg.page_size == 16
    assert [r["status"] for r in srv.results] == ["done"] * 5
    assert all(len(r["output"]) == 8 for r in srv.results)
    assert "int8 paged cache, page size 16" in capsys.readouterr().out
    # the same weights on the int8 dense cache give the same answers
    dense = serve.main(argv + ["--cache-dtype", "int8"],
                       weights=(srv.params, srv.proposer_params))
    for a, b in zip(srv.results, dense.results):
        np.testing.assert_array_equal(a["output"], b["output"])
