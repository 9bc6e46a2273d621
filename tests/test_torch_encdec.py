"""The port's encoder-decoder (whisper-tiny) against the JAX reference on
the CPU, at the reference's own reduced config, in float32, on the same
weights (``split_params`` -> numpy -> ``bridge.to_torch``) and the same
seeded inputs (frames from the reference's ``frontend_embeds``).

* Configs: the port's copy equals the reference's field by field, full
  and reduced, with the published dimensions; ``init_params`` has the
  reference's tree (``jax.eval_shape``, f32 and bf16); ``get_model``
  gives ``encdec``, and only tensor parallelism raises.
* The layers within 3e-5 of each output's largest magnitude:
  ``layer_norm`` (and LayerNorm's init), ``attention_full`` without a
  causal mask, ``cross_kv``, ``attention_cross``, ``encode``.
* One model step at a time, on one decoder layer (the four-layer stack's
  float32 drift reaches ~1e-4 of the largest value; its tokens are held
  below): ``prefill`` (hidden, self and cross rows), ``decode`` (hidden,
  in-flight rows) on every layout, and ``commit`` bitwise on every layout
  from the same random spec cache, ``cross`` untouched.
* The identity matrix: spec == the port's AR == the reference's
  ``ar_generate``, token for token, on dense and paged x fp and int8,
  Medusa and n-gram, greedy and sampled at temperature 0 (Medusa fused
  too); the draft proposer against the live reference ``SpecEngine``;
  ``deferred`` is forced off, as the reference forces it.
* The committed greedy goldens (``tests/golden/encdec_goldens.npz``) on
  both layouts and both cache dtypes.
* The server: the port's ``SpecServer`` equals the live reference's on
  the paged trace of ``test_encdec_serves_paged_token_identical``
  (tokens, statuses, stats; the pool drained); a preempted request
  runs its encoder again at re-admission (== AR); frames are
  required, the prefix cache and chunking refused; paged admission
  writes each slot's cross k/v as a one-row prefill does, and
  copy-on-write leaves the cross k/v alone; ``cache_max_len`` skips it.
* Training: ``lm_loss`` and its gradients against ``jax.value_and_grad``
  and float64; ``medusa_loss`` refuses the family.
* The stubbed capture (``test_torch_graphs.stub_cuda``): replayed tokens
  equal the eager engine's, launches exact (no K3 under fusion), the
  cross leaves keep their addresses.
* The launcher serves whisper-tiny (server, static, fused, paged int8).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import SchedulerParams as JSchedulerParams
from repro.configs.registry import get_config as jax_get_config
from repro.core import medusa as JM
from repro.core import proposers as JP
from repro.core.engine import SpecEngine as JaxSpecEngine
from repro.core.engine import ar_generate as jax_ar_generate
from repro.core.engine import build_engine as jax_build_engine
from repro.distributed.sharding import split_params
from repro.models import encdec as JE
from repro.models import frontends as JF
from repro.models import layers as JL
from repro.serving.scheduler import SpecServer as JaxSpecServer
from repro.training import steps as JST
from repro_torch import bridge
from repro_torch.configs.base import SamplingParams, SchedulerParams
from repro_torch.configs.registry import ALL_ARCHS, get_config
from repro_torch.core import tree as TT
from repro_torch.core.engine import (SpecCarry, SpecEngine, ar_generate,
                                     build_engine)
from repro_torch.launch import serve
from repro_torch.models import encdec as E
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.api import get_model
from repro_torch.serving.scheduler import SpecServer
from repro_torch.training import optimizer as O
from repro_torch.training import steps as ST
from test_torch_graphs import WRAPPERS, _count_on_cpu
from test_torch_graphs import counters, stub_cuda  # noqa: F401 (fixtures)

ARCH = "whisper-tiny"
TOL = 3e-5
B, S_P, MAX_NEW, S_MAX, PS = 2, 8, 6, 96, 8
GOLDEN = "tests/golden/encdec_goldens.npz"
LAYOUTS = {"dense": ("", "dense"), "int8": ("int8", "dense"),
           "paged": ("", "paged"), "int8+paged": ("int8", "paged")}
_jax_init = jax.jit(JE.init_params, static_argnums=1)
_jax_decode = jax.jit(JE.decode, static_argnums=(1,))
_jax_prefill = jax.jit(JE.prefill, static_argnums=(1,))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module's torch work: the suite runs in
    several workers on a few cores, and each worker's default pool
    oversubscribes them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, tol=TOL):
    """Within ``tol`` of the reference's largest magnitude."""
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got / scale, want / scale, atol=tol, rtol=0)


class Stack:
    """The reduced whisper-tiny in both frameworks (``layers`` decoder
    layers, default the config's 4): the reference's weights (the
    goldens' key), Medusa heads on the 63-node tree seeded from the lm
    head, the same leaves in torch, seeded prompts and the reference's
    stub frames."""

    def __init__(self, layers=None):
        self.cfg = jax_get_config(ARCH, reduced=True)
        self.tcfg = get_config(ARCH, reduced=True)
        if layers is not None:
            self.cfg = dataclasses.replace(self.cfg, num_layers=layers)
            self.tcfg = dataclasses.replace(self.tcfg, num_layers=layers)
        self.tb = TT.medusa_63()
        # the goldens' draws (``golden_weights``), which the other tests
        # share
        with jax.threefry_partitionable(False):
            self.params, _ = split_params(_jax_init(jax.random.PRNGKey(1),
                                                    self.cfg))
            self.mp, _ = split_params(JM.init_medusa(
                jax.random.PRNGKey(2), self.cfg, self.tb.K,
                base_lm_head=self.params["lm_head"]))
            self.golden_mp = self.reference_heads()
        self.tparams = bridge.to_torch(_np(self.params), device="cpu")
        self.tmp = bridge.to_torch(_np(self.mp), device="cpu")
        rng = np.random.default_rng(4)
        self.tokens = rng.integers(0, self.cfg.vocab_size,
                                   size=(B, S_P)).astype(np.int32)
        self.lengths = np.array([S_P, 6], np.int32)
        self.frames = np.asarray(JF.frontend_embeds(
            self.cfg, B, key=jax.random.PRNGKey(3)))
        self._ar = {}

    def layout(self, name, cfg=None, fused=False):
        dtype, layout = LAYOUTS[name]
        return dataclasses.replace(cfg or self.tcfg, cache_dtype=dtype,
                                   cache_layout=layout, page_size=PS,
                                   verify_fusion=fused)

    def jlayout(self, name):
        dtype, layout = LAYOUTS[name]
        return dataclasses.replace(self.cfg, cache_dtype=dtype,
                                   cache_layout=layout, page_size=PS)

    def reference_heads(self):
        """The reference's whisper tests' heads (``_whisper_stack``): the
        default init, its residual block perturbed."""
        mp, _ = split_params(JM.init_medusa(jax.random.PRNGKey(2), self.cfg,
                                            self.tb.K))
        mp["w1"] = jax.random.normal(jax.random.PRNGKey(3), mp["w1"].shape,
                                     mp["w1"].dtype) * 0.1
        return mp

    def jax_ar(self, name):
        """The reference's greedy ``ar_generate`` tokens on ``name``."""
        if name not in self._ar:
            c = self.jlayout(name)
            out, _ = jax_ar_generate(c, self.params, jnp.asarray(self.tokens),
                                     jnp.asarray(self.lengths),
                                     JE.init_cache(c, B, S_MAX), MAX_NEW,
                                     extra_embeds=jnp.asarray(self.frames))
            self._ar[name] = np.asarray(out)
        return self._ar[name]


_STACKS = {}


def stack(layers=None) -> Stack:
    if layers not in _STACKS:
        _STACKS[layers] = Stack(layers)
    return _STACKS[layers]


# ------------------------------------------------------------------ configs

@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_config_matches_reference(reduced):
    got = dataclasses.asdict(get_config(ARCH, reduced=reduced))
    want = dataclasses.asdict(jax_get_config(ARCH, reduced=reduced))
    assert got == want
    assert ARCH in ALL_ARCHS


def test_published_dimensions():
    c = get_config(ARCH)
    assert (c.num_layers, c.encoder_layers, c.d_model, c.num_heads,
            c.num_kv_heads, c.resolved_head_dim, c.d_ff, c.vocab_size) == \
        (4, 4, 384, 6, 6, 64, 1536, 51865)
    assert (c.family, c.norm, c.act, c.gated_mlp, c.qkv_bias, c.use_rope,
            c.frontend_len, c.frontend_dim, c.max_position) == \
        ("encdec", "layernorm", "gelu", False, True, False, 1500, 384, 33024)
    assert get_config(ARCH, reduced=True).frontend_len == 16


def _shapes(tree):
    return {k: _shapes(v) if isinstance(v, dict) else
            (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in tree.items()}


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_init_params_tree_matches_reference(dt):
    """The port's ``init_params`` has the reference's tree, shapes and
    dtypes (``jax.eval_shape`` of the reference's init): the stacked
    ``enc_units`` / ``dec_units``, LayerNorm's f32 ``w``/``b``, the learned
    positions; the bridge carries the reference's tree leaf for leaf."""
    s = stack()
    jcfg = dataclasses.replace(s.cfg, param_dtype=dt)
    tcfg = dataclasses.replace(s.tcfg, param_dtype=dt)
    abstract = split_params(jax.eval_shape(
        lambda k: JE.init_params(k, jcfg), jax.random.PRNGKey(0)))[0]
    want = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), abstract)
    mine = E.init_params(torch.Generator().manual_seed(0), tcfg)
    assert _shapes(mine) == want
    assert _shapes(s.tparams) == _shapes(E.init_params(
        torch.Generator().manual_seed(0), s.tcfg))
    norm = mine["dec_units"]["norm_x"]
    assert torch.equal(norm["w"], torch.ones_like(norm["w"]))
    assert torch.equal(norm["b"], torch.zeros_like(norm["b"]))
    assert norm["b"].dtype == torch.float32


def test_get_model_carries_encdec_and_refuses_only_tp():
    cfg = get_config(ARCH, reduced=True)
    assert get_model(cfg) is E
    T.check_supported(cfg)
    # tensor parallelism shards the dense family only
    with pytest.raises(ValueError, match="dense family"):
        get_model(dataclasses.replace(cfg, tp_axis="model"))


# ------------------------------------------------------------------ layers

@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_layer_norm_matches_reference(dt):
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((2, 5, 64)) * 3 + 1).astype(np.float32)
    w = rng.standard_normal((64,)).astype(np.float32)
    b = rng.standard_normal((64,)).astype(np.float32)
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dt]
    got = L.layer_norm(_t(x).to(tdt), _t(w), _t(b))
    want = JL.layer_norm(jnp.asarray(x, dt), jnp.asarray(w), jnp.asarray(b))
    assert got.dtype == tdt
    _close(got, np.asarray(want, np.float32),
           TOL if dt == "float32" else 2e-2)
    cfg = get_config(ARCH, reduced=True)
    p = L.init_norm(cfg, "cpu")
    jp = split_params(JL.init_norm(jax.random.PRNGKey(0), cfg))[0]
    assert set(p) == set(jp) == {"w", "b"}
    _close(L.apply_norm(p, _t(x), cfg), JL.apply_norm(jp, jnp.asarray(x),
                                                      cfg))


def _unit0(tree):
    return jax.tree.map(lambda a: a[0], tree)


def _tunit0(tree):
    return {k: _tunit0(v) if isinstance(v, dict) else v[0]
            for k, v in tree.items()}


def test_attention_full_non_causal_and_cross_match_reference():
    """The encoder's unmasked ``attention_full`` (and the causal default,
    unchanged), ``cross_kv`` and ``attention_cross`` with their biases
    drawn at random (the init leaves them zero)."""
    s = stack()
    cfg = s.cfg
    rng = np.random.default_rng(2)
    jp = _unit0(s.params["dec_units"]["cross_attn"])
    for name in ("bq", "bk", "bv"):
        jp[name] = jnp.asarray(rng.standard_normal(jp[name].shape)
                               .astype(np.float32))
    tp = bridge.to_torch(_np(jp), device="cpu")
    x = rng.standard_normal((B, 5, cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((B, 16, cfg.d_model)).astype(np.float32)
    for causal in (False, True):
        _close(L.attention_full(tp, _t(enc), s.tcfg, causal=causal),
               JL.attention_full(jp, jnp.asarray(enc), cfg, causal=causal))
    jk, jv = JL.cross_kv(jp, jnp.asarray(enc), cfg)
    tk, tv = L.cross_kv(tp, _t(enc), s.tcfg)
    _close(tk, jk)
    _close(tv, jv)
    _close(L.attention_cross(tp, _t(x), (tk, tv), s.tcfg),
           JL.attention_cross(jp, jnp.asarray(x), (jk, jv), cfg))


def test_encode_matches_reference():
    s = stack()
    got = E.encode(s.tparams, s.tcfg, _t(s.frames))
    want = JE.encode(s.params, s.cfg, jnp.asarray(s.frames))
    assert got.shape == (B, s.cfg.frontend_len, s.cfg.d_model)
    _close(got, want)
    with pytest.raises(ValueError, match="frame embeddings"):
        E.prefill(s.tparams, s.tcfg, _t(s.tokens), _t(s.lengths),
                  E.init_cache(s.tcfg, B, S_MAX, device="cpu"))


# -------------------------------------------------------- one model step

def _jrows(jentry, table):
    """The reference's self rows as dense f32 [nu, B, S, H, D] numpy."""
    k, v = [], []
    for u in range(jentry["k"].shape[0]):
        ku, vu = JE._read_cache({n: a[u] for n, a in jentry.items()
                                 if not n.endswith("_new")}, jnp.float32,
                                table=table)
        k.append(np.asarray(ku))
        v.append(np.asarray(vu))
    return np.stack(k), np.stack(v)


def _trows(entry, table):
    k, v = [], []
    for u in range(entry["k"].shape[0]):
        ku, vu = T._read_cache({n: t[u] for n, t in entry.items()
                                if not n.endswith("_new")}, torch.float32,
                               table=table)
        k.append(ku)
        v.append(vu)
    return torch.stack(k), torch.stack(v)


def _prefilled(s, name):
    """Both frameworks' prefill on ``name``: (jlast, jcache, tlast,
    tcache, table or None)."""
    jc, tc = s.jlayout(name), s.layout(name)
    jlast, jcache = _jax_prefill(s.params, jc, jnp.asarray(s.tokens),
                                 jnp.asarray(s.lengths),
                                 JE.init_cache(jc, B, S_MAX),
                                 extra_embeds=jnp.asarray(s.frames))
    tlast, tcache = E.prefill(s.tparams, tc, _t(s.tokens), _t(s.lengths),
                              E.init_cache(tc, B, S_MAX, device="cpu"),
                              extra_embeds=_t(s.frames))
    table = tcache.get(T.PAGES_KEY, {}).get("table")
    return jlast, jcache, tlast, tcache, table


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_prefill_decode_match_reference(name):
    """One decoder layer: prefill's last hidden rows, its self rows (int8:
    dequantized, within one code step) and cross k/v; then one tree
    decode step over the 63-node tree: hidden and the in-flight rows."""
    s = stack(layers=1)
    jlast, jcache, tlast, tcache, table = _prefilled(s, name)
    _close(tlast, jlast)
    jtab = None if table is None else jcache[JE.PAGES_KEY]["table"]
    jk, jv = _jrows(jcache["self"], jtab)
    tk, tv = _trows(tcache["self"], table)
    n = S_P
    tol = TOL * (2 ** 7 if "int8" in name else 1)
    _close(tk[:, :, :n], jk[:, :, :n], tol)
    _close(tv[:, :, :n], jv[:, :, :n], tol)
    for leaf in ("k", "v"):
        _close(tcache["cross"][leaf], jcache["cross"][leaf])
        assert tcache["cross"][leaf].dtype == torch.float32
    # decode over the cache the reference prefilled, carried across
    tcache = bridge.to_torch(_np(jcache), device="cpu")
    rng = np.random.default_rng(6)
    toks = rng.integers(0, s.cfg.vocab_size,
                        size=(B, s.tb.T)).astype(np.int32)
    mask, depths = s.tb.mask, s.tb.depths
    jh, jspec = _jax_decode(s.params, s.jlayout(name), jcache,
                            jnp.asarray(toks), jnp.asarray(s.lengths),
                            jnp.asarray(mask), jnp.asarray(depths))
    for use_kernel in (False, True):
        th, tspec = E.decode(s.tparams, s.layout(name), dict(
            {k: dict(v) for k, v in tcache.items()}), _t(toks),
            _t(s.lengths), _t(mask), _t(depths), use_kernel=use_kernel)
        _close(th, jh)
        _close(tspec["self"]["k_new"][0], jspec["self"]["k_new"][0])
        _close(tspec["self"]["v_new"][0], jspec["self"]["v_new"][0])
        assert all(tspec["cross"][n] is tcache["cross"][n] for n in "kv")


def _spec_cache(c, rng):
    """A spec cache of ``c``'s layout (the reference's, as numpy): random
    committed leaves (int8 codes and f32 scales under int8), the
    63-node tree's in-flight rows ``k_new``/``v_new`` [nu, B, T, H, D]
    and, paged, a shuffled block table."""
    T_ = TT.medusa_63().T
    cache = _np(JE.init_cache(c, B, S_MAX))
    spec = {}
    for pos, entry in cache.items():
        spec[pos] = {}
        for n, a in entry.items():
            if n == "table":
                perm = rng.permutation(a.size) + 1
                spec[pos][n] = perm.reshape(a.shape).astype(np.int32)
            elif a.dtype == np.int8:
                spec[pos][n] = rng.integers(-127, 128, a.shape).astype(
                    np.int8)
            else:
                spec[pos][n] = rng.standard_normal(a.shape).astype(a.dtype)
    nu, _, _, H, D = cache["cross"]["k"].shape
    for n in ("k_new", "v_new"):
        spec["self"][n] = rng.standard_normal((nu, B, T_, H, D)).astype(
            np.float32)
    return spec


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_commit_bitwise_on_every_layout(name):
    """From the same spec cache, the port's commit gives the reference's
    committed cache bit for bit (int8: the rows re-quantized on the way),
    the new lengths under a masked commit, and ``cross`` untouched (the
    same tensors, the same bytes)."""
    s = stack()
    jc = s.jlayout(name)
    rng = np.random.default_rng(8)
    jspec = _spec_cache(jc, rng)
    path = rng.integers(0, s.tb.T, size=(B, s.tb.K + 1)).astype(np.int32)
    acc = np.array([3, 1], np.int32)
    active = np.array([True, False])
    lengths = np.array([S_P, 40], np.int32)
    # the reference's commit op by op, as its own tests run it (compiled,
    # XLA may divide the int8 scale by multiplying with the reciprocal)
    jnew, jlen = JE.commit(jc, jax.tree.map(jnp.asarray, jspec),
                           jnp.asarray(lengths), jnp.asarray(path),
                           jnp.asarray(acc), jnp.asarray(active))
    spec = bridge.to_torch(jspec, device="cpu")
    for n in ("k_new", "v_new"):
        spec["self"][n] = tuple(spec["self"][n].unbind(0))
    cross = {n: t.clone() for n, t in spec["cross"].items()}
    tnew, tlen = E.commit(s.layout(name), spec, _t(lengths), _t(path),
                          _t(acc), active=_t(active))
    np.testing.assert_array_equal(tlen.numpy(), np.asarray(jlen))
    assert set(tnew) == set(jnew)
    for leaf, want in jnew["self"].items():
        np.testing.assert_array_equal(tnew["self"][leaf].numpy(),
                                      np.asarray(want))
    assert not np.array_equal(jspec["self"]["k"], np.asarray(
        jnew["self"]["k"]))                       # rows were written
    for leaf in ("k", "v"):
        assert tnew["cross"][leaf] is spec["cross"][leaf]
        assert torch.equal(tnew["cross"][leaf], cross[leaf])
        np.testing.assert_array_equal(tnew["cross"][leaf].numpy(),
                                      np.asarray(jnew["cross"][leaf]))


def test_cache_max_len_skips_the_cross_entry():
    """The capacity is the self rows', whatever the entries' order (the
    reference excludes ``cross`` by name); a window past the learned
    position table is refused."""
    c = get_config(ARCH, reduced=True)
    for layout in ("dense", "paged"):
        cc = dataclasses.replace(c, cache_layout=layout, page_size=PS)
        cache = E.init_cache(cc, B, 40, device="cpu")
        want = 40 if layout == "dense" else 5 * PS
        assert T.cache_max_len(cache) == want
        swapped = {"cross": cache["cross"]}
        swapped.update((k, v) for k, v in cache.items() if k != "cross")
        assert T.cache_max_len(swapped) == want
        assert not T.is_cache_rows("cross", cache["cross"])
        assert T.is_cache_rows("self", cache["self"])
    with pytest.raises(ValueError, match="position table"):
        E._check_positions(c, c.max_position + 1)


# ------------------------------------------------------------------ engine

@pytest.mark.parametrize("kind", ["medusa", "ngram"])
@pytest.mark.parametrize("name", list(LAYOUTS))
def test_identity_matrix(name, kind):
    """spec == the port's AR == the reference's AR on every layout, greedy
    and sampled at temperature 0 (Medusa also fused): the reference's
    ``test_family_identity_matrix`` on the port."""
    s = stack()
    c = s.layout(name)
    tok, plen, fr = _t(s.tokens), _t(s.lengths), _t(s.frames)
    ar, _ = ar_generate(c, s.tparams, tok, plen,
                        E.init_cache(c, B, S_MAX, device="cpu"), MAX_NEW,
                        use_kernel=True, extra_embeds=fr)
    np.testing.assert_array_equal(ar.numpy(), s.jax_ar(name))
    runs = [("greedy", False), ("sample", False)]
    if kind == "medusa":
        runs.append(("greedy", True))
    for accept, fused in runs:
        eng = build_engine(c, kind, gamma=3, accept=accept, device="cpu",
                           use_kernel=True, verify_fusion=fused,
                           sampling=SamplingParams(temperature=0.0), seed=3)
        out, n_out, _ = eng.generate(
            s.tparams, s.tmp if kind == "medusa" else None, tok, plen,
            eng.init_cache(B, S_MAX), MAX_NEW, extra_embeds=fr)
        np.testing.assert_array_equal(out.numpy(), ar.numpy(),
                                      err_msg=f"{name} {kind} {accept}")
        assert (n_out == MAX_NEW).all()


def test_draft_and_ngram_match_live_reference():
    """The draft proposer (a 2-decoder-layer sibling made of the target's
    first two layers, its encoder the target's, primed with the frames)
    and the n-gram lookup against the reference ``SpecEngine`` with the
    same proposer: tokens, steps and the accepted sum."""
    s = stack()
    c, tc = s.jlayout("dense"), s.layout("dense")
    dcfg = dataclasses.replace(c, num_layers=2, name=c.name + "-draft")
    dparams = dict(s.params, dec_units=jax.tree.map(lambda x: x[:2],
                                                    s.params["dec_units"]))
    tdcfg = dataclasses.replace(tc, num_layers=2, name=tc.name + "-draft")
    for kind in ("draft", "ngram"):
        jp = JP.make_proposer(kind, c, draft_cfg=dcfg, gamma=3)
        jout, jn, jst = JaxSpecEngine(c, proposer=jp).generate(
            s.params, dparams if kind == "draft" else None,
            jnp.asarray(s.tokens), jnp.asarray(s.lengths),
            JE.init_cache(c, B, S_MAX), MAX_NEW,
            extra_embeds=jnp.asarray(s.frames))
        eng = build_engine(tc, kind, draft_cfg=tdcfg, gamma=3,
                           use_kernel=True, device="cpu")
        out, n_out, st = eng.generate(
            s.tparams, bridge.to_torch(_np(dparams), device="cpu")
            if kind == "draft" else None, _t(s.tokens), _t(s.lengths),
            eng.init_cache(B, S_MAX), MAX_NEW, extra_embeds=_t(s.frames))
        np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
        np.testing.assert_array_equal(out.numpy(), s.jax_ar("dense"))
        assert (st.steps, int(st.accepted_sum)) == (int(jst.steps),
                                                    int(jst.accepted_sum))


def test_deferred_is_forced_off():
    s = stack()
    eng = SpecEngine(s.tcfg, s.tb, use_kernel=True, device="cpu",
                     deferred=True)
    assert eng.deferred is False
    out, _, _ = eng.generate(s.tparams, s.tmp, _t(s.tokens), _t(s.lengths),
                             eng.init_cache(B, S_MAX), MAX_NEW,
                             extra_embeds=_t(s.frames))
    np.testing.assert_array_equal(out.numpy(), s.jax_ar("dense"))


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_golden_greedy_streams(name):
    """The committed whisper goldens (the reference's
    ``test_encdec_golden_tokens`` setup: its weights, the 63-node tree,
    heads with a perturbed residual block), greedy, on each layout.  The
    weights were drawn with ``jax_threefry_partitionable`` off, the
    default of the JAX that wrote the goldens; JAX 0.5 turned it on,
    which draws other bits from the same keys (under it the reference's
    own ``test_encdec_golden_tokens`` fails), so ``Stack`` pins it off."""
    s = stack()
    g = np.load(GOLDEN)
    params, mp = s.tparams, bridge.to_torch(_np(s.golden_mp), "cpu")
    c = s.layout(name)
    toks = g["prompt"]
    lens = np.full((toks.shape[0],), toks.shape[1], np.int32)
    smax = toks.shape[1] + 16 + s.tb.T + 8
    eng = SpecEngine(c, s.tb, use_kernel=True, device="cpu")
    out, _, _ = eng.generate(params, mp, _t(toks), _t(lens),
                             eng.init_cache(toks.shape[0], smax), 16,
                             extra_embeds=_t(g["frames"]))
    dtype = "int8" if "int8" in name else "fp"
    np.testing.assert_array_equal(out.numpy(), g[f"greedy_{dtype}"])


# ------------------------------------------------------------------ server

def _trace(cfg):
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)).astype(np.int32)
               for n in rng.integers(4, 30, size=3)]
    frames = [np.asarray(JF.frontend_embeds(
        cfg, 1, key=jax.random.PRNGKey(60 + i))[0], np.float32)
        for i in range(3)]
    return prompts, frames


def test_server_matches_reference():
    """The reference's paged encdec serving trace (2 slots, sampled
    acceptance with temperature-0 requests, per-request frames, page 8,
    25 blocks, preemption): every request's tokens and status and the
    whole stats dict equal the live reference ``SpecServer``'s, each
    answer is the port's AR, and the pool drains."""
    s = stack()
    layout, paged = "paged", True
    cfg = dataclasses.replace(s.cfg, cache_layout=layout, page_size=8)
    tcfg = dataclasses.replace(s.tcfg, cache_layout=layout, page_size=8)
    prompts, frames = _trace(s.cfg)
    mp = s.golden_mp
    kw = dict(batch_slots=2, max_len=128, n_blocks=25 if paged else None)

    def run(srv):
        rids = [srv.submit(p, max_new=MAX_NEW, temperature=0.0,
                           max_steps=200, extra_embeds=fr)
                for p, fr in zip(prompts, frames)]
        srv.run(max_iters=500)
        assert not srv.busy
        return [(srv.result(r).status, list(srv.result(r).output))
                for r in rids]

    jsrv = JaxSpecServer(jax_build_engine(cfg, "medusa", accept="sample"),
                         s.params, mp,
                         sched=JSchedulerParams(preemption=paged), **kw)
    want = run(jsrv)
    tsrv = SpecServer(build_engine(tcfg, "medusa", accept="sample",
                                   use_kernel=True, device="cpu"),
                      s.tparams, bridge.to_torch(_np(mp), "cpu"),
                      sched=SchedulerParams(preemption=paged), **kw)
    assert run(tsrv) == want
    assert tsrv.stats == jsrv.stats
    for p, fr, (status, out) in zip(prompts, frames, want):
        ar, _ = ar_generate(tcfg, s.tparams, _t(p[None]), _t([len(p)]),
                            E.init_cache(tcfg, 1, 128, device="cpu"),
                            MAX_NEW, use_kernel=True,
                            extra_embeds=_t(fr[None]))
        assert status == "done" and out == ar[0].tolist()
    if paged:
        assert tsrv.pool.in_use == 0


def test_preempted_request_reencodes_its_frames():
    """A pool too small for two requests' growth (page 8, 21 blocks,
    max_new 24): a request is preempted and re-admitted, its prefill
    running the encoder on its kept frames again; every answer equals
    the port's AR on its own frames, and the pool drains."""
    s = stack()
    tcfg = dataclasses.replace(s.tcfg, cache_layout="paged", page_size=8)
    prompts, frames = _trace(s.cfg)
    srv = SpecServer(build_engine(tcfg, "medusa", use_kernel=True,
                                  device="cpu"), s.tparams, s.tmp,
                     batch_slots=2, max_len=128, n_blocks=21,
                     sched=SchedulerParams(preemption=True))
    rids = [srv.submit(p, max_new=24, extra_embeds=fr)
            for p, fr in zip(prompts, frames)]
    srv.run(max_iters=500)
    assert srv.stats["preemptions"] >= 1 and srv.stats["resumed"] >= 1
    dense = dataclasses.replace(tcfg, cache_layout="dense")
    for rid, p, fr in zip(rids, prompts, frames):
        ar, _ = ar_generate(dense, s.tparams, _t(p[None]), _t([len(p)]),
                            E.init_cache(dense, 1, 128, device="cpu"), 24,
                            use_kernel=True, extra_embeds=_t(fr[None]))
        req = srv.result(rid)
        assert req.status == "done" and req.output == ar[0].tolist()
    assert srv.pool.in_use == 0


def test_server_frames_and_refusals():
    """Frames are required (of the config's shape) and kept on the
    request; the prefix cache and chunked prefill are refused, with the
    reference's messages where it has them."""
    s = stack()
    srv = SpecServer(build_engine(s.tcfg, "medusa", device="cpu",
                                  use_kernel=True), s.tparams, s.tmp,
                     batch_slots=2, max_len=64)
    with pytest.raises(ValueError, match="extra_embeds"):
        srv.submit(np.arange(4, dtype=np.int32), max_new=2)
    with pytest.raises(ValueError, match="shape"):
        srv.submit(np.arange(4, dtype=np.int32), max_new=2,
                   extra_embeds=np.zeros((3, 32), np.float32))
    srv.submit(np.arange(4, dtype=np.int32), max_new=2,
               extra_embeds=s.frames[0])
    np.testing.assert_array_equal(srv.queue[0].frames, s.frames[0])
    paged = dataclasses.replace(s.cfg, cache_layout="paged", page_size=8)
    tpaged = dataclasses.replace(s.tcfg, cache_layout="paged", page_size=8)
    with pytest.raises(ValueError) as mine:
        SpecServer(build_engine(tpaged, "medusa", device="cpu"), s.tparams,
                   s.tmp, batch_slots=2, max_len=64, prefix_cache=True)
    with pytest.raises(ValueError) as ref:
        JaxSpecServer(jax_build_engine(paged, "medusa"), s.params, s.mp,
                      batch_slots=2, max_len=64, prefix_cache=True)
    assert str(mine.value) == str(ref.value)
    with pytest.raises(ValueError, match="encoder-decoder prompt"):
        SpecServer(build_engine(s.tcfg, "medusa", device="cpu"), s.tparams,
                   s.tmp, batch_slots=2, max_len=64,
                   sched=SchedulerParams(chunk_size=16))
    with pytest.raises(ValueError, match="encoder-decoder prompt"):
        JaxSpecServer(jax_build_engine(s.cfg, "medusa"), s.params, s.mp,
                      batch_slots=2, max_len=64,
                      sched=JSchedulerParams(chunk_size=16))


def test_paged_admission_and_cow_leave_cross_to_its_slot():
    """Paged batched admission of 3 requests into a 4-slot server: each
    slot's cross k/v is its own frames' (a one-row prefill's, within
    3e-5), the free slot's stays 0; a copy on write between pool blocks
    changes the self pool's rows and leaves the cross k/v bit for bit
    (a block id indexing the cross entry's batch axis would move a
    slot's rows)."""
    s = stack()
    cfg = dataclasses.replace(s.tcfg, cache_layout="paged", page_size=8)
    srv = SpecServer(build_engine(cfg, "medusa", device="cpu",
                                  use_kernel=True), s.tparams, s.tmp,
                     batch_slots=4, max_len=96)
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, 256, size=n).astype(np.int32)
               for n in (7, 12, 5)]
    _, frames = _trace(s.cfg)
    for p, fr in zip(prompts, frames):
        srv.submit(p, max_new=4, extra_embeds=fr)
    srv._admit()
    cross = srv.cache["cross"]
    owner = {i: sl.request for i, sl in enumerate(srv.slots)
             if sl.request is not None}
    assert len(owner) == 3
    dense = dataclasses.replace(s.tcfg, cache_layout="dense")
    for slot in range(4):
        if slot not in owner:
            assert not cross["k"][:, slot].any()
            continue
        req = owner[slot]
        _, one = E.prefill(s.tparams, dense, _t(req.prompt[None]),
                           _t([len(req.prompt)]),
                           E.init_cache(dense, 1, 96, device="cpu"),
                           extra_embeds=_t(req.frames[None]))
        for leaf in ("k", "v"):
            _close(cross[leaf][:, slot], one["cross"][leaf][:, 0])
    before = {n: t.clone() for n, t in cross.items()}
    pool_k = srv.cache["self"]["k"]
    src = torch.tensor([1, 2], dtype=torch.int64)
    dst = torch.tensor([3, 0], dtype=torch.int64)
    srv._copy_blocks(src, dst)
    assert torch.equal(pool_k[:, 3], pool_k[:, 1])
    for leaf in ("k", "v"):
        assert torch.equal(cross[leaf], before[leaf])


# ---------------------------------------------------------------- training

def test_lm_loss_and_grads_match_reference(monkeypatch):
    """``lm_loss`` with the frames on one decoder and one encoder layer:
    the loss within 3e-5 of the reference's ``jax.value_and_grad``, every
    gradient (the encoder's, the learned positions', the
    cross-attention's) within 1e-4 of its largest magnitude, and within
    2e-4 of the float64 gradient.  Both frameworks' float32 gradients lie
    up to ~8e-5 from float64 here (LayerNorm over the embeddings' small
    variance amplifies rounding; a second encoder layer takes both to
    ~1.5e-4), so the layers' 3e-5 is out of reach for the whole graph.
    ``lm_train_step`` runs; ``medusa_loss`` refuses the family, as the
    reference does."""
    s = stack(layers=1)
    cfg = dataclasses.replace(s.cfg, encoder_layers=1)
    tcfg = dataclasses.replace(s.tcfg, encoder_layers=1)
    params = dict(s.params, enc_units=jax.tree.map(lambda a: a[:1],
                                                   s.params["enc_units"]))
    tparams = bridge.to_torch(_np(params), device="cpu")
    rng = np.random.default_rng(6)
    seq = rng.integers(0, cfg.vocab_size, size=(B, 17)).astype(np.int32)
    x, y = seq[:, :-1], seq[:, 1:]
    (jtot, (jloss, jaux)), jg = jax.jit(
        jax.value_and_grad(JST.lm_loss, has_aux=True), static_argnums=1)(
        params, cfg, jnp.asarray(x), jnp.asarray(y), jnp.asarray(s.frames))
    (tot, (loss, aux)), g = ST.value_and_grad(
        ST.lm_loss, tparams, tcfg, _t(x), _t(y), _t(s.frames))
    for a, b in ((tot, jtot), (loss, jloss), (aux, jaux)):
        np.testing.assert_allclose(float(a), float(b), rtol=3e-5, atol=1e-7)
    f64 = {"float64": torch.float64}
    dtype_of = E.torch_dtype
    for mod in (E, L):
        monkeypatch.setattr(mod, "torch_dtype",
                            lambda n: f64.get(n) or dtype_of(n))
    _, g64 = ST.value_and_grad(
        ST.lm_loss, O.tree_map(lambda t: t.double(), tparams),
        dataclasses.replace(tcfg, dtype="float64", param_dtype="float64"),
        _t(x), _t(y), _t(s.frames).double())
    monkeypatch.undo()
    leaves = jax.tree_util.tree_leaves_with_path(jg)
    top = max(float(np.abs(np.asarray(r)).max()) for _, r in leaves)
    for path, r in leaves:
        got, exact = g, g64
        for k in path:
            got, exact = got[k.key], exact[k.key]
        if path[-1].key == "bk":
            # a key bias shifts every score of a query row alike, which
            # the softmax cancels: its gradient is 0 up to rounding
            assert float(got.abs().max()) < 1e-6 * top
            assert float(np.abs(np.asarray(r)).max()) < 1e-6 * top
            continue
        _close(got, np.asarray(r), 1e-4)
        _close(got, exact.numpy(), 2e-4)
    for leaf in (g["pos_enc"], g["frontend_proj"],
                 g["enc_units"]["attn"]["wq"],
                 g["dec_units"]["cross_attn"]["wk"]):
        assert float(leaf.abs().max()) > 0
    _, _, met = ST.lm_train_step(tparams, O.adamw_init(tparams), tcfg,
                                 _t(x), _t(y), _t(s.frames))
    assert np.isfinite(float(met["loss"])) and float(met["gnorm"]) > 0
    with pytest.raises(NotImplementedError, match="LM families"):
        ST.medusa_loss(s.tmp, s.tparams, s.tcfg, _t(seq), 3)
    with pytest.raises(NotImplementedError, match="LM families"):
        JST.medusa_loss(s.mp, s.params, s.cfg, jnp.asarray(seq), 3)


def test_forward_train_remat_matches():
    s = stack(layers=1)
    x = _t(s.tokens)
    a, aux_a = E.forward_train(s.tparams, s.tcfg, x, _t(s.frames),
                               remat=True)
    b, aux_b = E.forward_train(s.tparams, s.tcfg, x, _t(s.frames),
                               remat=False)
    assert torch.equal(a, b) and float(aux_a) == float(aux_b) == 0.0
    want, _ = JE.forward_train(s.params, s.cfg, jnp.asarray(s.tokens),
                               jnp.asarray(s.frames))
    _close(a, want)


# ---------------------------------------------------------- the capture

@pytest.mark.parametrize("name", ["dense", "int8+paged"])
def test_captured_step_counts_and_tokens(stub_cuda, counters, monkeypatch,
                                         name):
    """Through the stubbed capture (fused verify): spec and AR steps
    captured once each and replayed; tokens equal the eager engine's
    and the reference's AR; launches exact: K1 once a layer and step, K2
    once a spec step, K3 never (the reference's encdec decode keeps the
    unfused write side), one commit a spec step; the cross leaves keep
    their addresses."""
    s = stack()
    _count_on_cpu(monkeypatch)
    c = s.layout(name, fused=True)
    tok, plen, fr = _t(s.tokens), _t(s.lengths), _t(s.frames)
    runs = {}
    for graphs in (False, True):
        eng = SpecEngine(c, s.tb, use_kernel=True, device="cpu",
                         graphs=graphs)
        cache = eng.init_cache(B, S_MAX)
        ptrs = {n: t.data_ptr() for n, t in cache["cross"].items()}
        for fn in WRAPPERS.values():
            fn.launches = 0
        out, _, st = eng.generate(s.tparams, s.tmp, tok, plen, cache,
                                  MAX_NEW, extra_embeds=fr)
        ar, _ = ar_generate(eng.cfg, s.tparams, tok, plen,
                            eng.init_cache(B, S_MAX), MAX_NEW,
                            use_kernel=True, graphs=eng.step_graphs,
                            extra_embeds=fr)
        counts = {k: f.launches for k, f in WRAPPERS.items()}
        nl = c.num_layers
        assert counts == {"K1": nl * (st.steps + MAX_NEW), "K2": st.steps,
                          "K3": 0, "K4": 0 if c.paged else st.steps,
                          "K5": st.steps if c.paged else 0}
        assert all(cache["cross"][n].data_ptr() == p
                   for n, p in ptrs.items())
        runs[graphs] = (out, ar)
        if graphs:
            kept = {isinstance(carry, SpecCarry): g
                    for g, carry in eng.step_graphs.kept()}
            assert len(stub_cuda) == 2
            assert kept[True].replays == st.steps - 1
            assert kept[False].replays == MAX_NEW - 1
    want = s.jax_ar("int8" if "int8" in name else "dense")
    for out, ar in runs.values():
        np.testing.assert_array_equal(out.numpy(), want)
        np.testing.assert_array_equal(ar.numpy(), want)


# ---------------------------------------------------------------- launcher

@pytest.mark.parametrize("flags", [
    [], ["--static", "--verify-fusion"],
    ["--cache-dtype", "int8", "--cache-layout", "paged", "--page-size", "8",
     "--preemption", "--n-blocks", "30", "--verify-fusion"]],
    ids=["server", "static-fused", "paged-int8-preemption"])
def test_launcher_serves_whisper(flags):
    res = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                      "--requests", "3", "--slots", "2", "--max-new", "6",
                      "--max-len", "160"] + flags)
    assert all(r["status"] == "done" for r in res.results)
    assert len(res.frames) == 3 and res.frames[0].shape == (16, 32)
    # each answer is the AR answer on its own frames
    c = dataclasses.replace(res.cfg, cache_layout="dense", cache_dtype=(
        res.cfg.cache_dtype))
    for r, p, fr in zip(res.results, res.prompts, res.frames):
        ar, _ = ar_generate(c, res.params, _t(p[None]), _t([len(p)]),
                            E.init_cache(c, 1, 160, device="cpu"), 6,
                            use_kernel=True, extra_embeds=_t(fr[None]))
        assert list(r["output"]) == ar[0].tolist()
