"""The port's SSM and hybrid families against the JAX reference on the
CPU: mamba2-2.7b and jamba-1.5-large-398b at the reference's own reduced
configs, in float32, on the same weights (``split_params`` -> numpy ->
``bridge.to_torch``) and the same numpy-seeded inputs.

* Configs: the port's copies equal the reference's field by field, full
  and reduced, with the published dimensions; ``ONE_UNIT``, the card's
  cut of jamba, keeps its widths.  ``init_params`` has the reference's
  tree (``jax.eval_shape``), f32 and bf16; ``check_supported`` refuses
  only tensor parallelism.
* ``models/ssm.py`` function by function, within 3e-5 of each output's
  largest magnitude: ``_causal_conv``, ``ssd_chunked`` (S not a multiple
  of the chunk, with an ``initial_state``), ``mamba2_full`` (right-padded
  rows through ``valid`` / ``lengths``, the ``return_state`` tails),
  ``mamba2_decode``'s output and per-prefix states; ``softplus`` is
  ``jax.nn.softplus`` above ``F.softplus``'s threshold; ``keep`` selects
  inside the loop bit for bit what the per-prefix states give.
* One model step at a time on both archs: ``prefill``, ``decode`` and
  ``commit`` against the reference's (states within 3e-5; the attention
  rows of the hybrid too); a masked row restores its state bit for bit;
  ``decode(ssm_keep=)`` (the suffix prefill's form) equals decode + the
  materialising commit bit for bit.
* The rollback property in the port: random (gamma, acc, active)
  schedules leave each row's state within 3e-5 of the port's own T=1 AR
  over the tokens it accepted (the reference's bitwise form of this test
  fails in the reference itself: a T-token decode and T single-token
  decodes round apart); and a negative control: with the restore taken
  out of the commit's select, the schedule's masked rows drift.
* The identity matrix: spec == the port's AR == the reference's
  ``ar_generate``, token for token, on mamba2 (dense, paged) and jamba
  (dense, paged, int8, int8 + paged, no-drop capacity), Medusa-chain and
  n-gram, greedy and sampled at temperature 0, unfused and fused, jamba
  deferred; the draft proposer and n-gram against the live reference
  ``SpecEngine`` (tokens, steps, accepted sum).
* The server: the port's ``SpecServer`` equals the live reference
  ``SpecServer`` on a chunking (and, paged, preempting) adaptive-gamma
  trace: tokens, statuses and the whole stats dict, ``ssm_restores`` > 0;
  a chunked prompt on a reused slot starts from zero state (== AR);
  paged admission writes each slot's state; ``prefix_cache=True`` raises
  the reference's ``ValueError``.
* A self-draft accepts whole chains (the commit's select past the first
  token) and still equals the reference's AR.
* The stubbed capture (``test_torch_graphs.stub_cuda``): the SSM leaves
  are written in place across replays (their addresses hold), and the
  replayed tokens equal the eager engine's, launches exact.
* Training: ``lm_loss`` and its gradients against ``jax.value_and_grad``
  within 3e-5 of each leaf's largest magnitude on one mamba2 layer and on
  the four-layer stacks of both (one jamba unit), where the two
  frameworks' float32 gradients already agree that closely, so no float64
  detour is needed.
* The launchers serve and train both archs.
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
from repro.core.tree import chain_tree as jax_chain_tree
from repro.distributed.sharding import split_params
from repro.models import ssm as JS
from repro.models import transformer as JT
from repro.serving.scheduler import SpecServer as JaxSpecServer
from repro.training import steps as JST
from repro_torch import bridge
from repro_torch.configs.base import SamplingParams, SchedulerParams
from repro_torch.configs.jamba_15_large_398b import ONE_UNIT
from repro_torch.configs.registry import ALL_ARCHS, get_config
from repro_torch.core import tree as TT
from repro_torch.core.engine import (SpecCarry, SpecEngine, ar_generate,
                                     build_engine)
from repro_torch.launch import serve, train
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T
from repro_torch.serving.scheduler import SpecServer
from repro_torch.training import steps as ST
from test_torch_graphs import WRAPPERS, _count_on_cpu
from test_torch_graphs import counters, stub_cuda  # noqa: F401 (fixtures)

ARCHS = ["mamba2-2.7b", "jamba-1.5-large-398b"]
TOL = 3e-5
B, S_P, MAX_NEW, S_MAX, PS = 2, 8, 12, 96, 16
NO_DROP = 8.0          # capacity_factor >= E / K: C covers every group
_jax_init = jax.jit(JT.init_params, static_argnums=1)
_jax_decode = jax.jit(JT.decode, static_argnums=(1,))
_jax_commit = jax.jit(JT.commit, static_argnums=(0,))


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
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got / scale, want / scale, atol=tol, rtol=0)


class Stack:
    """One arch's reduced model in both frameworks at no-drop capacity:
    the reference's weights, Medusa heads on the chain seeded from the lm
    head, the same leaves in torch, and seeded right-padded prompts."""

    def __init__(self, arch):
        self.cfg = dataclasses.replace(jax_get_config(arch, reduced=True),
                                       capacity_factor=NO_DROP)
        self.tcfg = dataclasses.replace(get_config(arch, reduced=True),
                                        capacity_factor=NO_DROP)
        params, _ = split_params(_jax_init(jax.random.PRNGKey(1), self.cfg))
        self.params = params
        self.tb = TT.default_tree(self.cfg.spec_mode)
        mp, _ = split_params(JM.init_medusa(jax.random.PRNGKey(2), self.cfg,
                                            self.tb.K,
                                            base_lm_head=params["lm_head"]))
        self.mp = mp
        self.tparams = bridge.to_torch(_np(params), device="cpu")
        self.tmp = bridge.to_torch(_np(mp), device="cpu")
        rng = np.random.default_rng(4)
        self.tokens = rng.integers(0, self.cfg.vocab_size,
                                   size=(B, S_P)).astype(np.int32)
        self.lengths = np.array([S_P, 5], np.int32)
        self._ar = {}

    def layout(self, name, cfg=None, fused=False):
        dtype, layout = {"dense": ("", "dense"), "paged": ("", "paged"),
                         "int8": ("int8", "dense"),
                         "int8+paged": ("int8", "paged")}[name]
        return dataclasses.replace(cfg or self.cfg, cache_dtype=dtype,
                                   cache_layout=layout, page_size=PS,
                                   verify_fusion=fused)

    def jax_ar(self, name):
        """The reference's greedy ``ar_generate`` tokens on ``name``."""
        if name not in self._ar:
            c = self.layout(name)
            out, _ = jax_ar_generate(c, self.params, jnp.asarray(self.tokens),
                                     jnp.asarray(self.lengths),
                                     JT.init_cache(c, B, S_MAX), MAX_NEW)
            self._ar[name] = np.asarray(out)
        return self._ar[name]


_STACKS = {}


def stack(arch) -> Stack:
    if arch not in _STACKS:
        _STACKS[arch] = Stack(arch)
    return _STACKS[arch]


def _ssm_params(s, pos="pos0"):
    """Unit 0's mixer weights of position ``pos`` in both frameworks."""
    jp = jax.tree.map(lambda a: a[0], s.params["units"][pos]["ssm"])
    tp = {k: v[0] for k, v in s.tparams["units"][pos]["ssm"].items()}
    return jp, tp


# ------------------------------------------------------------------ configs

@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference(arch, reduced):
    got = dataclasses.asdict(get_config(arch, reduced=reduced))
    want = dataclasses.asdict(jax_get_config(arch, reduced=reduced))
    assert got == want
    assert arch in ALL_ARCHS


def test_published_dimensions_and_the_card_cut():
    m = get_config("mamba2-2.7b")
    assert (m.num_layers, m.d_model, m.vocab_size, m.ssm_state,
            m.ssm_head_dim, m.d_inner, m.ssm_heads, m.family,
            m.spec_mode) == (64, 2560, 50280, 128, 64, 5120, 80, "ssm",
                             "chain")
    assert m.num_ssm_layers == 64 and m.num_attn_layers == 0
    j = get_config("jamba-1.5-large-398b")
    assert (j.num_layers, j.d_model, j.num_heads, j.num_kv_heads,
            j.head_dim, j.d_ff, j.vocab_size, j.num_experts,
            j.experts_per_tok, j.hybrid_period, j.attn_index) == (
        72, 8192, 64, 8, 128, 24576, 65536, 16, 2, 8, 3)
    assert j.num_attn_layers == 9 and j.num_ssm_layers == 63
    assert T.unit_structure(ONE_UNIT) == [
        ("ssm", "dense"), ("attn", "moe"), ("ssm", "dense"), ("ssm", "moe")]
    assert T.unit_structure(ONE_UNIT) == JT.unit_structure(
        dataclasses.replace(jax_get_config("jamba-1.5-large-398b"),
                            num_layers=4, hybrid_period=4, attn_index=1))
    widths = ("d_model", "num_heads", "num_kv_heads", "head_dim", "d_ff",
              "vocab_size", "num_experts", "ssm_state", "ssm_head_dim")
    assert all(getattr(ONE_UNIT, w) == getattr(j, w) for w in widths)
    for arch in ARCHS:
        assert T.unit_structure(get_config(arch, reduced=True)) == \
            JT.unit_structure(jax_get_config(arch, reduced=True))
    with pytest.raises(ValueError, match="whole number"):
        T.n_units(dataclasses.replace(ONE_UNIT, num_layers=2))


def _shapes(tree):
    return {k: _shapes(v) if isinstance(v, dict) else
            (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in tree.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_tree_matches_reference(arch):
    """Names, shapes and dtypes of the reference's tree, in f32 and with
    bf16 parameters (the mixer's ``A_log``, ``dt_bias``, ``D`` and
    ``norm_w`` stay f32); the reference's init ranges (dt in [1e-3, 0.1],
    A in [1, 16))."""
    s = stack(arch)
    for dt in ("float32", "bfloat16"):
        jcfg = dataclasses.replace(s.cfg, param_dtype=dt)
        tcfg = dataclasses.replace(s.tcfg, param_dtype=dt)
        abstract = split_params(jax.eval_shape(
            lambda k: JT.init_params(k, jcfg), jax.random.PRNGKey(0)))[0]
        want = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)),
                            abstract)
        mine = T.init_params(torch.Generator().manual_seed(0), tcfg)
        assert _shapes(mine) == want
    p = mine["units"]["pos0"]["ssm"]
    dt0 = torch.nn.functional.softplus(p["dt_bias"])
    assert float(dt0.min()) >= 1e-3 * 0.999 and float(dt0.max()) <= 0.1001
    a = torch.exp(p["A_log"])
    assert float(a.min()) >= 1.0 and float(a.max()) < 16.0


def test_check_supported_refuses_only_tp():
    from repro_torch.models import encdec
    from repro_torch.models.api import get_model

    for arch in ARCHS:
        T.check_supported(get_config(arch))
    whisper = dataclasses.replace(get_config("mamba2-2.7b", reduced=True),
                                  family="encdec")
    T.check_supported(whisper)               # carried since its slice
    assert get_model(whisper) is encdec
    tp = dataclasses.replace(get_config("jamba-1.5-large-398b", reduced=True),
                             tp_axis="model")
    with pytest.raises(ValueError, match="dense family"):
        T.check_supported(tp)


# ------------------------------------------------------- models/ssm.py

def test_softplus_is_the_reference_formula():
    """``softplus`` is ``jax.nn.softplus`` everywhere; above
    ``F.softplus``'s threshold 20 (where it returns x) the formula's
    log1p(exp(-x)) term is below half an f32 step of x, so the two agree
    bit for bit there too."""
    x = np.array([-80.0, -20.5, -1.0, 0.0, 1e-3, 3.0, 19.9, 20.1, 25.0,
                  88.0], np.float32)
    got = S.softplus(_t(x))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jax.nn.softplus(jnp.asarray(x))),
                               rtol=1e-6, atol=0)
    assert torch.equal(got[7:], torch.nn.functional.softplus(_t(x[7:])))


def test_causal_conv_matches_reference():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 11, 24)).astype(np.float32)
    w = rng.standard_normal((24, 4)).astype(np.float32)
    b = rng.standard_normal((24,)).astype(np.float32)
    _close(S._causal_conv(_t(x), _t(w), _t(b), 4),
           JS._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), 4))


@pytest.mark.parametrize("S_len, init", [(19, False), (19, True), (8, True),
                                         (5, False)])
def test_ssd_chunked_matches_reference(S_len, init):
    """S 19 is not a multiple of the chunk 8 (the dt = 0 padding); S 5 is
    shorter than one chunk; with and without an initial state."""
    rng = np.random.default_rng(2)
    Bn, H, P, N = 2, 3, 4, 5
    x = rng.standard_normal((Bn, S_len, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((Bn, S_len, H)))).astype(
        np.float32)
    A = -rng.uniform(1, 16, (H,)).astype(np.float32)
    Bm = rng.standard_normal((Bn, S_len, N)).astype(np.float32)
    Cm = rng.standard_normal((Bn, S_len, N)).astype(np.float32)
    s0 = rng.standard_normal((Bn, H, P, N)).astype(np.float32) if init \
        else None
    jy, jf = JS.ssd_chunked(*(jnp.asarray(a) for a in (x, dt, A, Bm, Cm)),
                            8, None if s0 is None else jnp.asarray(s0))
    ty, tf = S.ssd_chunked(*(_t(a) for a in (x, dt, A, Bm, Cm)), 8,
                           None if s0 is None else _t(s0))
    _close(ty, jy)
    _close(tf, jf)
    assert tf.dtype == torch.float32


@pytest.mark.parametrize("arch", ARCHS)
def test_mamba2_full_and_decode_match_reference(arch):
    """Right-padded rows (lengths 13 and 9 of 13): the output, the conv
    tails at each row's length and the SSD state at it; then
    ``mamba2_decode`` of 5 chain tokens from those states: its output and
    every per-prefix state."""
    s = stack(arch)
    jp, tp = _ssm_params(s)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 13, s.cfg.d_model)).astype(np.float32)
    lens = np.array([13, 9], np.int32)
    valid = np.arange(13)[None, :] < lens[:, None]
    jy, jst = JS.mamba2_full(jp, jnp.asarray(x), s.cfg, return_state=True,
                             valid=jnp.asarray(valid),
                             lengths=jnp.asarray(lens))
    ty, tst = S.mamba2_full(tp, _t(x), s.tcfg, return_state=True,
                            valid=_t(valid), lengths=_t(lens))
    _close(ty, jy)
    for got, want in zip(tst, jst):
        _close(got, want)
    _close(S.mamba2_full(tp, _t(x), s.tcfg), JS.mamba2_full(
        jp, jnp.asarray(x), s.cfg))
    xd = rng.standard_normal((2, 5, s.cfg.d_model)).astype(np.float32)
    st0 = [np.asarray(a) for a in jst]
    jy, jps = JS.mamba2_decode(jp, jnp.asarray(xd), s.cfg,
                               *(jnp.asarray(a) for a in st0))
    ty, tps = S.mamba2_decode(tp, _t(xd), s.tcfg, *(_t(a) for a in st0))
    _close(ty, jy)
    for got, want in zip(tps, jps):
        assert got.shape[:2] == (2, 5)
        _close(got, want)


def test_decode_keep_selects_in_the_loop_bit_for_bit():
    """``keep`` picks, inside the loop, each row's state after that many
    tokens: bit for bit the per-prefix states' select (and the state given
    where keep is 0), with the same output."""
    s = stack("mamba2-2.7b")
    _, tp = _ssm_params(s)
    rng = np.random.default_rng(5)
    xd = _t(rng.standard_normal((4, 6, s.cfg.d_model)).astype(np.float32))
    d_in, N = s.tcfg.d_inner, s.tcfg.ssm_state
    st0 = (_t(rng.standard_normal((4, d_in, 3)).astype(np.float32)),
           _t(rng.standard_normal((4, 2 * N, 3)).astype(np.float32)),
           _t(rng.standard_normal((4, s.tcfg.ssm_heads, s.tcfg.ssm_head_dim,
                                   N)).astype(np.float32)))
    y, per = S.mamba2_decode(tp, xd, s.tcfg, *st0)
    keep = torch.tensor([0, 1, 4, 6])
    y2, kept = S.mamba2_decode(tp, xd, s.tcfg, *st0, keep=keep)
    assert torch.equal(y, y2)
    for root, states, k in zip(st0, per, kept):
        assert torch.equal(k, T.select_prefix(root, states,
                                              T.prefix_index(keep)))
        assert torch.equal(k[0], root[0])
        assert torch.equal(k[2], states[2, 3])


# -------------------------------------------------- one model step at a time

def _jt(cache):
    return jax.tree.map(np.asarray, cache)


def _ssm_leaves_close(tcache, jcache, tol=TOL):
    for pos, entry in jcache.items():
        if pos != JT.PAGES_KEY and "conv_x" in entry:
            for name in S.STATE_LEAVES:
                _close(tcache[pos][name], entry[name], tol)


def _attn_rows_close(tcache, jcache, n):
    """Every attention position's dense rows [0, n) of every unit."""
    for pos, entry in jcache.items():
        if pos != JT.PAGES_KEY and "k" in entry:
            for name in ("k", "v"):
                _close(tcache[pos][name][:, :, :n], entry[name][:, :, :n])


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_commit_match_reference(arch):
    """Dense cache: ``prefill`` (right-padded rows), one chain ``decode``
    (T 5) and a masked ``commit`` (row 1 inactive) against the
    reference's: the hidden states, every SSM state and attention row
    within 3e-5, the lengths equal; the masked row's state is its
    pre-step state bit for bit, and ``ssm_keep`` (the suffix prefill's
    form) leaves the cache bit for bit where decode + commit leave it."""
    s = stack(arch)
    c = s.layout("dense")
    tok, lens = s.tokens, s.lengths
    jlast, jcache = JT.prefill(s.params, c, jnp.asarray(tok),
                               jnp.asarray(lens), JT.init_cache(c, B, S_MAX))
    tcache = T.init_cache(c, B, S_MAX, device="cpu")
    tlast, tcache = T.prefill(s.tparams, c, _t(tok), _t(lens), tcache)
    _close(tlast, jlast)
    _ssm_leaves_close(tcache, jcache)
    _attn_rows_close(tcache, jcache, S_P)
    tb = jax_chain_tree(4)
    cand = np.random.default_rng(6).integers(0, 256, (B, 5)).astype(np.int32)
    jh, jspec = _jax_decode(s.params, c, jcache, jnp.asarray(cand),
                            jnp.asarray(lens), jnp.asarray(tb.mask),
                            jnp.asarray(tb.depths))
    root = {pos: {n: t.clone() for n, t in e.items()}
            for pos, e in tcache.items()}
    th, tspec = T.decode(s.tparams, c, tcache, _t(cand), _t(lens),
                         _t(tb.mask), _t(tb.depths))
    _close(th, jh)
    for pos, entry in root.items():       # decode left the root alone
        if not T.is_attn_entry(entry):
            for name in S.STATE_LEAVES:
                assert torch.equal(tcache[pos][name], entry[name])
                _close(torch.stack(tspec[pos][name + "_new"]),
                       jspec[pos][name])
    path = np.tile(np.arange(5, dtype=np.int32), (B, 1))
    acc = np.array([3, 2], np.int32)
    active = np.array([True, False])
    jc, jl = _jax_commit(c, jspec, jnp.asarray(lens), jnp.asarray(path),
                         jnp.asarray(acc), jnp.asarray(active))
    tc, tl = T.commit(c, tspec, _t(lens), _t(path), _t(acc), _t(active))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    _ssm_leaves_close(tc, _jt(jc))
    _attn_rows_close(tc, _jt(jc), S_P + 3)
    for pos, entry in root.items():
        if not T.is_attn_entry(entry):
            for name in S.STATE_LEAVES:
                assert torch.equal(tc[pos][name][:, 1], entry[name][:, 1])
                assert not torch.equal(tc[pos][name][:, 0], entry[name][:, 0])
    # the suffix prefill's form: decode with the commit's effective counts
    kept = {pos: {n: t.clone() for n, t in e.items()}
            for pos, e in root.items()}
    T.decode(s.tparams, c, kept, _t(cand), _t(lens), _t(tb.mask),
             _t(tb.depths), ssm_keep=torch.tensor([3, 0]))
    for pos, entry in kept.items():
        if not T.is_attn_entry(entry):
            for name in S.STATE_LEAVES:
                assert torch.equal(entry[name], tc[pos][name])


@pytest.mark.parametrize("layout", ["paged", "int8+paged"])
def test_hybrid_paged_and_int8_step_matches_reference(layout):
    """The hybrid's attention position pages and quantizes while its SSM
    positions stay per slot (activation-dtype conv state): prefill and
    one committed chain step against the reference on the paged pool
    (int8 too), hidden states and SSM states within 3e-5."""
    s = stack("jamba-1.5-large-398b")
    c = s.layout(layout)
    tok, lens = s.tokens, s.lengths
    jlast, jcache = JT.prefill(s.params, c, jnp.asarray(tok),
                               jnp.asarray(lens), JT.init_cache(c, B, S_MAX))
    tcache = T.init_cache(c, B, S_MAX, device="cpu")
    assert tcache["pos0"]["conv_x"].shape[:2] == (1, B)
    assert tcache["pos0"]["conv_x"].dtype == torch.float32
    assert tcache["pos1"]["k"].shape[1] == 1 + B * (S_MAX // PS)
    tlast, tcache = T.prefill(s.tparams, c, _t(tok), _t(lens), tcache)
    _close(tlast, jlast)
    _ssm_leaves_close(tcache, jcache)
    tb = jax_chain_tree(4)
    cand = np.random.default_rng(7).integers(0, 256, (B, 5)).astype(np.int32)
    args = (jnp.asarray(cand), jnp.asarray(lens), jnp.asarray(tb.mask),
            jnp.asarray(tb.depths))
    jh, jspec = _jax_decode(s.params, c, jcache, *args)
    th, tspec = T.decode(s.tparams, c, tcache, *(_t(np.asarray(a))
                                                 for a in args),
                         use_kernel=True)
    _close(th, jh)
    acc = np.array([2, 5], np.int32)
    path = np.tile(np.arange(5, dtype=np.int32), (B, 1))
    jc, _ = _jax_commit(c, jspec, jnp.asarray(lens), jnp.asarray(path),
                        jnp.asarray(acc), None)
    tc, _ = T.commit(c, tspec, _t(lens), _t(path), _t(acc))
    _ssm_leaves_close(tc, _jt(jc))


def test_pure_ssm_cache_has_no_rows():
    c = get_config("mamba2-2.7b", reduced=True)
    for layout in ("dense", "paged"):
        cache = T.init_cache(dataclasses.replace(c, cache_layout=layout,
                                                 page_size=PS), B, 64,
                             device="cpu")
        assert T.cache_max_len(cache) == 0 == JT.cache_max_len(
            JT.init_cache(dataclasses.replace(
                jax_get_config("mamba2-2.7b", reduced=True),
                cache_layout=layout, page_size=PS), B, 64))
    # a prompt longer than any row count prefills: there are no rows
    s = stack("mamba2-2.7b")
    long = np.random.default_rng(8).integers(0, 256, (1, 200)).astype(
        np.int32)
    jlast, _ = JT.prefill(s.params, s.cfg, jnp.asarray(long),
                          jnp.asarray([200], jnp.int32),
                          JT.init_cache(s.cfg, 1, 16))
    for layout in ("dense", "paged"):
        c = dataclasses.replace(s.tcfg, cache_layout=layout, page_size=PS)
        last, _ = T.prefill(s.tparams, c, _t(long), _t([200]),
                            T.init_cache(c, 1, 16, device="cpu"))
        _close(last, jlast)


# ------------------------------------------------- the rollback property

def _schedule_run(s, steps, seed):
    """Random chain steps with masked commits from a prefilled cache;
    returns (cache, lengths, the tokens each row accepted)."""
    c = s.tcfg
    cache = T.init_cache(c, B, S_MAX, device="cpu")
    lens = _t(np.full((B,), S_P, np.int32))
    T.prefill(s.tparams, c, _t(s.tokens), lens, cache)
    rng = np.random.default_rng(seed)
    accepted = [[] for _ in range(B)]
    for g, rawacc, actpat in steps:
        tb = TT.chain_tree(g)
        toks = rng.integers(0, c.vocab_size, (B, tb.T)).astype(np.int32)
        active = np.array([(actpat >> b) & 1 == 1 for b in range(B)])
        if not active.any():
            active[:] = True
        acc = np.full((B,), 1 + rawacc % tb.T, np.int32)
        _, spec = T.decode(s.tparams, c, cache, _t(toks), lens,
                           _t(tb.mask), _t(tb.depths))
        cache, lens = T.commit(c, spec, lens,
                               _t(np.tile(np.arange(tb.T, dtype=np.int32),
                                          (B, 1))), _t(acc), _t(active))
        for b in range(B):
            if active[b]:
                accepted[b].extend(int(t) for t in toks[b, :acc[b]])
    return cache, lens, accepted


def _ar_states(s, b, accepted):
    """Row b's state from a never-speculated run: prefill, then one T=1
    decode + commit per accepted token."""
    c = s.tcfg
    cache = T.init_cache(c, 1, S_MAX, device="cpu")
    lens = _t(np.array([S_P], np.int32))
    T.prefill(s.tparams, c, _t(s.tokens[b:b + 1]), lens, cache)
    one = TT.chain_tree(0)
    for t in accepted:
        _, spec = T.decode(s.tparams, c, cache, _t([[t]]), lens,
                           _t(one.mask), _t(one.depths))
        cache, lens = T.commit(c, spec, lens, _t([[0]]), _t([1]))
    return cache


SCHEDULES = [[(4, 3, 1), (2, 0, 3), (3, 6, 2), (1, 1, 0), (4, 5, 3)],
             [(1, 2, 2), (4, 4, 1), (2, 1, 3)],
             [(3, 0, 3), (3, 2, 1), (4, 6, 2), (2, 3, 1), (1, 0, 2)]]


@pytest.mark.parametrize("seed", range(len(SCHEDULES)))
def test_rollback_matches_the_ports_own_ar(seed):
    """Random (gamma, acc, active) schedules on mamba2: each row's state
    within 3e-5 of the port's T=1 AR over the tokens that row accepted
    (a T-token decode and T one-token decodes round apart, so not
    bitwise), its length the prompt plus those tokens."""
    s = stack("mamba2-2.7b")
    cache, lens, accepted = _schedule_run(s, SCHEDULES[seed], 17 + seed)
    for b in range(B):
        want = _ar_states(s, b, accepted[b])
        for name in S.STATE_LEAVES:
            _close(cache["pos0"][name][:, b:b + 1], want["pos0"][name].numpy())
        assert int(lens[b]) == S_P + len(accepted[b])


def test_rollback_without_the_restore_fails(monkeypatch):
    """Negative control: with the commit's select taking the chain's
    state even where the row is masked (no restore of the root), the
    masked rows absorb the dead tokens and leave the AR states far
    behind."""
    s = stack("mamba2-2.7b")
    real = T.prefix_index
    monkeypatch.setattr(T, "prefix_index", lambda eff: real(
        torch.clamp(eff, min=1)))
    cache, _, accepted = _schedule_run(s, SCHEDULES[0], 17)
    want = _ar_states(s, 1, accepted[1])
    got = cache["pos0"]["ssm"][:, 1:2].numpy()
    ref = want["pos0"]["ssm"].numpy()
    assert np.abs(got - ref).max() / np.abs(ref).max() > 100 * TOL


# ------------------------------------------------------ the identity matrix

IDENTITY = [("mamba2-2.7b", "dense"), ("mamba2-2.7b", "paged"),
            ("jamba-1.5-large-398b", "dense"),
            ("jamba-1.5-large-398b", "paged"),
            ("jamba-1.5-large-398b", "int8"),
            ("jamba-1.5-large-398b", "int8+paged")]


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("arch, layout", IDENTITY,
                         ids=[f"{a}-{lay}" for a, lay in IDENTITY])
def test_spec_equals_ar_equals_reference(arch, layout, fused):
    """Medusa on the chain and n-gram (gamma 3), greedy and sampled at
    temperature 0 (and, on jamba, the deferred write): spec == the
    port's AR == the reference's AR, token for token."""
    s = stack(arch)
    c = s.layout(layout, s.tcfg, fused)
    tok, plen = _t(s.tokens), _t(s.lengths)
    want = s.jax_ar(layout)
    ar, _ = ar_generate(c, s.tparams, tok, plen,
                        T.init_cache(c, B, S_MAX, device="cpu"), MAX_NEW,
                        use_kernel=True)
    np.testing.assert_array_equal(ar.numpy(), want)
    runs = [("medusa", "greedy", False), ("ngram", "greedy", False),
            ("medusa", "sample", False), ("ngram", "sample", False)]
    if s.cfg.family == "hybrid":
        runs.append(("medusa", "greedy", True))
    for kind, accept, deferred in runs:
        eng = build_engine(c, kind, gamma=3, use_kernel=True, device="cpu",
                           accept=accept, deferred=deferred,
                           sampling=SamplingParams(temperature=0.0), seed=3)
        out, n_out, st = eng.generate(s.tparams, s.tmp if kind == "medusa"
                                      else None, tok, plen,
                                      eng.init_cache(B, S_MAX), MAX_NEW)
        np.testing.assert_array_equal(out.numpy(), want,
                                      err_msg=f"{kind} {accept} {deferred}")
        assert (n_out == MAX_NEW).all() and st.steps <= MAX_NEW


@pytest.mark.parametrize("arch", ARCHS)
def test_chain_proposers_match_live_reference(arch):
    """The draft model (a 2-layer mamba2 sibling; jamba's draft is its
    own one-unit stack, the smallest whole unit) and the n-gram lookup
    against the reference ``SpecEngine`` with the same proposer: tokens,
    steps and the accepted sum.  The draft's SSM state is not rolled back
    with its length, as in the reference: acceptance, never tokens."""
    s = stack(arch)
    c = s.layout("dense")
    layers = 2 if s.cfg.family == "ssm" else 4
    dcfg = dataclasses.replace(c, num_layers=layers, name=c.name + "-draft")
    dparams = dict(s.params, units=jax.tree.map(lambda x: x[:layers // len(
        JT.unit_structure(c))], s.params["units"]))
    for kind in ("draft", "ngram"):
        draft = kind == "draft"
        jp = JP.make_proposer(kind, c, draft_cfg=dcfg, gamma=3)
        jout, jn, jst = JaxSpecEngine(c, proposer=jp).generate(
            s.params, dparams if draft else None, jnp.asarray(s.tokens),
            jnp.asarray(s.lengths), JT.init_cache(c, B, S_MAX), MAX_NEW)
        eng = build_engine(c, kind, draft_cfg=dcfg, gamma=3, use_kernel=True,
                           device="cpu")
        out, n_out, st = eng.generate(
            s.tparams, bridge.to_torch(_np(dparams), device="cpu")
            if draft else None, _t(s.tokens), _t(s.lengths),
            eng.init_cache(B, S_MAX), MAX_NEW)
        np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
        np.testing.assert_array_equal(out.numpy(), s.jax_ar("dense"))
        assert (st.steps, int(st.accepted_sum)) == (int(jst.steps),
                                                    int(jst.accepted_sum))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_self_draft_commits_whole_chains(arch, layout):
    """A self-draft (the target as its own draft model, gamma 3) proposes
    the target's greedy tokens: whole chains are accepted, so the commit
    selects the state after 4 tokens (not only the first), and the tokens
    still equal the reference's AR.  The draft's own SSM state advances
    by gamma + 1 tokens a step, exactly the accepted ones when the whole
    chain is accepted."""
    s = stack(arch)
    c = s.layout(layout, s.tcfg, fused=True)
    eng = build_engine(c, "draft", draft_cfg=c, gamma=3, use_kernel=True,
                       device="cpu")
    out, _, st = eng.generate(s.tparams, s.tparams, _t(s.tokens),
                              _t(s.lengths), eng.init_cache(B, S_MAX),
                              MAX_NEW)
    np.testing.assert_array_equal(out.numpy(), s.jax_ar(layout))
    assert st.steps <= -(-MAX_NEW // 4) + 1
    assert int(st.accepted_sum) > 2 * st.steps * B


# ------------------------------------------------------------------ server

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_server_matches_reference(arch, layout):
    """The reference's family serving setup (n-gram gamma 3, sampled
    acceptance with temperature-0 requests, 2 slots, chunk 16, adaptive
    gamma; paged: page 8, 17 blocks, preemption): every request's tokens
    and status and the whole stats dict equal the live reference
    ``SpecServer``'s, masked slots were restored (``ssm_restores`` > 0),
    and every answer equals the port's AR."""
    s = stack(arch)
    cfg = s.cfg
    paged = layout == "paged"
    if paged:
        cfg = dataclasses.replace(cfg, cache_layout="paged", page_size=8)
    kw = dict(batch_slots=2, max_len=128, n_blocks=17 if paged else None)
    sched = dict(chunk_size=16, adaptive_gamma=True, preemption=paged)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)).astype(np.int32)
               for n in rng.integers(4, 40, size=3)]

    def run(srv):
        rids = [srv.submit(p, max_new=MAX_NEW, temperature=0.0,
                           max_steps=200) for p in prompts]
        srv.run(max_iters=500)
        assert not srv.busy
        return [(srv.result(r).status, list(srv.result(r).output))
                for r in rids]

    jsrv = JaxSpecServer(jax_build_engine(cfg, "ngram", gamma=3,
                                          accept="sample"),
                         s.params, None, sched=JSchedulerParams(**sched),
                         **kw)
    want = run(jsrv)
    tsrv = SpecServer(build_engine(cfg, "ngram", gamma=3, accept="sample",
                                   use_kernel=True, device="cpu"),
                      s.tparams, None, sched=SchedulerParams(**sched), **kw)
    assert run(tsrv) == want
    assert tsrv.stats == jsrv.stats
    assert tsrv.stats["ssm_restores"] > 0 and tsrv.stats["chunk_calls"] > 0
    for p, (status, out) in zip(prompts, want):
        ar, _ = ar_generate(tsrv.cfg, s.tparams, _t(p[None]),
                            _t([len(p)]), T.init_cache(
                                dataclasses.replace(tsrv.cfg,
                                                    cache_layout="dense"),
                                1, 128, device="cpu"), MAX_NEW,
                            use_kernel=True)
        assert status == "done" and out == ar[0].tolist()
    if paged:
        assert tsrv.pool.in_use == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_chunked_admission_starts_from_zero_state(arch):
    """A chunked prompt admitted into a slot a finished request used
    (one slot; then two slots and five requests) starts its recurrent
    state from zero: every answer equals the port's AR at no-drop
    capacity.  (The reference's server starts the first chunk from the
    last tenant's state, and its answers there differ from its AR.)"""
    s = stack(arch)
    for slots, lens in ((1, (10, 30)), (2, (10, 30, 40, 20, 70))):
        srv = SpecServer(build_engine(s.tcfg, "ngram", gamma=3,
                                      device="cpu", use_kernel=True),
                         s.tparams, None, batch_slots=slots, max_len=128,
                         sched=SchedulerParams(chunk_size=16))
        rng = np.random.default_rng(5)
        prompts = [rng.integers(0, 256, size=n).astype(np.int32)
                   for n in lens]
        rids = [srv.submit(p, max_new=MAX_NEW) for p in prompts]
        srv.run()
        assert srv.stats["chunk_calls"] > 0
        for rid, p in zip(rids, prompts):
            ar, _ = ar_generate(s.tcfg, s.tparams, _t(p[None]),
                                _t([len(p)]),
                                T.init_cache(s.tcfg, 1, 128, device="cpu"),
                                MAX_NEW, use_kernel=True)
            assert srv.result(rid).output == ar[0].tolist(), (slots, len(p))


def test_server_refuses_the_prefix_cache():
    s = stack("jamba-1.5-large-398b")
    cfg = dataclasses.replace(s.cfg, cache_layout="paged", page_size=8)
    with pytest.raises(ValueError, match="SSM/encdec state") as mine:
        SpecServer(build_engine(cfg, "medusa", device="cpu"), s.tparams,
                   s.tmp, batch_slots=2, max_len=64, prefix_cache=True)
    with pytest.raises(ValueError) as ref:
        JaxSpecServer(jax_build_engine(cfg, "medusa"), s.params, s.mp,
                      batch_slots=2, max_len=64, prefix_cache=True)
    assert str(mine.value) == str(ref.value)


def test_paged_admission_writes_the_slots_state():
    """Paged batched admission of 3 requests into slots 2, 0, 1 of a
    4-slot server: each slot's SSM state is its own prompt's prefill
    state (within 3e-5 of a one-row prefill), the free slot's stays 0,
    and copy-on-write leaves it alone."""
    s = stack("mamba2-2.7b")
    cfg = dataclasses.replace(s.tcfg, cache_layout="paged", page_size=8)
    srv = SpecServer(build_engine(cfg, "medusa", device="cpu",
                                  use_kernel=True), s.tparams, s.tmp,
                     batch_slots=4, max_len=64)
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, 256, size=n).astype(np.int32)
               for n in (7, 12, 5)]
    for p in prompts:
        srv.submit(p, max_new=30)
    srv._admit()
    owner = {slot: list(r.prompt) for slot, r in
             ((i, sl.request) for i, sl in enumerate(srv.slots))
             if r is not None}
    assert len(owner) == 3
    for slot in range(4):
        got = srv.cache["pos0"]["ssm"][:, slot]
        if slot not in owner:
            assert not got.any()
            continue
        p = np.array(owner[slot], np.int32)
        one = T.init_cache(s.tcfg, 1, 64, device="cpu")
        T.prefill(s.tparams, s.tcfg, _t(p[None]), _t([len(p)]), one)
        _close(got, one["pos0"]["ssm"][:, 0].numpy())
    before = srv.cache["pos0"]["ssm"].clone()
    srv._copy_blocks(torch.tensor([1]), torch.tensor([2]))
    assert torch.equal(srv.cache["pos0"]["ssm"], before)


# ------------------------------------------------------ the stubbed capture

@pytest.mark.parametrize("arch, layout", [("mamba2-2.7b", "dense"),
                                          ("jamba-1.5-large-398b",
                                           "int8+paged")])
def test_captured_step_writes_ssm_state_in_place(stub_cuda, counters,
                                                 monkeypatch, arch, layout):
    """Through the stubbed capture (fused verify): the spec and AR steps
    are captured once each and replayed; every SSM leaf keeps its address
    from the first step to the last and ends with the state the eager
    engine's run leaves; the tokens equal the eager engine's; launches
    exact (K1/K3 once per attention layer and step, K2 once per spec
    step, one commit per spec step when there is an attention
    position)."""
    s = stack(arch)
    _count_on_cpu(monkeypatch)
    c = s.layout(layout, s.tcfg, fused=True)
    tok, plen = _t(s.tokens), _t(s.lengths)
    runs = {}
    for graphs in (False, True):
        eng = SpecEngine(c, s.tb, use_kernel=True, device="cpu",
                         graphs=graphs)
        cache = eng.init_cache(B, S_MAX)
        ptrs = {(pos, n): t.data_ptr() for pos, e in cache.items()
                if pos != T.PAGES_KEY and not T.is_attn_entry(e)
                for n, t in e.items()}
        for fn in WRAPPERS.values():
            fn.launches = 0
        out, _, st = eng.generate(s.tparams, s.tmp, tok, plen, cache,
                                  MAX_NEW)
        ar, _ = ar_generate(eng.cfg, s.tparams, tok, plen,
                            eng.init_cache(B, S_MAX), MAX_NEW,
                            use_kernel=True, graphs=eng.step_graphs)
        counts = {k: f.launches for k, f in WRAPPERS.items()}
        nat = c.num_attn_layers
        quant = c.resolved_cache_dtype == "int8"
        want = {"K1": nat * (st.steps + MAX_NEW), "K2": st.steps,
                "K3": 0 if quant else nat * (st.steps + MAX_NEW),
                "K4": 0, "K5": st.steps if nat and c.paged else 0}
        if nat and not c.paged:
            want["K4"], want["K5"] = st.steps, 0
        assert counts == want
        assert ptrs and all(cache[pos][n].data_ptr() == p
                            for (pos, n), p in ptrs.items())
        runs[graphs] = (out, ar, {(pos, n): cache[pos][n].clone()
                                  for (pos, n) in ptrs})
        if graphs:
            kept = {isinstance(carry, SpecCarry): g
                    for g, carry in eng.step_graphs.kept()}
            assert len(stub_cuda) == 2
            assert kept[True].replays == st.steps - 1
    (eo, ea, es), (go, ga, gs) = runs[False], runs[True]
    np.testing.assert_array_equal(go.numpy(), eo.numpy())
    np.testing.assert_array_equal(ga.numpy(), eo.numpy())
    np.testing.assert_array_equal(eo.numpy(), s.jax_ar(layout))
    for k in es:
        assert torch.equal(gs[k], es[k]), k


# ---------------------------------------------------------------- training

def _train_stack(arch, layers):
    cfg = dataclasses.replace(jax_get_config(arch, reduced=True),
                              num_layers=layers, capacity_factor=NO_DROP)
    params, _ = split_params(_jax_init(jax.random.PRNGKey(1), cfg))
    return cfg, params, bridge.to_torch(_np(params), device="cpu")


@pytest.mark.parametrize("arch, layers", [("mamba2-2.7b", 1),
                                          ("mamba2-2.7b", 4),
                                          ("jamba-1.5-large-398b", 4)])
def test_lm_loss_and_grads_match_reference(arch, layers):
    """``lm_loss`` (for jamba the MoE aux loss added) and every gradient
    leaf within 3e-5 of the reference's ``jax.value_and_grad``; remat and
    no remat give the same logits; ``lm_train_step`` runs."""
    cfg, params, tparams = _train_stack(arch, layers)
    rng = np.random.default_rng(6)
    seq = rng.integers(0, cfg.vocab_size, size=(2, 33)).astype(np.int32)
    x, y = seq[:, :-1], seq[:, 1:]
    (jtot, (jloss, jaux)), jg = jax.jit(
        jax.value_and_grad(JST.lm_loss, has_aux=True), static_argnums=1)(
        params, cfg, jnp.asarray(x), jnp.asarray(y))
    (tot, (loss, aux)), g = ST.value_and_grad(ST.lm_loss, tparams, cfg,
                                              _t(x), _t(y))
    for a, b in ((tot, jtot), (loss, jloss), (aux, jaux)):
        np.testing.assert_allclose(float(a), float(b), rtol=TOL, atol=1e-7)
    assert (float(aux) > 0) == bool(cfg.num_experts)
    for path, r in jax.tree_util.tree_leaves_with_path(jg):
        got = g
        for k in path:
            got = got[k.key]
        _close(got, np.asarray(r))
    a, _ = T.forward_train(tparams, cfg, _t(x), remat=True)
    b, _ = T.forward_train(tparams, cfg, _t(x), remat=False)
    assert torch.equal(a, b)
    if layers == 1:
        from repro_torch.training import optimizer as O
        _, _, met = ST.lm_train_step(tparams, O.adamw_init(tparams), cfg,
                                     _t(x), _t(y))
        assert np.isfinite(float(met["loss"])) and float(met["gnorm"]) > 0


# --------------------------------------------------------------- launchers

@pytest.mark.parametrize("arch, flags", [
    ("mamba2-2.7b", ["--static", "--verify-fusion"]),
    ("mamba2-2.7b", ["--proposer", "ngram", "--chunk-size", "16"]),
    ("jamba-1.5-large-398b", ["--cache-dtype", "int8", "--cache-layout",
                              "paged", "--page-size", "16"])],
    ids=["mamba2-static-fused", "mamba2-ngram-chunked", "jamba-int8-paged"])
def test_launcher_serves_ssm_and_hybrid(arch, flags):
    res = serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                      "--requests", "3", "--slots", "2", "--max-new", "6",
                      "--max-len", "96"] + flags)
    assert all(r["status"] == "done" for r in res.results)
    assert res.cfg.name == get_config(arch, reduced=True).name
    if "--chunk-size" in flags:
        assert res.server.stats["ssm_restores"] > 0


def test_train_launcher_mamba2(tmp_path):
    out = train.main(["--arch", "mamba2-2.7b", "--reduced", "--device", "cpu",
                      "--mode", "lm", "--steps", "4", "--batch", "2", "--seq",
                      "16", "--ckpt-dir", str(tmp_path), "--ckpt-every",
                      "100"])
    assert len(out["losses"]) == 4 and np.all(np.isfinite(out["losses"]))
