"""The port's MoE and VLM families against the JAX reference on the CPU:
granite-moe-1b-a400m, phi3.5-moe-42b-a6.6b and internvl2-26b, at the
reference's own reduced configs.

* Configs: the port's copies equal the reference's field by field, full
  and reduced, and carry the published dimensions; ``init_params`` has
  the reference's tree (the f32 router beside the experts, the VLM's
  ``frontend_proj``), and ``bridge.to_torch`` carries a bf16 tree's
  router across as f32 and its experts as bf16, bit for bit.
* ``layers.moe`` against the reference's ``moe`` on the same weights:
  the dispatch masks (the drops) equal exactly, on a batch that
  overflows the capacity at the config's 1.25, on a batch whose last
  group is padded (with all-zero rows, where every expert ties), in
  float32 and bfloat16; the outputs and router logits within 3e-5 (f32)
  and 2e-2 (bf16) of their largest magnitude.  ``top_k_first`` takes the
  lower index on a tie, as ``jax.lax.top_k`` does; ``_capacity`` and
  ``moe_aux_loss`` equal the reference's.
* ``frontend_prefix``, ``forward_hidden`` and ``prefill`` with
  ``extra_embeds`` against the reference (dense and paged caches).
* The engine: greedy float32 speculative tokens == the port's
  ``ar_generate`` == the reference's ``ar_generate``, token for token, at
  no-drop capacity (``capacity_factor`` 8.0, the reference's
  equivalence-test setting: C >= the group size) on granite-moe and
  phi3.5-moe and on internvl2 with ``frontend_embeds``; unfused and fused,
  greedy and sampled at temperature 0, on the dense cache and, for
  granite-moe, on int8 + paged.  At the config's 1.25 the port's
  speculative tokens equal the reference's ``SpecEngine``'s: the same
  lossy drops, reproduced.
* The draft-model and n-gram proposers on granite-moe against the live
  reference ``SpecEngine`` with the same proposer: tokens, steps and the
  accepted sum.
* Training: ``lm_loss`` (the aux loss added) and its gradients against
  ``jax.value_and_grad`` on one MoE layer, and on one VLM layer with the
  prefix's logits dropped, within 3e-5; ``lm_train_step`` runs.
* The server: the port's ``SpecServer`` equals the reference's on one
  trace of the reduced granite-moe at 1.25 (tokens, statuses, stats), and
  refuses ``extra_embeds`` as the reference does; the launchers serve and
  train the new archs; ``check_supported`` still refuses tensor
  parallelism (and, since their slices, takes the SSM, hybrid and
  encoder-decoder families).
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.core import medusa as JM
from repro.core import proposers as JP
from repro.core.engine import SpecEngine as JaxSpecEngine
from repro.core.engine import ar_generate as jax_ar_generate
from repro.core.engine import build_engine as jax_build_engine
from repro.core.tree import medusa_63 as jax_medusa_63
from repro.distributed.sharding import split_params
from repro.models import frontends as JF
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.serving.scheduler import SpecServer as JaxSpecServer
from repro.training import steps as JS
from repro_torch import bridge
from repro_torch.configs.base import SamplingParams
from repro_torch.configs.registry import ALL_ARCHS, get_config
from repro_torch.core import tree as TT
from repro_torch.core.engine import SpecEngine, ar_generate, build_engine
from repro_torch.launch import serve, train
from repro_torch.models import frontends as F
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.serving.scheduler import SpecServer
from repro_torch.training import optimizer as O
from repro_torch.training import steps as S

ARCHS = ["granite-moe-1b-a400m", "phi3.5-moe-42b-a6.6b", "internvl2-26b"]
TOL = {"float32": 3e-5, "bfloat16": 2e-2}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
B, S_P, MAX_NEW, S_MAX, PS = 2, 8, 12, 160, 16
NO_DROP = 8.0          # capacity_factor >= E / K: C covers every group
# the reference's init as one compiled call (its eager op-by-op dispatch
# takes seconds per tree on the CPU)
_jax_init = jax.jit(JT.init_params, static_argnums=1)


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


def _close(got, want, tol):
    """Within ``tol`` of the reference's largest magnitude."""
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got / scale, want / scale, atol=tol, rtol=0)


class Stack:
    """One arch's reduced model in both frameworks: the reference's
    weights, Medusa heads on the paper's 63-node tree seeded from the lm
    head, the same leaves in torch, seeded prompts and, for a VLM, the
    reference's stub frontend embeddings."""

    def __init__(self, arch):
        self.cfg = jax_get_config(arch, reduced=True)
        self.tcfg = get_config(arch, reduced=True)
        params, _ = split_params(_jax_init(jax.random.PRNGKey(1), self.cfg))
        self.params = params
        self.tb = TT.medusa_63()
        mp, _ = split_params(JM.init_medusa(jax.random.PRNGKey(2), self.cfg,
                                            self.tb.K,
                                            base_lm_head=params["lm_head"]))
        self.mp = mp
        self.tparams = bridge.to_torch(_np(params), device="cpu")
        self.tmp = bridge.to_torch(_np(mp), device="cpu")
        rng = np.random.default_rng(4)
        self.tokens = rng.integers(0, self.cfg.vocab_size,
                                   size=(B, S_P)).astype(np.int32)
        F_len = self.cfg.frontend_len if self.cfg.frontend else 0
        self.lengths = np.array([S_P, 6], np.int32) + F_len
        self.extra = None
        if self.cfg.frontend:
            self.extra = np.asarray(JF.frontend_embeds(
                self.cfg, B, key=jax.random.PRNGKey(3)))
        self._ar = {}

    def jextra(self):
        return None if self.extra is None else jnp.asarray(self.extra)

    def textra(self):
        return None if self.extra is None else _t(self.extra)

    def layout(self, name, cfg=None, fused=False, cf=NO_DROP):
        dtype, layout = {"dense": ("", "dense"),
                         "int8+paged": ("int8", "paged")}[name]
        return dataclasses.replace(cfg or self.cfg, cache_dtype=dtype,
                                   cache_layout=layout, page_size=PS,
                                   verify_fusion=fused, capacity_factor=cf)

    def jax_ar(self, name):
        """The reference's greedy ``ar_generate`` tokens on ``name`` at
        no-drop capacity."""
        if name not in self._ar:
            c = self.layout(name)
            out, _ = jax_ar_generate(c, self.params, jnp.asarray(self.tokens),
                                     jnp.asarray(self.lengths),
                                     JT.init_cache(c, B, S_MAX), MAX_NEW,
                                     extra_embeds=self.jextra())
            self._ar[name] = np.asarray(out)
        return self._ar[name]


_STACKS = {}


def stack(arch) -> Stack:
    if arch not in _STACKS:
        _STACKS[arch] = Stack(arch)
    return _STACKS[arch]


# ------------------------------------------------------------------ configs

@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference(arch, reduced):
    got = dataclasses.asdict(get_config(arch, reduced=reduced))
    want = dataclasses.asdict(jax_get_config(arch, reduced=reduced))
    assert got == want
    assert arch in ALL_ARCHS


@pytest.mark.parametrize("arch, dims", [
    ("granite-moe-1b-a400m", (24, 1024, 16, 8, 64, 512, 49155, 32, 8, "")),
    ("phi3.5-moe-42b-a6.6b", (32, 4096, 32, 8, 128, 6400, 32064, 16, 2, "")),
    ("internvl2-26b", (48, 6144, 48, 8, 128, 16384, 92553, 0, 0, "vit")),
])
def test_published_dimensions(arch, dims):
    c = get_config(arch)
    assert (c.num_layers, c.d_model, c.num_heads, c.num_kv_heads,
            c.resolved_head_dim, c.d_ff, c.vocab_size, c.num_experts,
            c.experts_per_tok, c.frontend) == dims
    assert c.capacity_factor == 1.25 and c.spec_mode == "tree"
    if c.frontend:
        assert (c.frontend_len, c.frontend_dim) == (256, 6144)
    r = get_config(arch, reduced=True)
    # granite's REDUCED keeps 8 experts, top 4 (the reference's override)
    want = {"granite-moe-1b-a400m": (8, 4),
            "phi3.5-moe-42b-a6.6b": (4, 2)}.get(arch, (0, 0))
    assert (r.num_experts, r.experts_per_tok) == want


def _shapes(tree):
    return {k: _shapes(v) if isinstance(v, dict) else
            (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in tree.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_tree_matches_reference(arch):
    """The port's ``init_params`` has the reference's tree, shapes and
    dtypes (``jax.eval_shape`` of the reference's init), in f32 and with
    bf16 parameters, where the router stays f32; the bridge carries a
    bf16 tree (the router f32 beside bf16 experts) leaf for leaf, bit for
    bit."""
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
        # the reference's tree in that dtype, each leaf cast as its init
        # would make it
        np_tree = jax.tree.map(
            lambda a, w: np.asarray(a).astype(w.dtype), s.params, abstract)
        carried = bridge.to_torch(np_tree, device="cpu")
        assert _shapes(carried) == want
        ffn = carried["units"]["pos0"]["ffn"]
        if s.cfg.num_experts:
            assert ffn["router"].dtype == torch.float32
            assert ffn["wi"].dtype == TDT[dt]
            np.testing.assert_array_equal(
                ffn["wo"].float().numpy(),
                np_tree["units"]["pos0"]["ffn"]["wo"].astype(np.float32))
        assert ("frontend_proj" in mine) == bool(s.cfg.frontend)
    # the experts' init scale is the reference's fan-in (d for wi, f for wo)
    if s.cfg.num_experts:
        big = dataclasses.replace(s.tcfg, num_layers=1, d_ff=512)
        ffn = T.init_params(torch.Generator().manual_seed(0),
                            big)["units"]["pos0"]["ffn"]
        assert abs(float(ffn["wi"].std()) * big.d_model ** 0.5 - 1) < 0.05
        assert abs(float(ffn["wo"].std()) * big.d_ff ** 0.5 - 1) < 0.05


def test_check_supported_refuses_the_rest():
    from repro_torch.models import encdec
    from repro_torch.models.api import get_model

    for arch in ("mamba2-2.7b", "jamba-1.5-large-398b", "whisper-tiny"):
        cfg = jax_get_config(arch, reduced=True)
        tcfg = dataclasses.replace(get_config("granite-moe-1b-a400m",
                                              reduced=True),
                                   family=cfg.family)
        # each carried since its slice; the encoder-decoder goes to its
        # own module
        T.check_supported(tcfg)
        assert (get_model(tcfg) is encdec) == (cfg.family == "encdec")
    tp = dataclasses.replace(get_config("internvl2-26b", reduced=True),
                             tp_axis="model")
    with pytest.raises(ValueError, match="dense family"):
        T.check_supported(tp)
    for arch in ARCHS:
        T.check_supported(get_config(arch))


# ------------------------------------------------------------------ the MoE

class _Recorder(types.SimpleNamespace):
    """Stands in for ``jnp`` inside the reference's ``layers`` module:
    records the operands of each einsum spec (the dispatch tensor is the
    first operand of ``gsec,gsd->egcd``) and delegates everything."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    def einsum(self, spec, *ops, **kw):
        self.seen[spec] = ops
        return jnp.einsum(spec, *ops, **kw)


def _moe_inputs(case, d):
    rng = np.random.default_rng(11)
    if case == "overflow":
        # one group of 512 tokens sharing a direction, so the router
        # prefers the same experts for most of them and queues overflow
        x = rng.standard_normal((4, 128, d)) + 3 * rng.standard_normal(d)
    else:
        # 3 x 300 tokens: groups of 512, the second padded by 124 zero rows;
        # and all-zero rows among the tokens, where every expert ties
        x = rng.standard_normal((3, 300, d))
        x[1, 5:9] = 0
    return x.astype(np.float32)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["overflow", "padded"])
def test_moe_matches_reference(monkeypatch, case, dt):
    s = stack("granite-moe-1b-a400m")
    jp = jax.tree.map(lambda a: a[0], s.params["units"]["pos0"]["ffn"])
    tp = {k: v[0] for k, v in s.tparams["units"]["pos0"]["ffn"].items()}
    x = _moe_inputs(case, s.cfg.d_model)
    rec = _Recorder(seen={})
    monkeypatch.setattr(JL, "jnp", rec)

    def reference(p, xs):
        y, r = JL.moe(p, xs, s.cfg)
        return y, r, rec.seen["gsec,gsd->egcd"][0]

    # one compiled call: the recorder sees the dispatch as a traced value
    # and the call returns it
    jy, jr, jd = jax.jit(reference)(jp, jnp.asarray(x, dt))
    monkeypatch.undo()
    seen = {}

    def dispatch_of(dispatch, xg):
        seen["dispatch"] = dispatch
        return torch.einsum("gsec,gsd->egcd", dispatch, xg)

    monkeypatch.setattr(L, "moe_dispatch", dispatch_of)
    ty, tr = L.moe(tp, _t(x).to(TDT[dt]), s.tcfg)
    jd = np.asarray(jd, np.float32)
    td = seen["dispatch"].float().numpy()
    np.testing.assert_array_equal(td, jd)          # the same drops
    n_tok = x.shape[0] * x.shape[1]
    kept = int(td.sum())
    K = s.cfg.experts_per_tok
    if case == "overflow":
        assert kept < n_tok * K                    # assignments dropped
    else:
        # two groups, the second padded by 124 zero rows; the zero rows
        # all tie onto experts 0..K-1 and overflow their queues
        assert td.shape[0] == 2 and kept < (n_tok + 124) * K
        assert td[1, -124:].sum() < 124 * K
    _close(ty, np.asarray(jy, np.float32), TOL[dt])
    _close(tr, np.asarray(jr), TOL["float32"])
    assert tr.dtype == torch.float32 and ty.dtype == TDT[dt]


def test_top_k_ties_take_the_lower_index():
    zero = np.zeros((3, 5, 8), np.float32)
    probs = jax.nn.softmax(jnp.asarray(zero), axis=-1)
    jv, ji = jax.lax.top_k(probs, 4)
    tv, ti = L.top_k_first(torch.softmax(_t(zero), dim=-1), 4)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ti[0, 0].numpy(), [0, 1, 2, 3])
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    # partial ties among distinct values
    x = np.array([[0.1, 0.3, 0.3, 0.05, 0.3, 0.1]], np.float32)
    _, ji = jax.lax.top_k(jnp.asarray(x), 4)
    _, ti = L.top_k_first(_t(x), 4)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


@pytest.mark.parametrize("args", [(512, 8, 32, 1.25), (256, 8, 32, 1.25),
                                  (64, 2, 16, 1.25), (3, 2, 4, 1.25),
                                  (512, 2, 16, 8.0), (100, 4, 8, 1.0)])
def test_capacity_matches_reference(args):
    assert L._capacity(*args) == JL._capacity(*args)


def test_moe_aux_loss_matches_reference():
    rng = np.random.default_rng(2)
    r = rng.standard_normal((3, 40, 8)).astype(np.float32)
    r[0, :4] = 0                         # ties: top-1 takes expert 0
    got = L.moe_aux_loss(_t(r))
    want = JL.moe_aux_loss(jnp.asarray(r))
    np.testing.assert_allclose(float(got), float(want), rtol=3e-6)


# --------------------------------------------------------- the VLM prefix

def test_frontend_embeds_shape_and_draws():
    c = get_config("internvl2-26b", reduced=True)
    e = F.frontend_embeds(c, 3, torch.Generator().manual_seed(7))
    assert e.shape == (3, 8, 32) and e.dtype == torch.float32
    again = F.frontend_embeds(c, 3, torch.Generator().manual_seed(7))
    assert torch.equal(e, again) and 0.01 < float(e.std()) < 0.03
    assert F.frontend_shape(c, 2) == JF.frontend_shape(
        jax_get_config("internvl2-26b", reduced=True), 2)
    assert F.frontend_embeds(get_config("granite-moe-1b-a400m"), 2) is None
    with pytest.raises(RuntimeError, match="no CUDA device"):
        F.frontend_embeds(c, 1)         # the default generator is the card's


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_frontend_prefix_and_forward_hidden(dt):
    s = stack("internvl2-26b")
    jc = dataclasses.replace(s.cfg, dtype=dt)
    tc = dataclasses.replace(s.tcfg, dtype=dt)
    jx = JT.frontend_prefix(s.params, jc, s.jextra())
    tx = T.frontend_prefix(s.tparams, tc, s.textra())
    assert tx.dtype == TDT[dt]
    _close(tx, np.asarray(jx, np.float32), TOL[dt])
    if dt == "float32":
        jh, _ = JT.forward_hidden(s.params, jc, jnp.asarray(s.tokens),
                                  s.jextra())
        th, aux = T.forward_hidden(s.tparams, tc, _t(s.tokens), s.textra())
        assert th.shape == (B, s.cfg.frontend_len + S_P, s.cfg.d_model)
        _close(th, np.asarray(jh), TOL[dt])
        assert float(aux) == 0.0


@pytest.mark.parametrize("layout", ["dense", "int8+paged"])
def test_prefill_with_extra_embeds_matches_reference(layout):
    """internvl2 reduced: the prefix takes rows 0..F-1; the last hidden
    rows and every cache row within 3e-5 (int8: the codes may differ by
    one step where the scale rounds apart, so the dequantized rows are
    held)."""
    s = stack("internvl2-26b")
    c = s.layout(layout)
    jlast, jcache = JT.prefill(s.params, c, jnp.asarray(s.tokens),
                               jnp.asarray(s.lengths),
                               JT.init_cache(c, B, S_MAX),
                               extra_embeds=s.jextra())
    tlast, tcache = T.prefill(s.tparams, c, _t(s.tokens), _t(s.lengths),
                              T.init_cache(c, B, S_MAX, device="cpu"),
                              extra_embeds=s.textra())
    _close(tlast, np.asarray(jlast), TOL["float32"])
    jk, jv = JT._read_cache({n: a[0] for n, a in jcache["pos0"].items()},
                            jnp.float32,
                            table=jcache.get(JT.PAGES_KEY, {}).get("table"))
    tk, tv = T._read_cache({n: a[0] for n, a in tcache["pos0"].items()},
                           torch.float32,
                           table=tcache.get(T.PAGES_KEY, {}).get("table"))
    n = s.cfg.frontend_len + S_P
    _close(tk[:, :n], np.asarray(jk)[:, :n], TOL["float32"] * 2 ** 7)
    _close(tv[:, :n], np.asarray(jv)[:, :n], TOL["float32"] * 2 ** 7)
    if layout == "dense":
        _close(tk[:, :n], np.asarray(jk)[:, :n], TOL["float32"])


# ------------------------------------------------------------------ engine

ENGINE_CASES = [("granite-moe-1b-a400m", "dense"),
                ("granite-moe-1b-a400m", "int8+paged"),
                ("phi3.5-moe-42b-a6.6b", "dense"),
                ("internvl2-26b", "dense")]


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("arch, layout", ENGINE_CASES,
                         ids=[f"{a}-{lay}" for a, lay in ENGINE_CASES])
def test_spec_equals_ar_equals_reference(arch, layout, fused):
    """At no-drop capacity: port spec == port AR == the reference's AR."""
    s = stack(arch)
    c = s.layout(layout, s.tcfg, fused)
    eng = SpecEngine(c, s.tb, use_kernel=True, device="cpu")
    tok, plen = _t(s.tokens), _t(s.lengths)
    out, n_out, st = eng.generate(s.tparams, s.tmp, tok, plen,
                                  eng.init_cache(B, S_MAX), MAX_NEW,
                                  extra_embeds=s.textra())
    ar, _ = ar_generate(c, s.tparams, tok, plen, eng.init_cache(B, S_MAX),
                        MAX_NEW, use_kernel=True, extra_embeds=s.textra())
    np.testing.assert_array_equal(out.numpy(), ar.numpy())
    np.testing.assert_array_equal(out.numpy(), s.jax_ar(layout))
    assert (n_out == MAX_NEW).all() and st.steps <= MAX_NEW


@pytest.mark.parametrize("arch, fused", [("granite-moe-1b-a400m", True),
                                         ("internvl2-26b", False)])
def test_sampled_temperature_zero_is_greedy(arch, fused):
    s = stack(arch)
    c = s.layout("dense", s.tcfg, fused)
    eng = SpecEngine(c, s.tb, use_kernel=True, device="cpu",
                     accept="sample",
                     sampling=SamplingParams(temperature=0.0), seed=3)
    out, n_out, _ = eng.generate(s.tparams, s.tmp, _t(s.tokens),
                                 _t(s.lengths), eng.init_cache(B, S_MAX),
                                 MAX_NEW, extra_embeds=s.textra())
    np.testing.assert_array_equal(out.numpy(), s.jax_ar("dense"))
    assert (n_out == MAX_NEW).all()


def test_lossy_capacity_matches_reference_spec():
    """At the config's 1.25 the verify forward drops assignments that AR
    does not, so spec need not equal AR; it must equal the reference's
    spec, token for token, with the same steps and accepted sum."""
    s = stack("granite-moe-1b-a400m")
    c = s.layout("dense", cf=1.25)
    assert c.capacity_factor == s.cfg.capacity_factor
    je = JaxSpecEngine(c, jax_medusa_63())
    jout, jn, jst = je.generate(s.params, s.mp, jnp.asarray(s.tokens),
                                jnp.asarray(s.lengths),
                                JT.init_cache(c, B, S_MAX), MAX_NEW)
    eng = SpecEngine(c, s.tb, use_kernel=True, device="cpu")
    out, n_out, st = eng.generate(s.tparams, s.tmp, _t(s.tokens),
                                  _t(s.lengths), eng.init_cache(B, S_MAX),
                                  MAX_NEW)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(n_out.numpy(), np.asarray(jn))
    assert (st.steps, int(st.accepted_sum)) == (int(jst.steps),
                                                int(jst.accepted_sum))


@pytest.mark.parametrize("kind", ["draft", "ngram"])
def test_chain_proposers_match_live_reference(kind):
    """granite-moe at no-drop capacity, gamma 3: the draft (a 2-layer MoE
    sibling made of the target's first two layers) and the n-gram
    lookup against the reference ``SpecEngine`` with the same proposer."""
    s = stack("granite-moe-1b-a400m")
    c = s.layout("dense")
    draft = kind == "draft"
    dcfg = dataclasses.replace(c, num_layers=2, name=c.name + "-draft")
    dparams = dict(s.params, units=jax.tree.map(lambda x: x[:2],
                                                s.params["units"]))
    jp = JP.make_proposer(kind, c, draft_cfg=dcfg, gamma=3)
    jout, jn, jst = JaxSpecEngine(c, proposer=jp).generate(
        s.params, dparams if draft else None, jnp.asarray(s.tokens),
        jnp.asarray(s.lengths), JT.init_cache(c, B, S_MAX), MAX_NEW)
    eng = build_engine(c, kind, draft_cfg=dcfg, gamma=3, use_kernel=True,
                       device="cpu")
    assert eng.proposer.q_kind == ("logits" if draft else "mprob")
    out, n_out, st = eng.generate(
        s.tparams, bridge.to_torch(_np(dparams), device="cpu")
        if draft else None, _t(s.tokens), _t(s.lengths),
        eng.init_cache(B, S_MAX), MAX_NEW)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(out.numpy(), s.jax_ar("dense"))
    assert (st.steps, int(st.accepted_sum)) == (int(jst.steps),
                                                int(jst.accepted_sum))


def test_vlm_draft_prefills_its_own_frontend():
    """internvl2: the draft is a 2-layer VLM sibling with a
    ``frontend_proj`` of its own; primed with the prefix, it proposes
    from it (its cache holds the prefix rows) and spec == AR."""
    s = stack("internvl2-26b")
    c = s.layout("dense")
    eng = build_engine(c, "draft", gamma=3, use_kernel=True, device="cpu")
    assert eng.proposer.dc.frontend == "vit"
    dparams = T.init_params(torch.Generator().manual_seed(9),
                            eng.proposer.dc)
    assert "frontend_proj" in dparams
    out, _, _ = eng.generate(s.tparams, dparams, _t(s.tokens), _t(s.lengths),
                             eng.init_cache(B, S_MAX), MAX_NEW,
                             extra_embeds=s.textra())
    np.testing.assert_array_equal(out.numpy(), s.jax_ar("dense"))
    state = eng.init_proposer_state(B, S_MAX)
    cache = eng.init_cache(B, S_MAX)
    _, _, _, state = eng.prefill(s.tparams, dparams, _t(s.tokens),
                                 _t(s.lengths), cache,
                                 extra_embeds=s.textra(), state=state)
    np.testing.assert_array_equal(state["len"].numpy(), s.lengths)
    F_len = s.cfg.frontend_len
    assert state["cache"]["pos0"]["k"][:, :, :F_len].abs().sum() > 0


# ---------------------------------------------------------------- training

def _one_layer(arch):
    cfg = dataclasses.replace(jax_get_config(arch, reduced=True),
                              num_layers=1)
    params, _ = split_params(_jax_init(jax.random.PRNGKey(1), cfg))
    return cfg, params, bridge.to_torch(_np(params), device="cpu")


def _grads_close(g, jg):
    for path, r in jax.tree_util.tree_leaves_with_path(jg):
        got = g
        for k in path:
            got = got[k.key]
        _close(got, np.asarray(r), TOL["float32"])


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "internvl2-26b"])
def test_lm_loss_and_grads_match_reference(arch):
    """``lm_loss`` on one layer: the total, the loss and the aux loss
    (the MoE's load-balance term, > 0; 0 for the VLM) and every gradient
    within 3e-5 of the reference's ``jax.value_and_grad``; the VLM's
    logits at the prefix positions are dropped before the loss."""
    cfg, params, tparams = _one_layer(arch)
    rng = np.random.default_rng(6)
    seq = rng.integers(0, cfg.vocab_size, size=(2, 33)).astype(np.int32)
    x, y = seq[:, :-1], seq[:, 1:]
    extra = (np.asarray(JF.frontend_embeds(cfg, 2, jax.random.PRNGKey(5)))
             if cfg.frontend else None)
    (jtot, (jloss, jaux)), jg = jax.jit(
        jax.value_and_grad(JS.lm_loss, has_aux=True), static_argnums=1)(
        params, cfg, jnp.asarray(x), jnp.asarray(y),
        None if extra is None else jnp.asarray(extra))
    (tot, (loss, aux)), g = S.value_and_grad(
        S.lm_loss, tparams, cfg, _t(x), _t(y),
        None if extra is None else _t(extra))
    for a, b in ((tot, jtot), (loss, jloss), (aux, jaux)):
        np.testing.assert_allclose(float(a), float(b), rtol=3e-5, atol=1e-7)
    assert (float(aux) > 0) == bool(cfg.num_experts)
    _grads_close(g, jg)
    if cfg.frontend:
        assert float(g["frontend_proj"].abs().max()) > 0
    p, o, met = S.lm_train_step(tparams, O.adamw_init(tparams), cfg, _t(x),
                                _t(y), None if extra is None else _t(extra))
    assert np.isfinite(float(met["loss"])) and float(met["gnorm"]) > 0


def test_forward_train_remat_matches():
    cfg, _, tparams = _one_layer("granite-moe-1b-a400m")
    x = _t(np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 16)))
    a, aux_a = T.forward_train(tparams, cfg, x, remat=True)
    b, aux_b = T.forward_train(tparams, cfg, x, remat=False)
    assert torch.equal(a, b) and torch.equal(aux_a, aux_b)
    assert float(aux_a) > 0


# ------------------------------------------------------------------ server

def test_server_matches_reference_moe():
    """One trace on reduced granite-moe at its 1.25 (3 slots, batched
    admission, a budget-cancelled request): tokens, statuses and stats
    equal the reference ``SpecServer``'s."""
    s = stack("granite-moe-1b-a400m")
    rng = np.random.default_rng(11)
    ps = [rng.integers(0, 256, size=n).astype(np.int32)
          for n in (5, 40, 9, 30, 17)]
    reqs = [(ps[0], 10, {}), (ps[1], 8, {}), (ps[2], 12, {}),
            (ps[3], 6, {}), (ps[4], 20, dict(max_steps=2))]
    kw = dict(batch_slots=3, max_len=128)
    jsrv = JaxSpecServer(jax_build_engine(s.cfg, "medusa"), s.params, s.mp,
                         **kw)
    tsrv = SpecServer(build_engine(s.cfg, "medusa", device="cpu",
                                   use_kernel=True), s.tparams, s.tmp, **kw)

    def run(srv):
        rids = [srv.submit(p, max_new=n, **k) for p, n, k in reqs]
        srv.run()
        return [(srv.result(r).status, list(srv.result(r).output))
                for r in rids]

    want = run(jsrv)
    assert run(tsrv) == want
    assert tsrv.stats == jsrv.stats
    assert [st for st, _ in want].count("cancelled") == 1


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "internvl2-26b"])
def test_server_refuses_extra_embeds(arch):
    s = stack(arch)
    srv = SpecServer(build_engine(s.tcfg, "medusa", device="cpu",
                                  use_kernel=True), s.tparams, s.tmp,
                     batch_slots=2, max_len=64)
    with pytest.raises(ValueError, match="encdec-only"):
        srv.submit(s.tokens[0], max_new=4,
                   extra_embeds=np.zeros((8, 32), np.float32))
    jsrv = JaxSpecServer(jax_build_engine(s.cfg, "medusa"), s.params, s.mp,
                         batch_slots=2, max_len=64)
    with pytest.raises(ValueError, match="encdec-only"):
        jsrv.submit(s.tokens[0], max_new=4,
                    extra_embeds=np.zeros((8, 32), np.float32))


@pytest.mark.parametrize("arch, flags", [
    ("granite-moe-1b-a400m", ["--static", "--verify-fusion"]),
    ("internvl2-26b", [])], ids=["granite-moe-static-fused", "vlm-server"])
def test_launcher_serves_new_archs(arch, flags):
    res = serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                      "--requests", "3", "--slots", "2", "--max-new", "6",
                      "--max-len", "160"] + flags)
    assert all(r["status"] == "done" for r in res.results)
    assert res.cfg.name == get_config(arch, reduced=True).name


def test_train_launcher_moe(tmp_path):
    out = train.main(["--arch", "granite-moe-1b-a400m", "--reduced",
                      "--device", "cpu", "--mode", "lm", "--steps", "4",
                      "--batch", "2", "--seq", "16", "--ckpt-dir",
                      str(tmp_path), "--ckpt-every", "100"])
    assert len(out["losses"]) == 4 and np.all(np.isfinite(out["losses"]))
