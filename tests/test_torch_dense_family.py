"""The port's other dense decoders against the JAX reference on the CPU:
granite-8b, qwen1.5-0.5b, qwen1.5-4b and gemma-2b, at the reference's own
reduced configs.

* Configs: the port's copies equal the reference's field by field, full
  and reduced, and carry the published dimensions.
* Layers: ``_project_qkv`` with QKV biases (qwen), and gemma's tied
  ``embed_tokens`` (scaled by sqrt(d) in the activation dtype) and
  ``unembed`` (through ``embed.T``), against JAX.  The reference
  initialises the biases to zeros, which would prove nothing: the tests
  draw them from a seed with numpy, at 0.1 scale, and set the same values
  in both trees.
* Engine: greedy float32 speculative tokens == the port's ``ar_generate``
  == the reference's ``ar_generate``, token for token, unfused and with
  verify fusion (the plain versions of K1-K4 on the CPU), on the dense
  cache for all four, and on the int8, paged and int8 + paged caches for
  qwen1.5-0.5b and gemma-2b; sampled at temperature 0 on gemma-2b with
  verify fusion (K2's sampled walk over the tied table) == greedy.
* K2 over a tied model's table: the plain version over the [V, d] table's
  transposed view gives what the reference's Pallas kernel (interpret
  mode) gives over ``embed.T``, and the kernel's operand is the table's
  own storage (no copy).
* The kernels' plans at the new shapes, as pure Python: ``decode_plan``
  at gemma's single KV head (R 512 and 8) and qwen1.5-0.5b's 16,
  ``qkv_plan`` at head_dim 256 (wgmma, a block that fits shared memory),
  ``stats_plan`` over a [V, d] table.
* The launcher answers its requests on the CPU with ``--arch``.

Tolerances are the reference kernel tests': 3e-5 for float32, 2e-2 for
bfloat16.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.core import medusa as JM
from repro.core.engine import ar_generate as jax_ar_generate
from repro.distributed.sharding import split_params
from repro.kernels import ops as JO
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.models.api import get_model as jax_get_model
from repro_torch import bridge
from repro_torch.configs.base import SamplingParams
from repro_torch.configs.registry import ALL_ARCHS, get_config
from repro_torch.core import tree as TT
from repro_torch.core.engine import SpecEngine, ar_generate
from repro_torch.kernels import cache_update as CU
from repro_torch.kernels import tree_attention as TA
from repro_torch.launch import serve
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

ARCHS = ["granite-8b", "qwen1.5-0.5b", "qwen1.5-4b", "gemma-2b"]
TOL = {"float32": 3e-5, "bfloat16": 2e-2}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
B, S_P, MAX_NEW, S_MAX, PS = 2, 8, 16, 256, 16
LAYOUTS = {"dense": ("", "dense"), "int8": ("int8", "dense"),
           "paged": ("", "paged"), "int8+paged": ("int8", "paged")}
# (arch, layout): every arch on the dense cache, the two archs the
# reference's serving examples and equivalence tests run on every layout
ENGINE_CASES = [(a, "dense") for a in ARCHS] + [
    (a, lay) for a in ("qwen1.5-0.5b", "gemma-2b")
    for lay in ("int8", "paged", "int8+paged")]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module's torch work: the suite runs in
    several workers on a few cores, and each worker's default pool
    oversubscribes them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _with_biases(np_params, seed):
    """The numpy tree with every attention bias drawn from ``seed`` at 0.1
    scale (the reference initialises them to zeros)."""
    attn = np_params["units"]["pos0"]["attn"]
    rng = np.random.default_rng(seed)
    for name in ("bq", "bk", "bv"):
        if name in attn:
            attn[name] = (rng.standard_normal(attn[name].shape) * 0.1
                          ).astype(attn[name].dtype)
    return np_params


class Stack:
    """One arch's reduced model in both frameworks: the reference's
    weights (random biases set), its Medusa heads seeded from the
    unembedding weight, the same leaves in torch, and seeded prompts."""

    def __init__(self, arch):
        self.cfg = jax_get_config(arch, reduced=True)
        self.tcfg = get_config(arch, reduced=True)
        params, _ = split_params(jax_get_model(self.cfg).init_params(
            jax.random.PRNGKey(1), self.cfg))
        np_params = _with_biases(jax.tree.map(np.asarray, params), 5)
        self.params = jax.tree.map(jnp.asarray, np_params)
        lm = self.params.get("lm_head")
        if lm is None:
            lm = self.params["embed"].T
        self.tb = TT.medusa_63()
        mp, _ = split_params(JM.init_medusa(jax.random.PRNGKey(2), self.cfg,
                                            self.tb.K, base_lm_head=lm))
        self.mp = mp
        self.tparams = bridge.to_torch(np_params, device="cpu")
        self.tmp = bridge.to_torch(jax.tree.map(np.asarray, mp),
                                   device="cpu")
        # prompts on which every arch's random model accepts multi-token
        # paths, so the commit of longer paths runs
        rng = np.random.default_rng(4)
        self.tokens = rng.integers(0, self.cfg.vocab_size,
                                   size=(B, S_P)).astype(np.int32)
        self.lengths = np.array([S_P, 6], np.int32)
        self._ar = {}

    def layout(self, name, cfg=None, fused=False):
        dtype, layout = LAYOUTS[name]
        return dataclasses.replace(cfg or self.cfg, cache_dtype=dtype,
                                   cache_layout=layout, page_size=PS,
                                   verify_fusion=fused)

    def jax_ar(self, name):
        """The reference's greedy ``ar_generate`` tokens on ``name``."""
        if name not in self._ar:
            c = self.layout(name)
            out, _ = jax_ar_generate(c, self.params,
                                     jnp.asarray(self.tokens),
                                     jnp.asarray(self.lengths),
                                     jax_get_model(c).init_cache(c, B, S_MAX),
                                     MAX_NEW)
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
    ("granite-8b", (36, 4096, 32, 8, 128, 14336, 49152, False, False)),
    ("qwen1.5-0.5b", (24, 1024, 16, 16, 64, 2816, 151936, True, False)),
    ("qwen1.5-4b", (40, 2560, 20, 20, 128, 6912, 151936, True, False)),
    ("gemma-2b", (18, 2048, 8, 1, 256, 16384, 256000, False, True)),
])
def test_published_dimensions(arch, dims):
    c = get_config(arch)
    assert (c.num_layers, c.d_model, c.num_heads, c.num_kv_heads,
            c.resolved_head_dim, c.d_ff, c.vocab_size, c.qkv_bias,
            c.tie_embeddings) == dims
    r = get_config(arch, reduced=True)
    # the reduced configs keep MQA and the MHA-like kv heads the
    # reference's reduce() asks for
    assert r.num_kv_heads == {"gemma-2b": 1, "granite-8b": 2}.get(arch, 4)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_tree_matches_reference(arch):
    """The port's ``init_params`` has the reference tree: bias leaves
    under ``qkv_bias`` (zeros), no ``lm_head`` when tied; the bridge
    carries the reference's tree across leaf for leaf."""
    s = stack(arch)
    mine = T.init_params(torch.Generator().manual_seed(0), s.tcfg)

    def shapes(tree):
        return {k: shapes(v) if isinstance(v, dict) else tuple(v.shape)
                for k, v in tree.items()}

    assert shapes(mine) == shapes(jax.tree.map(np.asarray, s.params))
    assert shapes(mine) == shapes(s.tparams)
    attn = mine["units"]["pos0"]["attn"]
    assert ("bq" in attn) == s.cfg.qkv_bias
    if s.cfg.qkv_bias:
        assert all(not attn[n].any() for n in ("bq", "bk", "bv"))
        assert s.tparams["units"]["pos0"]["attn"]["bq"].abs().max() > 0.05
    assert ("lm_head" in mine) == (not s.cfg.tie_embeddings)


# ------------------------------------------------------------------ layers

@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "qwen1.5-4b"])
def test_project_qkv_with_biases(rng, arch, dt):
    s = stack(arch)
    jp = jax.tree.map(lambda a: a[0], s.params["units"]["pos0"]["attn"])
    tp = {k: v[0] for k, v in s.tparams["units"]["pos0"]["attn"].items()}
    x = rng.standard_normal((2, 5, s.cfg.d_model)).astype(np.float32)
    jq = JL._project_qkv(jp, jnp.asarray(x, dt), s.cfg)
    tq = L._project_qkv(tp, torch.from_numpy(x).to(TDT[dt]), s.tcfg)
    for a, b in zip(tq, jq):
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(b, np.float32),
                                   atol=TOL[dt], rtol=0)
    # the biases were added: without them the projections differ
    nob = {k: v for k, v in tp.items() if not k.startswith("b")}
    plain = L._project_qkv(nob, torch.from_numpy(x).to(TDT[dt]), s.tcfg)
    assert not torch.allclose(plain[0], tq[0])


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_tied_embed_and_unembed_gemma(rng, dt):
    """gemma-2b reduced: ``embed_tokens`` scales by sqrt(d) rounded to the
    activation dtype (exact in bf16), ``unembed`` reads ``embed.T``."""
    s = stack("gemma-2b")
    jcfg = dataclasses.replace(s.cfg, dtype=dt)
    tcfg = dataclasses.replace(s.tcfg, dtype=dt)
    tok = rng.integers(0, s.cfg.vocab_size, size=(3, 7)).astype(np.int32)
    je = JT.embed_tokens(s.params, jcfg, jnp.asarray(tok))
    te = T.embed_tokens(s.tparams, tcfg, torch.from_numpy(tok))
    assert te.dtype == TDT[dt]
    if dt == "bfloat16":
        np.testing.assert_array_equal(te.float().numpy(),
                                      np.asarray(je, np.float32))
        assert T.embed_scale(tcfg, TDT[dt]) == 8.0   # sqrt(64) is exact
    else:
        np.testing.assert_allclose(te.numpy(), np.asarray(je), atol=3e-5,
                                   rtol=0)
    raw = s.tparams["embed"][torch.from_numpy(tok).long()].to(TDT[dt])
    assert not torch.equal(te, raw)       # the gemma scale was applied
    h = rng.standard_normal((3, 7, s.cfg.d_model)).astype(np.float32)
    jl = JT.unembed(s.params, jcfg, jnp.asarray(h, dt))
    tl = T.unembed(s.tparams, tcfg, torch.from_numpy(h).to(TDT[dt]))
    np.testing.assert_allclose(tl.float().numpy(), np.asarray(jl, np.float32),
                               atol=TOL[dt], rtol=0)
    w, layout = T.unembed_weight(s.tparams)
    assert layout == "vd" and w.data_ptr() == s.tparams["embed"].data_ptr()


def test_gemma_scale_rounds_in_bf16():
    """At gemma-2b's full width the scale is 45.25 in bf16, as the
    reference's ``jnp.asarray(d ** 0.5, bf16)`` rounds it."""
    cfg = dataclasses.replace(get_config("gemma-2b"), vocab_size=4,
                              num_layers=1)
    params = {"embed": torch.ones((4, cfg.d_model), dtype=torch.bfloat16)}
    x = T.embed_tokens(params, cfg, torch.tensor([[1]]))
    assert x.dtype == torch.bfloat16 and x[0, 0, 0].item() == 45.25
    assert T.embed_scale(cfg, torch.float32) == np.float32(2048 ** 0.5)
    jx = JT.embed_tokens({"embed": jnp.ones((4, cfg.d_model), jnp.bfloat16)},
                         jax_get_config("gemma-2b"), jnp.asarray([[1]]))
    assert float(jx[0, 0, 0]) == 45.25


def test_entry_points_pin_f32_reductions(monkeypatch):
    """Every entry point resolves its device through ``resolve_device``,
    which pins float32 products to full float32 and bf16 products to f32
    reductions (cuBLAS would otherwise be free to reduce a split-K bf16
    product's partials in bf16, where the reference sums in f32)."""
    from repro_torch.runtime import resolve_device

    matmul = torch.backends.cuda.matmul
    monkeypatch.setattr(matmul, "allow_bf16_reduced_precision_reduction",
                        True)
    monkeypatch.setattr(matmul, "allow_tf32", True)
    resolve_device("cpu")
    assert not matmul.allow_bf16_reduced_precision_reduction
    assert not matmul.allow_tf32


# ------------------------------------------------------------------ engine

def _t(a):
    return torch.from_numpy(a)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("arch, layout", ENGINE_CASES,
                         ids=[f"{a}-{lay}" for a, lay in ENGINE_CASES])
def test_spec_equals_ar_equals_reference(arch, layout, fused):
    s = stack(arch)
    c = s.layout(layout, s.tcfg, fused)
    eng = SpecEngine(c, s.tb, use_kernel=True, device="cpu")
    tok, plen = _t(s.tokens), _t(s.lengths)
    out, n_out, st = eng.generate(s.tparams, s.tmp, tok, plen,
                                  eng.init_cache(B, S_MAX), MAX_NEW)
    ar, _ = ar_generate(c, s.tparams, tok, plen, eng.init_cache(B, S_MAX),
                        MAX_NEW, use_kernel=True)
    want = s.jax_ar(layout)
    np.testing.assert_array_equal(out.numpy(), ar.numpy())
    np.testing.assert_array_equal(out.numpy(), want)
    assert (n_out == MAX_NEW).all()
    assert st.steps < MAX_NEW          # multi-token paths were accepted


def test_sampled_temperature_zero_is_greedy_gemma_fused():
    """gemma-2b with verify fusion: ``accept="sample"`` at temperature 0
    (K2's sampled statistics and the one-row unembed over the tied
    table) gives the greedy tokens and the reference's AR tokens."""
    s = stack("gemma-2b")
    c = dataclasses.replace(s.tcfg, verify_fusion=True)
    eng = SpecEngine(c, s.tb, use_kernel=True, device="cpu",
                     accept="sample",
                     sampling=SamplingParams(temperature=0.0), seed=3)
    out, n_out, st = eng.generate(s.tparams, s.tmp, _t(s.tokens),
                                  _t(s.lengths), eng.init_cache(B, S_MAX),
                                  MAX_NEW)
    np.testing.assert_array_equal(out.numpy(), s.jax_ar("dense"))
    assert (n_out == MAX_NEW).all() and st.steps < MAX_NEW


# ------------------------------------------------------- K2 over the table

@pytest.mark.parametrize("dt, block_v", [("float32", 128),
                                         ("float32", None),
                                         ("bfloat16", 128)])
def test_tied_stats_plain_matches_reference(rng, dt, block_v):
    """K2's plain version over a tied [V, d] table (through its transposed
    view) against the reference's Pallas kernel in interpret mode over
    ``embed.T``: argm exact, m / l / cand_w at the kernel tests'
    tolerance."""
    Bs, Tn, d, Vc = 2, 6, 32, 700
    embed = (rng.standard_normal((Vc, d)) * 0.3).astype(np.float32)
    hidden = rng.standard_normal((Bs, Tn, d)).astype(np.float32)
    cand = rng.integers(0, Vc, (Bs, Tn)).astype(np.int32)
    cand[:, -1] = Vc - 1
    tmax = np.array([1.0, 0.7], np.float32)
    je = jnp.asarray(embed, dt)
    ref = JO.verify_stats(jnp.asarray(hidden, dt), je.T, jnp.asarray(cand),
                          jnp.asarray(tmax), block_v=block_v, interpret=True)
    te = torch.from_numpy(embed).to(TDT[dt])
    kw = {} if block_v is None else {"block_v": block_v}
    got = TA.unembed_verify_stats_plain(torch.from_numpy(hidden).to(TDT[dt]),
                                        te.T, _t(cand), _t(tmax), **kw)
    argm, m, l, cw = got
    np.testing.assert_array_equal(argm.numpy(), np.asarray(ref[0]))
    for a, b in ((m, ref[1]), (cw, ref[3])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL[dt],
                                   rtol=0)
    np.testing.assert_allclose(l.numpy() / np.asarray(ref[2]),
                               np.ones(l.shape), atol=TOL[dt], rtol=0)
    # the wrapper, told the layout, takes the same plain version
    for a, b in zip(TA.unembed_verify_stats(
            torch.from_numpy(hidden).to(TDT[dt]), te.T, _t(cand), _t(tmax),
            layout="vd"), TA.unembed_verify_stats_plain(
                torch.from_numpy(hidden).to(TDT[dt]), te.T, _t(cand),
                _t(tmax))):
        assert torch.equal(a, b)


def test_stats_operand_reads_the_table_in_place(monkeypatch):
    """The kernel's operand for a tied model is the [V, d] table itself:
    the same storage through ``unembed_weight`` and ``stats_operand``,
    and no copy is made on the way (``contiguous``/``clone`` are not
    called); other strides raise rather than copy."""
    embed = torch.randn((300, 48), dtype=torch.bfloat16)
    w, layout = T.unembed_weight({"embed": embed})
    assert tuple(w.shape) == (48, 300) and layout == "vd"

    def refuse(*a, **k):
        raise AssertionError("the unembedding weight was copied")

    monkeypatch.setattr(torch.Tensor, "contiguous", refuse)
    monkeypatch.setattr(torch.Tensor, "clone", refuse)
    table, found = TA.stats_operand(w.to(torch.bfloat16), layout)
    assert found == "vd" and table.data_ptr() == embed.data_ptr()
    assert tuple(table.shape) == (300, 48) and table.is_contiguous()
    head = torch.randn((48, 300))
    table, found = TA.stats_operand(head)
    assert found == "dv" and table.data_ptr() == head.data_ptr()
    monkeypatch.undo()
    with pytest.raises(ValueError, match="laid out"):
        TA.stats_operand(w, "dv")
    with pytest.raises(ValueError, match="neither"):
        TA.weight_layout(torch.randn((48, 600))[:, ::2])
    assert T.unembed_weight({"lm_head": head, "embed": embed}) == (head, "dv")


# ------------------------------------------------------------------- plans

@pytest.mark.parametrize("B_, Hkv, R, dtype, want", [
    # gemma-2b: one kv head, 8 query heads: R 8 x 64 at the spec step
    (4, 1, 512, torch.bfloat16, ("single", 64, 2048, 1)),
    (4, 1, 8, torch.bfloat16, ("split", 16, 64, 32)),
    (4, 1, 512, torch.float32, ("single", 32, 2048, 1)),
    # qwen1.5-0.5b: 16 kv heads, one query head each (R 64 / 1 -> 8)
    (4, 16, 64, torch.bfloat16, ("split", 64, 512, 4)),
    (4, 16, 8, torch.bfloat16, ("split", 16, 64, 32)),
    # qwen1.5-4b: 20 kv heads, R 64 at the spec step
    (4, 20, 64, torch.bfloat16, ("split", 64, 512, 4)),
])
def test_decode_plan_at_the_new_shapes(B_, Hkv, R, dtype, want):
    """K1's grid over a 2048-row cache: valid at B 4 x Hkv 1 (four (slot,
    head) pairs) with R 512, whole 64-column tiles in every split."""
    plan = TA.decode_plan(B_, Hkv, R, 2048, dtype)
    assert tuple(plan) == want
    assert plan.split_cols % 64 == 0
    assert plan.n_splits * plan.split_cols >= 2048
    assert (plan.n_splits - 1) * plan.split_cols < 2048


@pytest.mark.parametrize("M, consumers, splits, blocks", [
    (256, 2, 4, 80),      # gemma-2b's spec step: 2 row tiles x 10 heads x 4
    (4, 1, 8, 80),        # its AR step
    (192, 2, 4, 80),
])
def test_qkv_plan_at_head_dim_256(M, consumers, splits, blocks):
    route, c, sp = CU.qkv_plan(M, 2048, 256, torch.bfloat16)
    assert (route, c, sp) == ("wgmma", consumers, splits)
    assert CU.qkv_blocks(M, 8, 1, 256, route, c, sp) == blocks
    assert CU.qkv_smem(256, c) <= 232448        # a block's shared memory
    assert CU.qkv_plan(M, 2048, 256, torch.float32) == ("tile", 0, 1)


def test_qkv_smem_at_the_old_shapes():
    """The shared memory the wgmma route's blocks take (``QkvCfg::SMEM``):
    at head_dim 128 the 4-stage ring of 256-row tiles, at 256 the ring of
    128-row tiles; a 256-row f32 tile at head_dim 256 would not fit."""
    assert CU.qkv_smem(128, 2) == 4 * (256 * 128 + 2 * 8192) + 1088
    assert CU.qkv_smem(256, 2) == 4 * (128 * 128 + 4 * 8192) + 1088
    assert 256 * (256 + 8) * 4 > 232448


@pytest.mark.parametrize("N, d, v, layout, want", [
    (256, 2048, 256000, "vd", ("wgmma", 132)),   # gemma-2b's tied table
    (4, 2048, 256000, "vd", ("wgmma", 132)),
    (256, 2048, 256001, "vd", ("wgmma", 132)),   # V odd: rows run along d
    (256, 2048, 256001, "dv", ("tile", 2001)),
    (256, 2044, 256000, "vd", ("tile", 2000)),   # d rows not 16-byte aligned
    (256, 1024, 151936, "dv", ("wgmma", 132)),   # qwen's [d, V] heads
    (256, 4096, 49152, "dv", ("wgmma", 132)),    # granite-8b
])
def test_stats_plan_over_the_table(N, d, v, layout, want):
    assert TA.stats_plan(N, d, v, torch.bfloat16, True, 132, layout) == want


# ----------------------------------------------------------------- launcher

@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "gemma-2b"])
def test_launcher_answers_on_the_cpu(capsys, arch, fused):
    argv = ["--static", "--arch", arch, "--reduced", "--device", "cpu",
            "--requests", "3", "--slots", "2", "--max-new", "8",
            "--max-len", "128"]
    srv = serve.main(argv + (["--verify-fusion"] if fused else []))
    assert [r["status"] for r in srv.results] == ["done"] * 3
    assert srv.tokens == 24 and srv.cfg.verify_fusion == fused
    assert srv.cfg.name == arch + "-reduced"
    first = srv.prompts[0]
    ar, _ = ar_generate(srv.cfg, srv.params, torch.from_numpy(first[None]),
                        torch.tensor([len(first)], dtype=torch.int32),
                        srv.engine.init_cache(1, 128), 8, use_kernel=True)
    np.testing.assert_array_equal(ar[0].numpy(), srv.results[0]["output"])
    assert f"{arch}-reduced" in capsys.readouterr().out
