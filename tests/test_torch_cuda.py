"""The port's CUDA kernels on the card, against their plain versions.

This file imports neither ``jax`` nor ``repro``: the machine with the card
has no JAX, so these tests run there from a copy of this file outside
``tests/`` (whose ``conftest.py`` imports JAX); the command is in
``.claude/skills/verify/SKILL.md``.  Every test carries
``@pytest.mark.cuda`` and skips without a GPU.

* K1 (``flash_decode``) in its four variants (dense, int8, paged, int8 +
  paged), f32 and bf16, at the main path's shapes (B 4, Hkv 8, D 128, a
  2048-row cache) at R 256 (the spec step) and R 8 (the AR step), with an
  idle slot (length 0, and a zero table when paged): within 3e-5 (f32) or
  2e-2 (bf16) of ``flash_decode_plain``, the idle slot's statistics
  exactly empty, the route ``decode_plan`` gives, one launch a call; paged
  bitwise equal to dense; short rows whose splits mostly start past the
  length; head_dim 64 and 256.
* The K1-K5 checks that sat in the JAX parity files: K1 at the main shape,
  K2 and K3 in f32, K1's int8 / paged / int8 + paged variants on a small
  cache, K4 and K5.
* The captured decode step (``runtime.StepGraph``) on openPangu-7B cut to
  2 layers of width 64 (head_dim 64, which the kernels take), f32, in
  every layout and fusion mode: graph tokens == eager tokens == AR tokens
  exactly, launch counts exact, and a second ``generate`` on the
  engine's reused cache replays every step with no new capture.
* The captured sampled step (``accept="sample"``) on the same model,
  unfused and fused: graph tokens == eager tokens from the same generator
  seed at temperature 0.7, again at 0.9 on the same graph with no new
  capture, and the AR tokens at temperature 0; a registered generator
  draws fresh noise at every replay (the eager draws), and a capture
  that draws from an unregistered one raises.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.kernels import cache_update as CU
from repro_torch.kernels.quant import quantize_rows
from repro_torch.kernels.tree_attention import (decode_plan, flash_decode,
                                                flash_decode_plain,
                                                unembed_verify_stats,
                                                unembed_verify_stats_plain)
from repro_torch.models.layers import rope_cos_sin

TOL = {torch.float32: 3e-5, torch.bfloat16: 2e-2}
VARIANTS = ["dense", "int8", "paged", "int8+paged"]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _stats_err(got, ref, live=None):
    """acc / l (what the merge consumes), m, and l relative, over the live
    slots."""
    if live is not None:
        got, ref = [x[live] for x in got], [x[live] for x in ref]
    acc, m, l = (x.float() for x in got)
    racc, rm, rl = (x.float() for x in ref)
    return max((acc / l - racc / rl).abs().max().item(),
               (m - rm).abs().max().item(), (l / rl - 1).abs().max().item())


def _shuffled_table(B, mb, dev, seed):
    """[B, mb] int32: a random permutation of blocks 1 .. B*mb."""
    perm = np.random.default_rng(seed).permutation(B * mb) + 1
    return torch.from_numpy(perm.reshape(B, mb).astype(np.int32)).to(dev)


def _to_pool(dense, table, ps, gen):
    """Pool [1 + B*mb, ps, ...] holding ``dense`` [B, mb*ps, ...] through
    ``table``; block 0 and unused blocks hold noise."""
    B, mb = table.shape
    pool = torch.randn((1 + B * mb, ps) + tuple(dense.shape[2:]),
                       generator=gen, device=dense.device).to(dense.dtype)
    pool[table.long()] = dense.reshape((B, mb, ps) + tuple(dense.shape[2:]))
    return pool


def _k1_inputs(dev, variant, B, S, Hkv, R, D, dt, lengths, ps=64, seed=0):
    """(q, k, v, lengths, kwargs) of one K1 call in ``variant``, and the
    dense (k, v, kwargs) of the same logical rows."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = (torch.randn((B, Hkv, R, D), generator=gen, device=dev)
         * D ** -0.5).to(dt)
    kd = torch.randn((B, S, Hkv, D), generator=gen, device=dev).to(dt)
    vd = torch.randn((B, S, Hkv, D), generator=gen, device=dev).to(dt)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    leaves = {"k": kd, "v": vd}
    if "int8" in variant:
        (k8, ks), (v8, vs) = quantize_rows(kd), quantize_rows(vd)
        leaves = {"k": k8, "v": v8, "k_scale": ks, "v_scale": vs}
    dense_kw = {n: leaves[n] for n in ("k_scale", "v_scale") if n in leaves}
    dense = (leaves["k"], leaves["v"], dense_kw)
    if "paged" not in variant:
        return q, leaves["k"], leaves["v"], lens, dense_kw, dense
    table = _shuffled_table(B, S // ps, dev, seed)
    table[lens == 0] = 0                         # an idle slot
    pools = {n: _to_pool(t, table, ps, gen) for n, t in leaves.items()}
    kw = {n: pools[n] for n in dense_kw}
    kw["block_tables"] = table
    return q, pools["k"], pools["v"], lens, kw, dense


def _k1_check(q, k, v, lens, kw, dt):
    """One counted K1 call against its plain version: (result, route)."""
    before = flash_decode.launches
    routes = dict(flash_decode.launches_by_route)
    got = flash_decode(q, k, v, lens, **kw)
    ref = flash_decode_plain(q, k, v, lens, **kw)
    torch.cuda.synchronize()
    assert flash_decode.launches == before + 1
    took = [r for r, n in flash_decode.launches_by_route.items()
            if n != routes[r]]
    B, Hkv, R, _ = q.shape
    S = k.shape[1] * kw["block_tables"].shape[1] if "block_tables" in kw \
        else k.shape[1]
    plan = decode_plan(B, Hkv, R, S, q.dtype, torch.cuda.get_device_properties(
        q.device).multi_processor_count)
    assert took == ([plan.route, "merge"] if plan.route == "split"
                    else [plan.route])
    live = lens > 0
    assert _stats_err(got, ref, live) < TOL[dt]
    assert (got[0][~live] == 0).all() and (got[2][~live] == 0).all()
    assert (got[1][~live] == -1e30).all()
    return got, plan.route


# ---------------------------------------------------------------------------
# K1, redesigned: main shapes, every variant
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("R", [256, 8])
@pytest.mark.parametrize("variant", VARIANTS)
def test_cuda_flash_decode_main_shapes(dev, variant, R, dt):
    q, k, v, lens, kw, _ = _k1_inputs(dev, variant, 4, 2048, 8, R, 128, dt,
                                      [0, 517, 1300, 2048],
                                      ps=16 if variant == "int8+paged" else 64)
    _, route = _k1_check(q, k, v, lens, kw, dt)
    assert route == ("single" if R == 256 else "split")


@pytest.mark.cuda
@pytest.mark.parametrize("R", [256, 8])
@pytest.mark.parametrize("quantized", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("ps", [16, 64, 128])
def test_cuda_flash_decode_paged_is_dense_bitwise(dev, R, quantized, ps):
    variant = "int8+paged" if quantized else "paged"
    q, k, v, lens, kw, (kd, vd, dkw) = _k1_inputs(
        dev, variant, 4, 2048, 8, R, 128, torch.bfloat16,
        [0, 300, 1300, 2048], ps=ps, seed=ps)
    paged = flash_decode(q, k, v, lens, **kw)
    dense = flash_decode(q, kd, vd, lens, **dkw)
    torch.cuda.synchronize()
    for a, b in zip(paged, dense):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_cuda_flash_decode_short_rows(dev, variant, dt):
    """R 8 over 32 splits of 64 columns with rows of 0-190 columns: most
    splits start past the length and only the live ones are merged."""
    q, k, v, lens, kw, _ = _k1_inputs(dev, variant, 4, 2048, 8, 8, 128, dt,
                                      [0, 64, 65, 190], ps=16, seed=3)
    _, route = _k1_check(q, k, v, lens, kw, dt)
    assert route == "split"


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("D", [64, 256])
@pytest.mark.parametrize("R", [24, 8])
@pytest.mark.parametrize("variant", VARIANTS)
def test_cuda_flash_decode_head_dims(dev, variant, R, D, dt):
    q, k, v, lens, kw, _ = _k1_inputs(dev, variant, 2, 640, 2, R, D, dt,
                                      [0, 600], ps=64, seed=D + R)
    _k1_check(q, k, v, lens, kw, dt)


@pytest.mark.cuda
def test_cuda_flash_decode_routes_count(dev):
    """One launch a call on either route; a split launch also counts its
    merge kernel."""
    before = dict(flash_decode.launches_by_route)
    n = flash_decode.launches
    for R in (256, 8):
        q, k, v, lens, kw, _ = _k1_inputs(dev, "dense", 4, 2048, 8, R, 128,
                                          torch.bfloat16, [1, 2, 3, 4])
        flash_decode(q, k, v, lens, **kw)
    after = flash_decode.launches_by_route
    assert flash_decode.launches == n + 2
    assert {r: after[r] - before[r] for r in after} == {
        "single": 1, "split": 1, "merge": 1}


# ---------------------------------------------------------------------------
# moved here from the JAX parity files (tests/test_torch_kernels.py,
# tests/test_torch_fusion.py, tests/test_torch_paged.py)
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_cuda_kernel_matches_plain(dev):
    """The K1 kernel against its plain version at the main path's shape."""
    for dt, tol in ((torch.float32, 3e-5), (torch.bfloat16, 2e-2)):
        q = torch.randn((4, 8, 256, 128), device=dev, dtype=dt) / 128 ** 0.5
        k = torch.randn((4, 2048, 8, 128), device=dev, dtype=dt)
        v = torch.randn((4, 2048, 8, 128), device=dev, dtype=dt)
        lengths = torch.tensor([1, 517, 1300, 2048], dtype=torch.int32,
                               device=dev)
        before = flash_decode.launches
        got = flash_decode(q, k, v, lengths)
        assert flash_decode.launches == before + 1
        ref = flash_decode_plain(q, k, v, lengths)
        assert _stats_err(got, ref) < tol


@pytest.mark.cuda
def test_cuda_fusion_kernels_match_plain(dev, rng):
    """K2 and K3 against their plain versions on the card, f32."""
    h = torch.from_numpy(rng.standard_normal((2, 64, 256))).float().to(dev)
    w = torch.from_numpy(rng.standard_normal((256, 1000)) / 16).float().to(dev)
    cand = torch.from_numpy(rng.integers(0, 1000, (2, 64))).int().to(dev)
    tmax = torch.ones((2,), device=dev)
    before = unembed_verify_stats.launches
    argm, m, l, cw = unembed_verify_stats(h, w, cand, tmax)
    assert unembed_verify_stats.launches == before + 1
    rargm, rm, rl, rcw = unembed_verify_stats_plain(h, w, cand, tmax)
    assert torch.equal(argm, rargm)
    assert (m - rm).abs().max().item() < 3e-5
    assert (l / rl - 1).abs().max().item() < 3e-5
    assert (cw - rcw).abs().max().item() < 3e-5
    d, Hq, Hkv, hd, T, S = 256, 4, 2, 64, 64, 128
    p = {n: torch.from_numpy(rng.standard_normal((d, H, hd)) / 8).float()
         .to(dev) for n, H in (("wq", Hq), ("wk", Hkv), ("wv", Hkv))}
    p |= {n: torch.from_numpy(rng.standard_normal((H, hd))).float().to(dev)
          for n, H in (("bq", Hq), ("bk", Hkv), ("bv", Hkv))}
    x = torch.from_numpy(rng.standard_normal((2, T, d))).float().to(dev)
    kc = torch.from_numpy(rng.standard_normal((2, S, Hkv, hd))).float().to(dev)
    vc = torch.from_numpy(rng.standard_normal((2, S, Hkv, hd))).float().to(dev)
    lengths = torch.tensor([5, 40], dtype=torch.int32, device=dev)
    cos, sin = rope_cos_sin(lengths[:, None] + torch.arange(T, device=dev),
                            hd, 10000.0)
    kc2, vc2 = kc.clone(), vc.clone()
    before = CU.fused_qkv_rope_commit.launches
    got = CU.fused_qkv_rope_commit(x, p, lengths, kc, vc, cos=cos, sin=sin)
    assert CU.fused_qkv_rope_commit.launches == before + 1
    ref = CU.fused_qkv_rope_commit_plain(x, p, lengths, kc2, vc2, cos=cos,
                                         sin=sin)
    for g, r in zip((*got, kc, vc), (*ref, kc2, vc2)):
        assert (g - r).abs().max().item() < 3e-5


@pytest.mark.cuda
def test_cuda_paged_kernels_match_plain(dev):
    """K1 int8 / paged / int8 + paged, K4 and K5 against their plain
    versions on the card, f32."""
    Bc, S, Hkv, D, ps = 2, 256, 2, 64, 16
    q = torch.randn((Bc, Hkv, 16, D), device=dev) / D ** 0.5
    kd = torch.randn((Bc, S, Hkv, D), device=dev)
    table = _shuffled_table(Bc, S // ps, dev, 0)
    lengths = torch.tensor([0, 200], dtype=torch.int32, device=dev)
    table[0] = 0
    pool = torch.randn((1 + Bc * S // ps, ps, Hkv, D), device=dev)
    k8, ks = (torch.randint(-127, 128, kd.shape, dtype=torch.int8,
                            device=dev), torch.rand(kd.shape[:-1] + (1,),
                                                    device=dev))
    p8, psc = (torch.randint(-127, 128, pool.shape, dtype=torch.int8,
                             device=dev), torch.rand(pool.shape[:-1] + (1,),
                                                     device=dev))
    for args, kw in (((q, k8, k8, lengths), dict(k_scale=ks, v_scale=ks)),
                     ((q, pool, pool, lengths), dict(block_tables=table)),
                     ((q, p8, p8, lengths), dict(k_scale=psc, v_scale=psc,
                                                 block_tables=table))):
        before = flash_decode.launches
        got = flash_decode(*args, **kw)
        assert flash_decode.launches == before + 1
        ref = flash_decode_plain(*args, **kw)
        for g, r in zip(got, ref):
            assert (g - r).abs().max().item() < 3e-5
    rows = torch.randn((Bc, 5, Hkv, D), device=dev)
    starts = torch.tensor([S - 2, 7], dtype=torch.int32, device=dev)
    for fn, plain, cache in (
            (CU.commit_rows_stacked, CU.commit_rows_stacked_plain,
             torch.randn((1, Bc, S, Hkv, D), device=dev)),
            (CU.commit_rows_paged_stacked, CU.commit_rows_paged_stacked_plain,
             pool[None])):
        extra = (table,) if fn is CU.commit_rows_paged_stacked else ()
        a, b = cache.clone(), cache.clone()
        before = fn.launches
        fn(a, *extra, rows[None], starts)
        assert fn.launches == before + 1
        plain(b, *extra, rows[None], starts)
        assert (torch.equal(a[:, 1:], b[:, 1:]) if extra
                else torch.equal(a, b))


# ---------------------------------------------------------------------------
# the captured decode step
# ---------------------------------------------------------------------------

GRAPH_LAYOUTS = {
    "dense": {}, "fusion": dict(verify_fusion=True),
    "paged": dict(cache_layout="paged", page_size=16),
    "paged+fusion": dict(cache_layout="paged", page_size=16,
                         verify_fusion=True),
    "int8": dict(cache_dtype="int8"),
    "int8+paged": dict(cache_dtype="int8", cache_layout="paged",
                       page_size=16),
    "int8+fusion": dict(cache_dtype="int8", verify_fusion=True)}
GRAPH_WRAPPERS = {"K1": flash_decode, "K2": unembed_verify_stats,
                  "K3": CU.fused_qkv_rope_commit,
                  "K4": CU.commit_rows_stacked,
                  "K5": CU.commit_rows_paged_stacked}


def _expected_counts(cfg, steps, ar_steps):
    """``chip_smoke.py``'s ``expected_counts``."""
    per_layer = cfg.num_layers * (steps + ar_steps)
    quantized = cfg.resolved_cache_dtype == "int8"
    commits = (4 if quantized else 2) * steps
    fused = cfg.verify_fusion
    return {"K1": per_layer, "K2": steps if fused else 0,
            "K3": per_layer if fused and not quantized else 0,
            "K4": 0 if cfg.paged else commits,
            "K5": commits if cfg.paged else 0}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(GRAPH_LAYOUTS))
def test_cuda_graph_step_equals_eager(dev, name):
    from repro_torch.configs.registry import get_config
    from repro_torch.core.engine import SpecCarry, ar_generate, build_engine
    from repro_torch.launch.serve import build_model, make_prompts

    cfg = dataclasses.replace(get_config("openpangu-7b", reduced=True),
                              head_dim=64, num_layers=2,
                              **GRAPH_LAYOUTS[name])
    eng, eager = (build_engine(cfg, use_kernel=True, device=dev, graphs=g)
                  for g in (True, False))
    params, mp = build_model(cfg, 3, eng.dtree.K, dev)
    prompts = make_prompts(cfg.vocab_size, 4, 3, 8, 40)
    tok = torch.zeros((4, max(len(p) for p in prompts)), dtype=torch.int32)
    for j, p in enumerate(prompts):
        tok[j, :len(p)] = torch.from_numpy(p)
    tok = tok.to(dev)
    plen = torch.tensor([len(p) for p in prompts], dtype=torch.int32,
                        device=dev)
    max_new, max_len = 24, 256

    def run(e):
        for f in GRAPH_WRAPPERS.values():
            f.launches = 0
        sp, _, st = e.generate(params, mp, tok, plen,
                               e.init_cache(4, max_len), max_new)
        ar, _ = ar_generate(e.cfg, params, tok, plen,
                            e.init_cache(4, max_len), max_new,
                            use_kernel=True, graphs=e.step_graphs)
        torch.cuda.synchronize()
        assert {k: f.launches for k, f in GRAPH_WRAPPERS.items()} == \
            _expected_counts(e.cfg, st.steps, max_new)
        return sp.cpu(), ar.cpu(), st

    want, want_ar, want_st = run(eager)
    sp, ar, st = run(eng)
    graphs = {isinstance(c, SpecCarry): g for g, c in eng.step_graphs.kept()}
    assert len(graphs) == 2 and all(g.graph is not None
                                    for g in graphs.values())
    replays = {k: g.replays for k, g in graphs.items()}
    sp2, ar2, st2 = run(eng)
    assert len(eng.step_graphs.kept()) == 2
    assert {k: g.replays - replays[k] for k, g in graphs.items()} == {
        True: st2.steps, False: max_new}
    for got in (sp, ar, sp2, ar2, want_ar):
        assert torch.equal(got, want)
    assert st.steps == st2.steps == want_st.steps


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True])
def test_cuda_sampled_graph_step_equals_eager(dev, fused):
    from repro_torch.configs.base import SamplingParams
    from repro_torch.configs.registry import get_config
    from repro_torch.core.engine import ar_generate, build_engine
    from repro_torch.launch.serve import build_model, make_prompts

    cfg = dataclasses.replace(get_config("openpangu-7b", reduced=True),
                              head_dim=64, num_layers=2, verify_fusion=fused)

    def engine(t, graphs=True):
        return build_engine(cfg, use_kernel=True, device=dev, graphs=graphs,
                            accept="sample", seed=4,
                            sampling=SamplingParams(temperature=t))

    eng, eager = engine(0.7), engine(0.7, graphs=False)
    params, mp = build_model(cfg, 3, eng.dtree.K, dev)
    prompts = make_prompts(cfg.vocab_size, 4, 3, 8, 40)
    tok = torch.zeros((4, max(len(p) for p in prompts)), dtype=torch.int32)
    for j, p in enumerate(prompts):
        tok[j, :len(p)] = torch.from_numpy(p)
    tok = tok.to(dev)
    plen = torch.tensor([len(p) for p in prompts], dtype=torch.int32,
                        device=dev)
    max_new, max_len = 24, 256

    def run(e, **kw):
        out, n_out, st = e.generate(params, mp, tok, plen,
                                    e.init_cache(4, max_len), max_new, **kw)
        assert bool((n_out == max_new).all())
        return out.cpu(), st

    got, st = run(eng)
    assert torch.equal(got, run(eager)[0])
    (graph, _), = eng.step_graphs.kept()
    replays = graph.replays
    got2, st2 = run(eng, temperature=0.9)
    assert torch.equal(got2, run(eager, temperature=0.9)[0])
    assert len(eng.step_graphs.kept()) == 1
    assert graph.replays == replays + st2.steps
    zero = run(engine(0.0))[0]
    ar, _ = ar_generate(cfg, params, tok, plen, eng.init_cache(4, max_len),
                        max_new, use_kernel=True)
    assert torch.equal(zero, ar.cpu()) and not torch.equal(got, zero)


@pytest.mark.cuda
def test_cuda_graph_draws_fresh_noise_and_refuses_an_unregistered_generator(
        dev):
    from repro_torch import runtime
    from repro_torch.core import sampling as S

    gen = torch.Generator(device=dev).manual_seed(0)
    buf = torch.empty((4, 1000), device=dev)
    graph = runtime.StepGraph(lambda: buf.copy_(S.gumbel(buf.shape, gen)),
                              dev, generators=(gen,))
    seen = []
    for _ in range(4):
        graph()
        seen.append(buf.clone())
    gen.manual_seed(0)
    for got in seen:
        assert torch.equal(got, S.gumbel(buf.shape, gen))
    assert not torch.equal(seen[2], seen[3]) and graph.replays == 3
    other = torch.Generator(device=dev).manual_seed(1)
    bad = runtime.StepGraph(lambda: buf.copy_(S.uniform(buf.shape, other)),
                            dev)
    bad()
    with pytest.raises(RuntimeError, match="no eager fallback"):
        bad()
    assert float(torch.ones(8, device=dev).sum()) == 8
