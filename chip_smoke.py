#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA GPU.

  python3 chip_smoke.py

Run from the repo root of a checkout.  It imports nothing of JAX or of the
JAX package.  Every phase must pass, and any failure ends the run with a
non-zero exit:

1. print the card's name and power limit; build every CUDA kernel of the
   port from the checkout's sources (one nvcc per source, in parallel);
2. hold the ``flash_decode`` kernel (K1) against ``flash_decode_plain`` on
   the card (the reference's kernel-test shape sweep plus the main path's
   shapes, f32 and bf16, and at R 8 rows short enough that most of the
   32 splits start past the length), and ``ops.tree_attention`` against
   the ``tree_attention_ref`` oracle; then K1's int8, paged and int8 +
   paged variants the same way, on pools of page size 16, 64 and 128 read
   through a shuffled block table, with an idle slot (zero table, length
   0); every paged run must also be bitwise the dense kernel's run on the
   same logical rows; every K1 case logs its route ("single" or "split"),
   which must be the one ``decode_plan`` gives its shapes;
3. hold the verify-fusion kernels against their plain versions on the
   card, f32 and bf16: ``unembed_verify_stats`` (K2) at the spec step's
   shape (B 4, T 64, d 4096, V 153376, which is not a multiple of the
   kernel's 128-column tile), with a candidate in the last partial tile,
   and with tied lm-head columns in different tiles (first index wins),
   plus a vocabulary whose rows are not 16-byte aligned, and at N 512
   (B 8, T 64) and N 64, and at the sampled step's per-row temperatures
   ``TMAX_ROWS`` (1e-6 standing for temperature 0; m and cand_w held in
   the logits' units, finite, argm the tmax 1 argm) on both routes;
   ``fused_qkv_rope_commit`` (K3) at the spec (T 64) and AR (T 1) shapes
   of openPangu-7B's attention, with biases, with rows past the cache's
   end (dropped; the rest of the cache unchanged bit for bit), at row
   counts that fit no tile (B 3, T 64 and B 4, T 7), at head_dim 64, and
   its paged variant with rows past the table (sent to trash block 0,
   which is not compared); K3-dense and K3-paged must give bitwise equal
   q, k and v on the same inputs, and so must a second run.  Every K2 and
   K3 case logs the route its launch took, which must be the ``wgmma``
   route for bf16 with aligned rows and the ``tile`` route for f32 and
   the unaligned vocabulary; then the commit kernels, K4
   (``commit_rows_stacked``) and K5 (``commit_rows_paged_stacked``), over
   three units and over one, for int8, bf16 and f32 rows and f32 scales,
   rows past the end included: the copies exact, the rest of the cache
   (block 0 of a pool excepted) unchanged bit for bit;
4. float32 openPangu-7B at full width, 2 layers: speculative ``generate``
   == ``ar_generate`` token for token, dense, with verify fusion, paged,
   paged with verify fusion, int8, int8 paged and int8 with verify fusion
   (K2 on the unfused int8 write side, no K3), each through the captured
   steps (CUDA graphs, the default), again on the engine's reused cache
   (every step replayed, no new capture) and through the eager steps
   (``graphs=False``): graph tokens == eager tokens == AR tokens; the fp
   variants all give the dense tokens and the int8 variants the int8
   ones; every run launches K1-K5 exactly as ``expected_counts`` says,
   and K1 takes the routes ``decode_plan`` gives the spec step (R 256:
   "single") and the AR step (R 8: "split", with a merge launch each).
   Before them, a captured step that draws from a generator registered
   with its capture must draw the eager draws, fresh at every replay, and
   one that draws from an unregistered generator must fail to capture.
   On every layout ``accept="sample"`` at temperature 0 gives the AR
   tokens (launches exact); dense and fused, at temperature 0.7 the
   captured sampled step gives the eager step's tokens from the same
   seed, and a second run at 0.9 replays the same graph (no new capture)
   and again gives the eager tokens;
4b. the sampled distribution gate: float32 at full width, 2 layers, a
   16-token vocabulary, untrained heads on a cartesian (2, 2) tree, 1024
   rows of one prompt, 5 tokens at temperature 0.9: sampled speculative
   tokens (unfused and fused, through K1-K4) against
   ``ar_generate_sampled``, max marginal TVD <= 1.5 * floor + 0.05;
5. the launcher (``repro_torch.launch.serve.main``) serves 8 requests on
   bf16 openPangu-7B at full width and depth through the captured step
   (one eager warm-up step, then replays of one graph for both groups,
   the capture's seconds logged); every request must finish, the kernels
   launch exactly as expected (K1 per layer and step, on its "single"
   route in phases 5-7, K4 per cache leaf and step), and each answer
   matches ``ar_generate`` (its step captured too) up to its
   first divergence, where AR's logit for the token the speculative path
   emitted must lie within ``MARGIN_BOUND`` of AR's top logit;
6. the launcher with ``--verify-fusion`` answers the same 8 requests on
   the same weights, through K1, K2, K3 and K4 (counts exact), each answer
   held to ``ar_generate`` on the fused config under the same rule; it
   prints how many answers are token-identical to phase 5's and the
   tokens/s of both; every K2 and K3 launch must take the ``wgmma`` route,
   and the tensor maps encoded for weights over the run must be at most
   one per weight tensor (3 per layer for K3, 1 for K2); then (6b) the
   same configuration once more through the eager step (``graphs=False``,
   launches exact), logging the tokens/s of graph and eager, how many of
   the 8 answers are token-identical (expected 8), the capture's
   seconds, wall against device ms per step of the captured fused step,
   and the peak memory with the graph pools;
7. the same weights under the other cache layouts: (a) ``--cache-layout
   paged --verify-fusion`` (K1-paged, K3-paged, K2, K5) must give all 8
   answers of phase 6 token for token, every K2 and K3 launch on the
   ``wgmma`` route; (b) ``--cache-dtype int8``
   (K1-int8, K4) is held to ``ar_generate`` on the int8 config under
   ``MARGIN_BOUND``; (c) ``--cache-dtype int8 --cache-layout paged
   --page-size 16`` (K1-int8+paged, K5) must give all 8 answers of (b);
   7s: ``--accept sample --temperature 0.7``, unfused and fused (K2 at
   per-row temperatures), launches exact, tokens/s, steps, accepted
   length, capture seconds and the replayed step's wall and device ms
   logged beside greedy's, with the peak memory; at ``LOW_TEMPERATURE``
   (where candidates are accepted), unfused and fused, the same readings
   and how many answers the eager step (``graphs=False``, same seed)
   gives token for token; at temperature 0 all 8 answers must equal
   greedy's (phase 5);
8. time every kernel and variant, its plain version, and one PyTorch call
   as a yardstick the port never calls where one computes the same
   function (``scaled_dot_product_attention`` for K1, its backend pinned
   with ``torch.nn.attention.sdpa_kernel`` and named in the log, over the
   dense bf16 view the cache holds: gathered from the pool for K1-paged,
   dequantized to bf16 for K1-int8, neither step timed; for K2 and K3 one
   ``torch.matmul`` of the same product, which does only the product;
   ``index_put_`` of the same rows for K4 and K5) at the main path's
   shapes: for K1, K2 and K3, whose wrappers' host cost is near or above
   the kernel's time, CUDA events around launches queued behind a spin
   kernel so the card runs them back to back (the unqueued reading
   logged beside it); for K4 and K5 the kernels' device time from
   ``torch.profiler``, beside an empty kernel's (``torch.cuda._sleep(0)``:
   a launch's fixed device cost).  K1's rows carry the AR step's (R 8)
   numbers beside the spec step's, K3's the AR step's (T 1); K1's, K2's
   and K3's rows carry the wrapper's host ms per call, and K2's its time
   at ``TMAX_ROWS`` (``tmax_ms``).

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent

# bf16 keeps 8 significant bits.  The top logit of a 153,376-way vocabulary
# with unit-variance logits lies in [4, 8), where one bf16 step is 1/32.
# The speculative step runs 64 tree rows per sequence through each matrix
# product where the AR step runs one, so the two sum in different orders
# and may round a logit to a neighbouring step.  A divergence is accepted
# as a near tie only where AR ranks the speculative path's token less than
# two such steps below its own: a gap of 0 (an exact tie) or one step.
MARGIN_BOUND = 0.0625
H100_BYTES_PER_S = 3.35e12       # HBM3, H100 SXM data sheet
H100_BF16_FLOPS = 989e12         # dense bf16 tensor-core peak
H100_F32_FLOPS = 67e12           # f32 outside the tensor cores

# tests/test_kernels.py::CASES of the reference: B, S, Hq, Hkv, D, tree, dtype
REF_CASES = [
    (2, 1024, 8, 2, 64, "medusa", "float32"),
    (1, 512, 4, 4, 128, "chain", "float32"),
    (3, 2048, 8, 1, 128, "medusa", "bfloat16"),
    (2, 640, 6, 2, 64, "chain", "float32"),
    (1, 256, 2, 2, 256, "chain", "bfloat16"),
    (2, 512, 16, 8, 64, "medusa", "float32"),
]
TOL = {"float32": 3e-5, "bfloat16": 2e-2}
TMAX_ROWS = [0.7, 1.0, 1e-6, 2.0]   # K2's per-row warp temperatures


def log(msg: str):
    print(msg, flush=True)


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def smi_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True, timeout=60)
    return r.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` in ms over ``iters`` back-to-back runs
    (CUDA events; the inputs stay in L2 between runs)."""
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def queued_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` in ms over ``iters`` back-to-back runs,
    the runs queued behind a spin kernel long enough for the host to issue
    them all, so that the card runs them back to back however long the
    host takes per call (CUDA events; for wrappers whose host cost is near
    or above their kernel's time)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    per_call = (time.perf_counter() - t0) / warmup   # host and device
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(int((1.5 * per_call * iters + 2e-3) * 2e9))  # cycles
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean host time of one ``fn()`` call in ms: what the wrapper costs
    the host to issue its launch (no synchronise inside the window; the
    device queue stays far from full)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t * 1e3 / iters


def device_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` in ms: the CUDA kernels' own time
    under ``torch.profiler`` over ``iters`` runs.  For work shorter than
    the host's cost of issuing it, where CUDA events around back-to-back
    runs time the host instead of the card."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
             for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    return us / 1e3 / iters


def scaled_err(got, ref) -> float:
    """max |got - ref| / max(1, |ref|): the absolute error for values below
    1 in magnitude, the relative error above (one bf16 step is 1/32 at
    magnitudes in [4, 8), so a bf16 tolerance of 2e-2 is relative there)."""
    g, r = got.float(), ref.float()
    return ((g - r).abs() / r.abs().clamp(min=1.0)).max().item()


def _wrappers():
    """{kernel: the wrapper whose ``.launches`` counts its main-path
    launches}: K1 (every variant), K2, K3 (dense and paged), K4 (the
    dense commit, ``commit_rows_stacked``) and K5 (the paged commit,
    ``commit_rows_paged_stacked``)."""
    from repro_torch.kernels import cache_update as CU
    from repro_torch.kernels.tree_attention import (flash_decode,
                                                    unembed_verify_stats)
    return {"K1": flash_decode, "K2": unembed_verify_stats,
            "K3": CU.fused_qkv_rope_commit, "K4": CU.commit_rows_stacked,
            "K5": CU.commit_rows_paged_stacked}


def reset_counts():
    for f in _wrappers().values():
        f.launches = 0
        if hasattr(f, "launches_by_route"):
            f.launches_by_route.update(dict.fromkeys(f.launches_by_route, 0))


def read_routes():
    """{kernel: {route: launches}} since ``reset_counts``, for the kernels
    that count their routes (K1, K2 and K3)."""
    return {k: dict(f.launches_by_route) for k, f in _wrappers().items()
            if hasattr(f, "launches_by_route")}


def folded_rows(G, T):
    """K1's query rows for T tree rows and G q heads per kv head: T padded
    until G * T is a multiple of 8, as ``ops.tree_attention`` folds."""
    while (G * T) % 8:
        T += 1
    return G * T


def k1_routes(cfg, B, S, steps, ar_steps=0, T=64):
    """K1's launches by route that ``decode_plan`` gives ``steps`` spec
    steps (T tree rows) and ``ar_steps`` AR steps on ``cfg``, B slots and
    S cache rows: one per layer and step, and a merge per split launch."""
    from repro_torch.kernels.tree_attention import decode_plan
    from repro_torch.runtime import torch_dtype

    G = cfg.num_heads // cfg.num_kv_heads
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    want = {"single": 0, "split": 0, "merge": 0}
    for t, n in ((T, steps), (1, ar_steps)):
        route = decode_plan(B, cfg.num_kv_heads, folded_rows(G, t), S,
                            torch_dtype(cfg.dtype), n_sm).route
        want[route] += n * cfg.num_layers
        if route == "split":
            want["merge"] += n * cfg.num_layers
    return want


def check_routes(label, counts, k1_want=None):
    """K1's launches took the routes ``decode_plan`` gives the run
    (``k1_want``, from ``k1_routes``); with ``counts`` given, every K2 and
    K3 launch of a bf16 main-path run took the wgmma route."""
    routes = read_routes()
    log(f"  routes {routes}")
    if k1_want is not None and routes["K1"] != k1_want:
        fail(f"{label}: K1 launches by route {routes['K1']}, expected "
             f"{k1_want}")
    if counts is None:
        return
    for k in ("K2", "K3"):
        by = routes[k]
        if by["tile"] or by["wgmma"] != counts[k]:
            fail(f"{label}: {k} launches by route {by}, expected all "
                 f"{counts[k]} on the wgmma route")


def read_counts():
    """{kernel: launches} since ``reset_counts``, after the device is
    done."""
    torch.cuda.synchronize()
    return {k: f.launches for k, f in _wrappers().items()}


def uncounted(fn, *args, **kwargs):
    """Call a kernel wrapper without counting the launch: comparison and
    timing launches are not main-path launches."""
    saved = fn.launches
    routes = dict(getattr(fn, "launches_by_route", {}))
    out = fn(*args, **kwargs)
    fn.launches = saved
    if routes:
        fn.launches_by_route.update(routes)
    return out


def routed(fn, *args, **kwargs):
    """``uncounted`` call of a wrapper that counts its routes; returns (its
    result, the route its launch took: for K1 "single" or "split", whose
    merge launch is not returned)."""
    before = dict(fn.launches_by_route)
    out = fn(*args, **kwargs)
    took = [r for r, n in fn.launches_by_route.items() if n != before[r]]
    fn.launches -= 1
    fn.launches_by_route.update(before)
    return out, took[0]


def want_k1_route(name, route, B, Hkv, R, S, dt):
    """K1 takes the route ``decode_plan`` gives the launch's shapes."""
    from repro_torch.kernels.tree_attention import decode_plan

    want = decode_plan(B, Hkv, R, S, dt,
                       torch.cuda.get_device_properties(0)
                       .multi_processor_count).route
    if route != want:
        fail(f"{name}: took the {route} route, expected {want}")


def want_route(name, route, dt, aligned=True):
    """K2 and K3 take the wgmma route for bf16 with aligned rows, else the
    tile route."""
    want = "wgmma" if dt == torch.bfloat16 and aligned else "tile"
    if route != want:
        fail(f"{name}: took the {route} route, expected {want}")


def padded_batch(prompts, rows):
    """Right-padded [B, S] int32 tokens and [B] lengths for ``rows``
    (indices into ``prompts``), exactly as the launcher pads a group."""
    S = max(len(prompts[i]) for i in rows)
    tok = np.zeros((len(rows), S), np.int32)
    plen = np.zeros((len(rows),), np.int32)
    for j, i in enumerate(rows):
        tok[j, :len(prompts[i])] = prompts[i]
        plen[j] = len(prompts[i])
    return tok, plen


# ---------------------------------------------------------------------------
# phase 2: the kernel against its plain version
# ---------------------------------------------------------------------------

def stats_errors(got, ref):
    """Max errors of (acc, m, l) against the plain version: the normalised
    output acc / l (what the merge consumes), m, and l relative."""
    acc, m, l = got
    racc, rm, rl = ref
    out = (acc / l - racc / rl).abs().max().item()
    em = (m - rm).abs().max().item()
    el = (l / rl - 1).abs().max().item()
    return max(out, em, el), out


def phase_kernels(dev):
    from repro_torch.core.tree import chain_tree, medusa_63
    from repro_torch.kernels.ops import tree_attention
    from repro_torch.kernels.ref import tree_attention_ref
    from repro_torch.kernels.tree_attention import (flash_decode,
                                                    flash_decode_plain)
    from repro_torch.runtime import torch_dtype

    rng = np.random.default_rng(0)
    main_err = 0.0

    def folded_case(name, B, S, Hkv, R, D, dt, lengths):
        nonlocal main_err
        q = torch.from_numpy(rng.standard_normal((B, Hkv, R, D))).to(dev, dt)
        q = q * (1.0 / np.sqrt(D))
        k = torch.from_numpy(rng.standard_normal((B, S, Hkv, D))).to(dev, dt)
        v = torch.from_numpy(rng.standard_normal((B, S, Hkv, D))).to(dev, dt)
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        got, route = routed(flash_decode, q, k, v, lens)
        want_k1_route(f"flash_decode {name}", route, B, Hkv, R, S, dt)
        ref = flash_decode_plain(q, k, v, lens)
        torch.cuda.synchronize()
        err, out_err = stats_errors(got, ref)
        tol = TOL["bfloat16" if dt == torch.bfloat16 else "float32"]
        log(f"  flash_decode {name}: B={B} S={S} Hkv={Hkv} R={R} D={D} "
            f"{dt} lengths={lengths}, {route} route: max err {err:.3e} "
            f"(tol {tol})")
        if not err < tol:
            fail(f"flash_decode {name} disagrees with its plain version: "
                 f"{err} >= {tol}")
        if name == "main R=256" and dt == torch.bfloat16:
            main_err = out_err

    for B, S, Hq, Hkv, D, tree, dname in REF_CASES:
        tb = medusa_63() if tree == "medusa" else chain_tree(4)
        T, G = tb.T, Hq // Hkv
        T_pad = T
        while (G * T_pad) % 8:
            T_pad += 1
        dt = torch_dtype(dname)
        lengths = rng.integers(1, S - T - 1, size=(B,)).tolist()
        folded_case(f"ref sweep {tree}", B, S, Hkv, G * T_pad, D, dt, lengths)
        # the whole tree attention, kernel path, against the oracle
        q = torch.from_numpy(rng.standard_normal((B, T, Hq, D))).to(dev, dt)
        k = torch.from_numpy(rng.standard_normal((B, S, Hkv, D))).to(dev, dt)
        v = torch.from_numpy(rng.standard_normal((B, S, Hkv, D))).to(dev, dt)
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        mask = torch.from_numpy(tb.mask).to(dev)
        scale = 1.0 / np.sqrt(D)
        out_k = tree_attention(q, k, v, mask, lens, scale)
        out_r = tree_attention_ref(q, k, v, mask, lens, scale)
        err = (out_k.float() - out_r.float()).abs().max().item()
        log(f"  tree_attention vs oracle: B={B} S={S} Hq={Hq} Hkv={Hkv} D={D} "
            f"{tree} {dname}: max err {err:.3e} (tol {TOL[dname]})")
        if not err < TOL[dname]:
            fail(f"tree_attention disagrees with the oracle: {err}")
    # the main path's shapes: 4 rows, 8 kv heads, head_dim 128, 2048 rows
    ragged = [1, 517, 1300, 2048]
    for dt in (torch.float32, torch.bfloat16):
        folded_case("main R=256", 4, 2048, 8, 256, 128, dt, ragged)
        folded_case("main R=8", 4, 2048, 8, 8, 128, dt, ragged)
        # short rows: most of the 32 splits start past the length
        folded_case("main R=8 short", 4, 2048, 8, 8, 128, dt,
                    [1, 64, 65, 190])
    return main_err


def shuffled_table(B, mb, dev, seed):
    """[B, mb] int32 on ``dev``: a random permutation of blocks
    1 .. B * mb (block 0 is the trash block)."""
    perm = np.random.default_rng(seed).permutation(B * mb) + 1
    return torch.from_numpy(perm.reshape(B, mb).astype(np.int32)).to(dev)


def to_pool(dense, table, ps, gen):
    """Pool [1 + B*mb, ps, ...] holding ``dense`` [B, mb*ps, ...] through
    ``table``; block 0 and the blocks of idle slots hold noise."""
    B, mb = table.shape
    pool = torch.randn((1 + B * mb, ps) + tuple(dense.shape[2:]),
                       generator=gen, device=dense.device).to(dense.dtype)
    pool[table.long()] = dense.reshape((B, mb, ps) + tuple(dense.shape[2:]))
    return pool


def variant_case(dev, name, B, S, Hkv, R, D, dt, lengths, quantized, ps,
                 seed):
    """K1's int8 / paged / int8 + paged variant against its plain version,
    on a shuffled table; a paged slot of length 0 gets a zero table (an
    idle slot).  A paged run must also be bitwise the dense kernel's run
    on the same logical rows.  Returns the max error of the live rows."""
    from repro_torch.kernels.quant import quantize_rows
    from repro_torch.kernels.tree_attention import (flash_decode,
                                                    flash_decode_plain)

    gen = torch.Generator(device=dev).manual_seed(seed)
    q = (torch.randn((B, Hkv, R, D), generator=gen, device=dev)
         * D ** -0.5).to(dt)
    kd = torch.randn((B, S, Hkv, D), generator=gen, device=dev).to(dt)
    vd = torch.randn((B, S, Hkv, D), generator=gen, device=dev).to(dt)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    leaves = {"k": kd, "v": vd}
    if quantized:
        (k8, ks), (v8, vs) = quantize_rows(kd), quantize_rows(vd)
        leaves = {"k": k8, "v": v8, "k_scale": ks, "v_scale": vs}
    dense_kw = {n: leaves[n] for n in ("k_scale", "v_scale") if n in leaves}
    kw = dict(dense_kw)
    k, v = leaves["k"], leaves["v"]
    if ps:
        table = shuffled_table(B, S // ps, dev, seed)
        table[lens == 0] = 0
        pools = {n: to_pool(t, table, ps, gen) for n, t in leaves.items()}
        k, v = pools["k"], pools["v"]
        kw = {n: pools[n] for n in dense_kw}
        kw["block_tables"] = table
    got, route = routed(flash_decode, q, k, v, lens, **kw)
    what = ("int8" if quantized else "fp") + (f" paged ps={ps}" if ps else "")
    want_k1_route(f"flash_decode {what} {name}", route, B, Hkv, R, S, dt)
    ref = flash_decode_plain(q, k, v, lens, **kw)
    torch.cuda.synchronize()
    live = lens > 0
    err, out_err = stats_errors([x[live] for x in got],
                                [x[live] for x in ref])
    idle_ok = ((got[0][~live] == 0).all() and (got[2][~live] == 0).all()
               and (got[1][~live] == -1e30).all())
    same = True
    if ps:
        dense = uncounted(flash_decode, q, leaves["k"], leaves["v"], lens,
                          **dense_kw)
        same = all(torch.equal(a, b) for a, b in zip(got, dense))
    tol = TOL["bfloat16" if dt == torch.bfloat16 else "float32"]
    log(f"  flash_decode {what} {name}: B={B} S={S} Hkv={Hkv} R={R} D={D} "
        f"{dt} lengths={lengths}, {route} route: max err {err:.3e} "
        f"(tol {tol})"
        + ("; bitwise equal to the dense kernel" if ps else ""))
    if not err < tol:
        fail(f"flash_decode {what} {name} disagrees with its plain version: "
             f"{err} >= {tol}")
    if not idle_ok:
        fail(f"flash_decode {what} {name}: an idle slot's statistics are "
             f"not empty")
    if not same:
        fail(f"flash_decode {what} {name}: the paged run differs from the "
             f"dense run on the same rows")
    return out_err


def phase_kernel_variants(dev):
    """K1-int8, K1-paged and K1-int8+paged at the reference sweep and the
    main path's shapes, page sizes 16, 64 and 128.  Returns the max error
    of the normalised output of each variant at the bf16 main shape
    (R 256, page size 64)."""
    from repro_torch.core.tree import chain_tree, medusa_63
    from repro_torch.runtime import torch_dtype

    rng = np.random.default_rng(5)
    sizes = (16, 64, 128)
    for i, (B, S, Hq, Hkv, D, tree, dname) in enumerate(REF_CASES):
        T, G = (medusa_63() if tree == "medusa" else chain_tree(4)).T, \
            Hq // Hkv
        T_pad = T
        while (G * T_pad) % 8:
            T_pad += 1
        dt = torch_dtype(dname)
        lengths = rng.integers(1, S + 1, size=(B,)).tolist()
        if B > 1:
            lengths[0] = 0                       # an idle slot
        args = (dev, "ref sweep", B, S, Hkv, G * T_pad, D, dt, lengths)
        variant_case(*args, True, 0, i)
        variant_case(*args, False, sizes[i % 3], i)
        variant_case(*args, True, sizes[(i + 1) % 3], i)
    main = {}
    for dt in (torch.float32, torch.bfloat16):
        for R in (256, 8):
            args = (dev, f"main R={R}", 4, 2048, 8, R, 128, dt)
            err = variant_case(*args, [1, 517, 1300, 2048], True, 0, R)
            if dt == torch.bfloat16 and R == 256:
                main["int8"] = err
            for ps in sizes:
                for quantized in (False, True):
                    err = variant_case(*args, [0, 517, 1300, 2048],
                                       quantized, ps, R + ps)
                    if dt == torch.bfloat16 and R == 256 and ps == 64:
                        main["int8+paged" if quantized else "paged"] = err
        # R 8 with short rows and an idle slot: most splits start past the
        # length, and the idle slot's are all empty
        args = (dev, "main R=8 short", 4, 2048, 8, 8, 128, dt,
                [0, 64, 65, 190])
        variant_case(*args, True, 0, 3)
        for ps in sizes:
            for quantized in (False, True):
                variant_case(*args, quantized, ps, 4 + ps)
    return main


# ---------------------------------------------------------------------------
# phase 3: the verify-fusion kernels against their plain versions
# ---------------------------------------------------------------------------

def bf16_step(x):
    """One bf16 step (8 significant bits) at the magnitude of ``x``."""
    return 2.0 ** (np.floor(np.log2(max(abs(x), 1e-30))) - 7)


def stats_case(dev, name, B, T, d, V, dt, tied=False, tmax=None):
    """K2 against its plain version; returns the max abs error of m and
    cand_w.  V not a multiple of 8 leaves rows TMA cannot take (tile
    route).  ``tmax`` (one per row; default ones) are the rows' warp
    temperatures: then m, l and cand_w must also be finite, l at least
    1, and argm exactly the kernel's own at tmax 1 on the same inputs
    (dividing a row by a positive temperature cannot move its argmax).
    The returned error is in the divided logits' units."""
    from repro_torch.kernels.tree_attention import (
        unembed_verify_stats, unembed_verify_stats_plain)

    gen = torch.Generator(device=dev).manual_seed(1)
    h = torch.randn((B, T, d), generator=gen, device=dev).to(dt)
    w = (torch.randn((d, V), generator=gen, device=dev) * d ** -0.5).to(dt)
    cand = torch.randint(0, V, (B, T), generator=gen, device=dev,
                         dtype=torch.int32)
    cand[:, -1] = V - 1                       # in the last, partial tile
    tied_cols = [V // 8 + 8, V // 2 + 1, V - 3] if tied else []
    if tied:
        # equal columns in three tiles: logit 4 * 8 = 32 in every row,
        # above every other logit, so all three tie for the max exactly
        h[..., 0] = 8.0
        w[:, tied_cols] = 0.0
        w[0, tied_cols] = 4.0
        cand[:, :3] = torch.tensor(tied_cols, device=dev)
    ones = torch.ones((B,), device=dev)
    tmax = ones if tmax is None else torch.tensor(tmax, dtype=torch.float32,
                                                  device=dev)
    (argm, m, l, cw), route = routed(unembed_verify_stats, h, w, cand, tmax)
    want_route(f"unembed_verify_stats {name}", route, dt, V % 8 == 0)
    rargm, rm, rl, rcw = unembed_verify_stats_plain(h, w, cand, tmax)
    torch.cuda.synchronize()
    if tmax is not ones:
        argm1 = uncounted(unembed_verify_stats, h, w, cand, ones)[0]
        finite = all(bool(torch.isfinite(x).all()) for x in (m, l, cw))
        if not finite or bool((l < 1).any()) \
                or not torch.equal(argm, argm1):
            fail(f"unembed_verify_stats {name}: at tmax {tmax.tolist()} "
                 f"finite {finite}, min l {l.min().item()}, argm equal to "
                 f"tmax 1's {torch.equal(argm, argm1)}")
    # m and cand_w are the logits divided by the row's tmax: compared in
    # the logits' own units (times tmax), where the tmax 1 tolerance holds
    # (divided by 1e-6, a logit's f32 rounding grows a millionfold)
    t2, t3 = tmax[:, None], tmax[:, None, None]
    err = max(scaled_err(m * t2, rm * t2), scaled_err(cw * t3, rcw * t3),
              (l / rl - 1).abs().max().item())
    abs_err = max((m - rm).abs().max().item(), (cw - rcw).abs().max().item())
    differ = (argm != rargm).nonzero().tolist()
    worst = 0.0
    if differ and dt == torch.float32:
        fail(f"unembed_verify_stats {name}: argm differs from the plain "
             f"version in f32 at {differ[:8]}")
    if differ:
        # bf16: the two products may round a logit to a neighbouring step;
        # the plain logit at the kernel's argm must lie within one bf16
        # step of the plain max (both divided by the row's tmax)
        logits = torch.matmul(h, w).float() / tmax[:, None, None]
        for b, t in differ:
            gap = (rm[b, t] - logits[b, t, argm[b, t]]).item()
            worst = max(worst, gap / bf16_step(rm[b, t].item()))
            if gap > bf16_step(rm[b, t].item()):
                fail(f"unembed_verify_stats {name}: argm {argm[b, t]} at "
                     f"({b}, {t}) is {gap} below the plain max")
    if tied and not ((argm == tied_cols[0]).all()
                     and (rargm == tied_cols[0]).all()):
        fail(f"unembed_verify_stats {name}: tied columns {tied_cols}, argm "
             f"{argm.unique().tolist()} (plain {rargm.unique().tolist()})")
    tol = TOL["bfloat16" if dt == torch.bfloat16 else "float32"]
    at = "" if tmax is ones else f" at tmax {tmax.tolist()}"
    log(f"  unembed_verify_stats {name}: B={B} T={T} d={d} V={V} {dt}{at}, "
        f"{route} route: "
        f"max err {err:.3e} (tol {tol}; abs {abs_err:.3e}); argm differs in "
        f"{len(differ)} of {B * T} rows (largest gap {worst:.2f} bf16 steps)")
    if not err < tol:
        fail(f"unembed_verify_stats {name} disagrees with its plain version: "
             f"{err} >= {tol}")
    return abs_err


def qkv_inputs(dev, cfg, T, dt, lengths, S=2048, bias=False, ps=0):
    """K3's inputs at ``cfg``'s attention widths: (x, p, lens, kc, vc,
    cos, sin, table); with ``ps`` the caches are pools of that page size
    read through a shuffled table, else None."""
    from repro_torch.models.layers import rope_cos_sin

    B, d, Hq, Hkv, hd = (len(lengths), cfg.d_model, cfg.num_heads,
                         cfg.num_kv_heads, cfg.resolved_head_dim)
    gen = torch.Generator(device=dev).manual_seed(2)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dt)

    x = rnd(B, T, d)
    p = {"wq": rnd(d, Hq, hd, scale=d ** -0.5),
         "wk": rnd(d, Hkv, hd, scale=d ** -0.5),
         "wv": rnd(d, Hkv, hd, scale=d ** -0.5)}
    if bias:
        p |= {"bq": rnd(Hq, hd, scale=0.1), "bk": rnd(Hkv, hd, scale=0.1),
              "bv": rnd(Hkv, hd, scale=0.1)}
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    table = None
    if ps:
        table = shuffled_table(B, S // ps, dev, T)
        kc, vc = rnd(1 + B * S // ps, ps, Hkv, hd), rnd(1 + B * S // ps, ps,
                                                         Hkv, hd)
    else:
        kc, vc = rnd(B, S, Hkv, hd), rnd(B, S, Hkv, hd)
    cos, sin = rope_cos_sin(lens[:, None] + torch.arange(T, device=dev), hd,
                            cfg.rope_theta)
    return x, p, lens, kc, vc, cos, sin, table


def qkv_case(dev, cfg, name, T, dt, lengths, S=2048, bias=False, ps=0):
    """K3 against its plain version at ``cfg``'s attention widths; with
    ``ps`` the caches are pools of that page size read through a shuffled
    table (rows past it go to trash block 0, which is not compared).
    Returns the max abs error."""
    from repro_torch.kernels import paging as P
    from repro_torch.kernels.cache_update import (
        fused_qkv_rope_commit, fused_qkv_rope_commit_plain)

    B, d, Hq, Hkv, hd = (len(lengths), cfg.d_model, cfg.num_heads,
                         cfg.num_kv_heads, cfg.resolved_head_dim)
    x, p, lens, kc, vc, cos, sin, table = qkv_inputs(dev, cfg, T, dt, lengths,
                                                     S, bias, ps)
    k0, v0 = kc.clone(), vc.clone()
    k1, v1 = kc.clone(), vc.clone()
    got, route = routed(fused_qkv_rope_commit, x, p, lens, kc, vc, cos=cos,
                        sin=sin, table=table)
    where = f" paged ps={ps}" if ps else ""
    want_route(f"fused_qkv_rope_commit{where} {name}", route, dt)
    ref = fused_qkv_rope_commit_plain(x, p, lens, k1, v1, cos=cos, sin=sin,
                                      table=table)
    torch.cuda.synchronize()
    if ps:
        # compare the pools without trash block 0
        kc, vc, k0, v0, k1, v1 = (t[1:] for t in (kc, vc, k0, v0, k1, v1))
    pairs = list(zip((*got, kc, vc), (*ref, k1, v1)))
    err = max(scaled_err(g, r) for g, r in pairs)
    abs_err = max((g.float() - r.float()).abs().max().item() for g, r in pairs)
    if ps:
        rows = P.phys_rows(table, lens, T, ps).reshape(-1)
        written = torch.zeros(kc.shape[0] * ps + ps, dtype=torch.bool,
                              device=dev)
        written[rows] = True
        kept = ~written[ps:].reshape(kc.shape[0], ps)
    else:
        pos = torch.arange(S, device=dev)[None, :]
        kept = ~((pos >= lens[:, None]) & (pos < lens[:, None] + T))
    if not (torch.equal(kc[kept], k0[kept]) and torch.equal(vc[kept],
                                                           v0[kept])):
        fail(f"fused_qkv_rope_commit {name}: cache rows outside "
             f"[lengths, lengths + T) changed")
    tol = TOL["bfloat16" if dt == torch.bfloat16 else "float32"]
    log(f"  fused_qkv_rope_commit{where} {name}: B={B} T={T} d={d} Hq={Hq} "
        f"Hkv={Hkv} hd={hd} S={S} {dt}, {route} route, lengths={lengths}: "
        f"max err "
        f"{err:.3e} (tol {tol}; abs {abs_err:.3e}); rest of the cache "
        f"unchanged")
    if not err < tol:
        fail(f"fused_qkv_rope_commit{where} {name} disagrees with its plain "
             f"version: {err} >= {tol}")
    return abs_err


def qkv_same_case(dev, cfg, T, dt, lengths, ps=64):
    """K3-dense and K3-paged on the same inputs give bitwise equal q, k and
    v, and a second run of each gives them again: no step of the sum
    depends on timing or on the cache layout."""
    from repro_torch.kernels.cache_update import fused_qkv_rope_commit

    x, p, lens, kc, vc, cos, sin, _ = qkv_inputs(dev, cfg, T, dt, lengths)
    _, _, _, pk, pv, _, _, table = qkv_inputs(dev, cfg, T, dt, lengths,
                                              ps=ps)
    runs = [uncounted(fused_qkv_rope_commit, x, p, lens, kc, vc, cos=cos,
                      sin=sin, table=t) if t is None else
            uncounted(fused_qkv_rope_commit, x, p, lens, pk, pv, cos=cos,
                      sin=sin, table=t)
            for t in (None, table, None, table)]
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for run in runs[1:]
               for a, b in zip(runs[0], run))
    log(f"  fused_qkv_rope_commit dense vs paged ps={ps}: T={T} {dt} "
        f"lengths={lengths}: q, k, v bitwise equal over 2 runs of each: "
        f"{same}")
    if not same:
        fail(f"fused_qkv_rope_commit T={T} {dt}: dense and paged (or two "
             f"runs) differ")


def commit_case(dev, name, dtype, width, paged, nu=3, S=2048, ps=64):
    """K4 (``commit_rows_stacked``) or K5 (``commit_rows_paged_stacked``)
    against its plain version: 5 rows per slot of 4 slots in every one of
    ``nu`` units, and in one cache (``nu`` 1, the reference's one-cache
    form), rows of [8, width] ``dtype`` elements, starts in range,
    straddling and past the end.  Copies must be exact and the rest of the
    cache (block 0 of a pool excepted) unchanged bit for bit."""
    from repro_torch.kernels import cache_update as CU

    gen = torch.Generator(device=dev).manual_seed(6)

    def rnd(*shape):
        if dtype == torch.int8:
            return torch.randint(-127, 128, shape, generator=gen, device=dev,
                                 dtype=torch.int8)
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    B, K1, H = 4, 5, 8
    lens = torch.tensor([0, 517, S - 2, S], dtype=torch.int32, device=dev)
    rows = rnd(nu, B, K1, H, width)
    if paged:
        table = shuffled_table(B, S // ps, dev, 7)
        cache = rnd(nu, 1 + B * S // ps, ps, H, width)
        fn, plain, extra = (CU.commit_rows_paged_stacked,
                            CU.commit_rows_paged_stacked_plain, (table,))
    else:
        cache = rnd(nu, B, S, H, width)
        fn, plain, extra = (CU.commit_rows_stacked,
                            CU.commit_rows_stacked_plain, ())

    def body(t):                          # a pool without trash block 0
        return t[:, 1:] if paged else t

    refs = []
    for c, r in ((cache, rows), (cache[:1], rows[:1])):
        got, ref = c.clone(), c.clone()
        uncounted(fn, got, *extra, r, lens)
        plain(ref, *extra, r, lens)
        torch.cuda.synchronize()
        if not torch.equal(body(got), body(ref)):
            fail(f"{fn.__name__} {name} ({c.shape[0]} units): the kernel's "
                 f"write differs from its plain version")
        refs.append(ref)
    # the plain version writes exactly the rows (and only them): check it
    # against a row-by-row copy
    want = cache.clone()
    for b, n in enumerate(lens.tolist()):
        for j in range(K1):
            pos = n + j
            if paged:
                blk = table[b, pos // ps].item() if pos // ps < S // ps else 0
                if blk:
                    want[:, blk, pos % ps] = rows[:, b, j]
            elif pos < S:
                want[:, b, pos] = rows[:, b, j]
    if not torch.equal(body(refs[0]), body(want)):
        fail(f"commit {name}: rows misplaced or the rest of the cache "
             f"changed")
    log(f"  {fn.__name__} {name}: nu={nu} and 1, B={B} K1={K1} rows "
        f"[{H}, {width}] {dtype}, lengths {lens.tolist()}"
        + (f", page size {ps}" if paged else f", S={S}")
        + ": exact, the rest unchanged")


def phase_fusion_kernels(dev):
    """K2 and K3 (dense and paged) at openPangu-7B's widths (B 4, T 64: the
    spec step; T 1: the AR step).  Returns their max abs errors at the main
    bf16 spec-step shape."""
    from repro_torch.configs.registry import get_config

    cfg = get_config("openpangu-7b")
    cfg64 = dataclasses.replace(cfg, head_dim=64)
    d, V = cfg.d_model, cfg.vocab_size
    errs = {}
    for dt in (torch.float32, torch.bfloat16):
        errs["K2", dt] = stats_case(dev, "main", 4, 64, d, V, dt)
        # the sampled step's per-row temperatures; 1e-6 is temperature 0
        stats_case(dev, "per-row tmax", 4, 64, d, V, dt, tmax=TMAX_ROWS)
        stats_case(dev, "tied columns", 4, 64, d, V, dt, tied=True)
        stats_case(dev, "V 4099 (unaligned rows)", 2, 64, 512, 4099, dt)
        if dt == torch.bfloat16:
            # the wgmma route's row tiling: two row tiles, and one mostly
            # padding (f32 takes the tile route, checked above)
            stats_case(dev, "N 512", 8, 64, d, V, dt)
            stats_case(dev, "N 64", 1, 64, d, V, dt)
        ragged = [1, 517, 1300, 1984]
        errs["K3", dt] = qkv_case(dev, cfg, "spec", 64, dt, ragged)
        qkv_case(dev, cfg, "AR", 1, dt, ragged)
        qkv_case(dev, cfg, "spec with biases", 64, dt, ragged, bias=True)
        qkv_case(dev, cfg, "rows past S", 64, dt, [2040, 0, 2047, 100])
        qkv_case(dev, cfg, "B 3 (M 192)", 64, dt, [1, 517, 1300])
        qkv_case(dev, cfg, "T 7 (M 28)", 7, dt, ragged)
        qkv_case(dev, cfg64, "head_dim 64, spec", 64, dt, ragged)
        qkv_case(dev, cfg64, "head_dim 64, AR", 1, dt, ragged, ps=16)
        for T in (64, 1):
            qkv_same_case(dev, cfg, T, dt, ragged)
        errs["K3-paged", dt] = qkv_case(dev, cfg, "spec", 64, dt, ragged,
                                        ps=64)
        qkv_case(dev, cfg, "AR", 1, dt, ragged, ps=16)
        qkv_case(dev, cfg, "rows past the table", 64, dt,
                 [2040, 0, 2047, 100], ps=128)
        qkv_case(dev, cfg, "AR past the table", 1, dt, [2048, 5, 2047, 63],
                 ps=64)
    return (errs["K2", torch.bfloat16], errs["K3", torch.bfloat16],
            errs["K3-paged", torch.bfloat16])


def phase_commit_kernels(dev):
    """K4 and K5 for int8 values, bf16 and f32 rows and the int8 layout's
    f32 scales, with rows past the end."""
    for paged in (False, True):
        for dtype, width in ((torch.int8, 128), (torch.bfloat16, 128),
                             (torch.float32, 128), (torch.float32, 1)):
            commit_case(dev, f"{dtype} x {width}", dtype, width, paged)
        if paged:
            commit_case(dev, "page size 16, bf16", torch.bfloat16, 128, paged,
                        ps=16)


# ---------------------------------------------------------------------------
# phase 4: float32, full width, 2 layers: spec == AR exactly, fused too
# ---------------------------------------------------------------------------

def expected_counts(cfg, steps: int, ar_steps: int = 0):
    """Launches of each kernel for ``steps`` spec steps and ``ar_steps`` AR
    steps on ``cfg``: K1 once per layer and step; with verify fusion K2
    once per spec step and, on an fp cache, K3 once per layer and step;
    the commit once per cache leaf (k and v, and their scales under int8)
    and spec step, through K4 on the dense cache and K5 on the paged
    pool."""
    per_layer = cfg.num_layers * (steps + ar_steps)
    quantized = cfg.resolved_cache_dtype == "int8"
    commits = (4 if quantized else 2) * steps
    fused = cfg.verify_fusion
    return {"K1": per_layer, "K2": steps if fused else 0,
            "K3": per_layer if fused and not quantized else 0,
            "K4": 0 if cfg.paged else commits,
            "K5": commits if cfg.paged else 0}


def kept_graphs(eng):
    """[(label, StepGraph)] of the step graphs ``eng`` keeps."""
    from repro_torch.core.engine import SpecCarry
    return [("spec" if isinstance(c, SpecCarry) else "AR", g)
            for g, c in eng.step_graphs.kept()]


def phase_graph_rng(dev):
    """The captured step's randomness: a step that draws from a generator
    registered with its capture draws fresh noise at every replay, the
    noise the same steps draw eagerly from the same generator state; a
    capture whose step draws from a generator that is not registered
    raises (no eager fallback), and the card works on after it."""
    from repro_torch import runtime
    from repro_torch.core import sampling as S

    gen = torch.Generator(device=dev).manual_seed(0)
    buf = torch.empty((4, 153376), device=dev)
    graph = runtime.StepGraph(lambda: buf.copy_(S.gumbel(buf.shape, gen)),
                              dev, generators=(gen,))
    seen = []
    for _ in range(5):
        graph()
        seen.append(buf.clone())
    gen.manual_seed(0)
    eager = [S.gumbel(buf.shape, gen) for _ in range(5)]
    same = [torch.equal(a, b) for a, b in zip(seen, eager)]
    fresh = [not torch.equal(a, b) for a, b in zip(seen, seen[1:])]
    log(f"  registered generator: warm-up, capture and {graph.replays} "
        f"replays drew the eager draws {same}; each draw differs from the "
        f"one before {fresh}")
    if not (all(same) and all(fresh)) or graph.replays != 4:
        fail("a captured step's draws are not the eager draws, or a replay "
             "repeated the noise of the one before")
    other = torch.Generator(device=dev).manual_seed(1)
    bad = runtime.StepGraph(lambda: buf.copy_(S.gumbel(buf.shape, other)),
                            dev)
    bad()                                   # the eager warm-up draws
    try:
        bad()
    except RuntimeError as e:
        log(f"  unregistered generator: the capture raised ({e}; cause: "
            f"{str(e.__cause__).splitlines()[0][:160]})")
    else:
        fail("a capture drew from a generator not registered with it and "
             "did not raise")
    if bad.graph is not None or float(torch.ones(8, device=dev).sum()) != 8:
        fail("the card did not work on after the refused capture")


def phase_f32(dev):
    """Float32 openPangu-7B at full width, 2 layers, on every cache layout:
    spec == AR token for token through the captured steps, a second run on
    the reused cache replays them without a new capture, and the eager
    steps give the same tokens; launch counts exact on every run.  On
    every layout ``accept="sample"`` at temperature 0 gives the AR tokens
    too; at temperature 0.7 (dense, and with verify fusion) the captured
    sampled step gives the eager step's tokens from the same generator
    seed, and a second run at temperature 0.9 replays the same graph
    with no new capture and again gives the eager tokens."""
    from repro_torch.configs.base import SamplingParams
    from repro_torch.configs.registry import get_config
    from repro_torch.core.engine import ar_generate, build_engine
    from repro_torch.launch.serve import build_model, make_prompts

    base = dataclasses.replace(get_config("openpangu-7b"), num_layers=2,
                               dtype="float32", param_dtype="float32",
                               name="openpangu-7b-2layer-f32")
    params, mp = build_model(base, 1, 4, dev)
    prompts = make_prompts(base.vocab_size, 4, 1, 16, 129)
    tok, plen = padded_batch(prompts, range(4))
    tok = torch.from_numpy(tok).to(dev)
    plen = torch.from_numpy(plen).to(dev)
    max_new, max_len = 32, 512

    def counted_run(label, eng):
        """spec and AR on ``eng``'s cache (its graphs, or eager), the
        counts set to 0 just before and checked just after."""
        reset_counts()
        sp, _, st = eng.generate(params, mp, tok, plen,
                                 eng.init_cache(4, max_len), max_new)
        ar, _ = ar_generate(eng.cfg, params, tok, plen,
                            eng.init_cache(4, max_len), max_new,
                            use_kernel=True, graphs=eng.step_graphs)
        counts = read_counts()
        want = expected_counts(eng.cfg, st.steps, max_new)
        if counts != want:
            fail(f"f32 {label}: launches {counts}, expected {want}")
        ps = eng.cfg.page_size if eng.cfg.paged else 1
        check_routes(f"f32 {label}", None,
                     k1_routes(eng.cfg, 4, -(-max_len // ps) * ps, st.steps,
                               max_new, T=eng.tb.T))
        return sp.cpu(), ar.cpu(), st, counts

    def sampled(cfg, verify_fusion, temperature, graphs=True):
        return build_engine(cfg, "medusa", use_kernel=True, device=dev,
                            verify_fusion=verify_fusion, graphs=graphs,
                            accept="sample", seed=11,
                            sampling=SamplingParams(temperature=temperature))

    def sampled_run(label, eng, **kw):
        """One sampled generate, its launches exact."""
        reset_counts()
        out, n_out, st = eng.generate(params, mp, tok, plen,
                                      eng.init_cache(4, max_len), max_new,
                                      **kw)
        counts = read_counts()
        want = expected_counts(eng.cfg, st.steps)
        if counts != want or not bool((n_out == max_new).all()):
            fail(f"f32 sampled {label}: launches {counts}, expected {want}; "
                 f"n_out {n_out.tolist()}")
        return out.cpu(), st

    def sampled_zero(label, cfg, verify_fusion, ar):
        out, st = sampled_run(label + " at temperature 0",
                              sampled(cfg, verify_fusion, 0.0))
        if not torch.equal(out, ar):
            fail(f"float32 {label}: sampled at temperature 0 != AR:\n"
                 f"{out.tolist()}\n{ar.tolist()}")
        log(f"  f32 {label}: accept=sample at temperature 0 == AR for 4 x "
            f"{max_new} tokens ({st.steps} steps, launches exact)")

    def sampled_hot(label, cfg, verify_fusion, greedy):
        eng, eager = (sampled(cfg, verify_fusion, 0.7, g)
                      for g in (True, False))
        out, st = sampled_run(label + " at 0.7", eng)
        e_out, _ = sampled_run(label + " at 0.7 (eager)", eager)
        graphs = kept_graphs(eng)
        replays = {k: g.replays for k, g in graphs}
        out2, st2 = sampled_run(label + " at 0.9 (second run)", eng,
                                temperature=0.9)
        e_out2, _ = sampled_run(label + " at 0.9 (eager, second run)", eager,
                                temperature=0.9)
        again = {k: g.replays - replays[k] for k, g in kept_graphs(eng)}
        log(f"  f32 {label}: sampled at temperature 0.7, graph == eager "
            f"{torch.equal(out, e_out)} ({int((out != greedy).sum())} of "
            f"{out.numel()} tokens differ from greedy; {st.steps} steps); "
            f"a second run at 0.9 on the same engine replayed {again} "
            f"({st2.steps} steps), graph == eager {torch.equal(out2, e_out2)}"
            f"; capture {eng.step_graphs.capture_s:.3f}s")
        if not (torch.equal(out, e_out) and torch.equal(out2, e_out2)):
            fail(f"float32 {label}: sampled graph tokens != eager tokens from "
                 f"the same generator seed:\n{out.tolist()}\n"
                 f"{e_out.tolist()}\n{out2.tolist()}\n{e_out2.tolist()}")
        if again != {"spec": st2.steps} or len(kept_graphs(eng)) != 1:
            fail(f"float32 {label}: the second sampled run replayed {again}, "
                 f"expected {st2.steps} spec replays and no new capture")

    def run(label, verify_fusion=False, hot=False, **layout):
        cfg = dataclasses.replace(base, **layout)
        eng, eager = (build_engine(cfg, "medusa", use_kernel=True, device=dev,
                                   verify_fusion=verify_fusion, graphs=g)
                      for g in (True, False))
        sp, ar, st, counts = counted_run(label, eng)
        if not torch.equal(sp, ar):
            fail(f"float32 {label}: spec != AR:\nspec {sp.tolist()}\n"
                 f"AR   {ar.tolist()}")
        graphs = kept_graphs(eng)
        if sorted(k for k, g in graphs if g.graph is not None) != ["AR",
                                                                   "spec"]:
            fail(f"f32 {label}: captured {[k for k, _ in graphs]}, expected "
                 f"one spec and one AR graph")
        replays = {k: g.replays for k, g in graphs}
        sp2, ar2, st2, _ = counted_run(label + " (second run)", eng)
        again = {k: g.replays - replays[k] for k, g in kept_graphs(eng)}
        if again != {"spec": st2.steps, "AR": max_new} \
                or len(kept_graphs(eng)) != 2:
            fail(f"f32 {label}: the second run on the reused cache replayed "
                 f"{again}, expected {st2.steps} spec and {max_new} AR "
                 f"replays and no new capture")
        spe, are, _, _ = counted_run(label + " (eager)", eager)
        for what, out in (("second run", sp2), ("second run AR", ar2),
                          ("eager", spe), ("eager AR", are)):
            if not torch.equal(out, sp):
                fail(f"float32 {label}: graph spec != {what}:\n"
                     f"{sp.tolist()}\n{out.tolist()}")
        mean_acc = st.accepted_sum.item() / (st.steps * 4)
        capture_s = eng.step_graphs.capture_s
        log(f"  f32 full width, 2 layers, {label}: graph spec == graph AR == "
            f"eager spec == eager AR for 4 x {max_new} tokens; {st.steps} "
            f"spec steps (mean accepted {mean_acc:.3f}), {max_new} AR steps; "
            f"launches {counts} (exact on the graph runs and the eager run); "
            f"a second run on the reused cache replayed {again} with no new "
            f"capture; capture {capture_s:.3f}s")
        sampled_zero(label, cfg, verify_fusion, ar)
        if hot:
            sampled_hot(label, cfg, verify_fusion, sp)
        return sp

    sp = run("dense", hot=True)
    others = {"verify fusion": run("verify fusion", verify_fusion=True,
                                   hot=True),
              "paged (page size 64)": run("paged (page size 64)",
                                          cache_layout="paged",
                                          page_size=64),
              "paged, verify fusion (page size 16)": run(
                  "paged, verify fusion (page size 16)", verify_fusion=True,
                  cache_layout="paged", page_size=16)}
    for label, out in others.items():
        if not torch.equal(out, sp):
            fail(f"float32 {label} spec != dense spec:\n{out.tolist()}\n"
                 f"{sp.tolist()}")
    int8 = run("int8", cache_dtype="int8")
    int8_others = {
        "int8 paged (page size 64)": run("int8 paged (page size 64)",
                                         cache_dtype="int8",
                                         cache_layout="paged", page_size=64),
        "int8, verify fusion": run("int8, verify fusion", verify_fusion=True,
                                   cache_dtype="int8")}
    for label, out in int8_others.items():
        if not torch.equal(out, int8):
            fail(f"float32 {label} spec != int8 dense spec:\n"
                 f"{out.tolist()}\n{int8.tolist()}")
    log(f"  f32: fused, paged and fused paged spec == dense spec; int8 "
        f"paged and int8 fused spec == int8 spec "
        f"({int(torch.sum(int8 == sp))} of {sp.numel()} int8 tokens equal "
        f"to the fp ones)")


def phase_tvd(dev):
    """The reference's tiny-vocabulary distribution gate on the card:
    openPangu-7B's widths in float32, 2 layers, a 16-token vocabulary, a
    cartesian (2, 2) tree with untrained heads (heavy rejection), 1024
    rows of one 4-token prompt, 5 new tokens at temperature 0.9, through
    K1, K2 (fused), K3 (fused) and K4.  The sampled speculative tokens
    must meet ``TVD <= 1.5 * floor + 0.05`` against
    ``ar_generate_sampled``, the floor being the TVD of two AR runs of
    other seeds, unfused and fused."""
    from repro_torch.configs.base import SamplingParams
    from repro_torch.configs.registry import get_config
    from repro_torch.core import medusa as M
    from repro_torch.core import sampling as S
    from repro_torch.core.engine import SpecEngine, ar_generate_sampled
    from repro_torch.core.tree import cartesian_tree
    from repro_torch.models.api import get_model

    cfg = dataclasses.replace(get_config("openpangu-7b"), num_layers=2,
                              vocab_size=16, dtype="float32",
                              param_dtype="float32",
                              name="openpangu-7b-2layer-f32-v16")
    gen = torch.Generator(device=dev).manual_seed(2)
    params = get_model(cfg).init_params(gen, cfg, dtype=cfg.dtype)
    tb = cartesian_tree((2, 2))
    mp = M.init_medusa(gen, cfg, tb.K)
    mp["w1"].normal_(generator=gen).mul_(0.1)
    B, new = 1024, 5
    tok = torch.randint(0, cfg.vocab_size, (1, 4), generator=gen, device=dev,
                        dtype=torch.int32).expand(B, 4).contiguous()
    plen = torch.full((B,), 4, dtype=torch.int32, device=dev)
    max_len = 4 + new + tb.T + 8
    sp = SamplingParams(temperature=0.9)
    for fused in (False, True):
        c = dataclasses.replace(cfg, verify_fusion=fused)
        eng = SpecEngine(c, tb, use_kernel=True, device=dev, accept="sample",
                         sampling=sp, seed=21)
        reset_counts()
        spec, n_out, st = eng.generate(params, mp, tok, plen,
                                       eng.init_cache(B, max_len), new)
        counts = read_counts()
        if counts != expected_counts(eng.cfg, st.steps) \
                or not bool((n_out == new).all()):
            fail(f"TVD gate, fused {fused}: launches {counts}, expected "
                 f"{expected_counts(eng.cfg, st.steps)}")
        ar1, ar2 = (ar_generate_sampled(
            c, params, tok, plen, eng.init_cache(B, max_len), new,
            torch.Generator(device=dev).manual_seed(s), sp, use_kernel=True,
            graphs=eng.step_graphs)[0].cpu() for s in (22, 23))
        floor = S.max_marginal_tvd(ar1, ar2, c.vocab_size)
        tvd = S.max_marginal_tvd(spec.cpu(), ar1, c.vocab_size)
        log(f"  TVD gate, {'fused' if fused else 'unfused'}: {B} rows x {new}"
            f" tokens at temperature 0.9, {st.steps} spec steps, launches "
            f"{counts}: max marginal TVD "
            f"spec vs AR {tvd:.4f}, AR vs AR floor {floor:.4f}, bound "
            f"{1.5 * floor + 0.05:.4f}")
        if not tvd <= 1.5 * floor + 0.05:
            fail(f"sampled spec tokens are not distributed as sampled AR's "
                 f"(fused {fused}): TVD {tvd} > 1.5 * {floor} + 0.05")


# ---------------------------------------------------------------------------
# phases 5 and 6: the launcher on bf16 openPangu-7B, full width and depth,
# unfused and then with verify fusion on the same weights
# ---------------------------------------------------------------------------

REQUESTS, SLOTS, MAX_NEW, MAX_LEN, SEED = 8, 4, 64, 2048, 0
SERVE_ARGV = ["--requests", str(REQUESTS), "--slots", str(SLOTS),
              "--max-new", str(MAX_NEW), "--max-len", str(MAX_LEN),
              "--min-prompt", "64", "--max-prompt", "257", "--seed",
              str(SEED)]
# a temperature at which the random-weight target is peaked enough that
# sampled candidates are accepted (at 0.7 none are), so 7s sees the
# accepting branch of the walks
LOW_TEMPERATURE = 0.1


def check_served(srv, counts):
    """Every request finished, and each kernel of the served config's path
    launched exactly as ``expected_counts`` says."""
    res = srv.results
    if any(r["status"] != "done" or len(r["output"]) != MAX_NEW
           for r in res):
        fail("not every request finished: "
             + str([(r["rid"], r["status"], len(r["output"])) for r in res]))
    steps = sum(res[g]["steps"] for g in range(0, REQUESTS, SLOTS))
    mean_acc = (sum(r["accepted"] for r in res)
                / sum(r["steps"] for r in res))
    want = expected_counts(srv.cfg, steps)
    graphs = kept_graphs(srv.engine)
    replays = sum(g.replays for _, g in graphs)
    log(f"  served {REQUESTS} requests: {srv.tokens} tokens in "
        f"{srv.seconds:.3f}s = {srv.tokens / srv.seconds:.1f} tok/s "
        f"({srv.capture_s:.3f}s of it capturing the step graph); {steps} "
        f"decode steps, {replays} of them graph replays; mean accepted "
        f"length {mean_acc:.3f} tokens per step (1 = no draft token "
        f"accepted); launches {counts} (expected {want}); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if counts != want:
        fail(f"kernel launches on the path {counts}, expected {want}")
    if [k for k, g in graphs if g.graph is not None] != ["spec"] \
            or replays != steps - 1:
        fail(f"the launcher's steps were not replayed from one captured "
             f"graph: {[(k, g.replays) for k, g in graphs]} for {steps} "
             f"steps (one eager warm-up step, then replays)")


def check_against_ar(srv, dev):
    """Each answer matches ``ar_generate`` on the served config up to its
    first divergence, where AR must rank the emitted token less than
    ``MARGIN_BOUND`` below its top logit."""
    from repro_torch.core.engine import ar_generate
    from repro_torch.models.api import init_cache

    res = srv.results
    diverged, worst, ar_seconds = 0, 0.0, 0.0
    for g in range(0, REQUESTS, SLOTS):
        rows = list(range(g, g + SLOTS))
        tok, plen = padded_batch(srv.prompts, rows)
        tok = torch.from_numpy(tok).to(dev)
        plen = torch.from_numpy(plen).to(dev)
        spec = torch.from_numpy(np.stack([res[i]["output"] for i in rows]))
        spec = spec.to(dev, torch.long)
        gaps, margins = [], []

        def observe(t, logits):
            # AR's top logit minus its logit for the token the speculative
            # path emitted at t, and AR's own top-2 margin
            lf = logits.float()
            top2 = torch.topk(lf, 2, dim=-1).values
            gaps.append(top2[:, 0] - lf.gather(1, spec[:, t:t + 1])[:, 0])
            margins.append(top2[:, 0] - top2[:, 1])

        cache = init_cache(srv.cfg, SLOTS, MAX_LEN, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ar, _ = ar_generate(srv.cfg, srv.params, tok, plen, cache, MAX_NEW,
                            use_kernel=True, observe=observe)
        ar = ar.cpu()
        ar_seconds += time.perf_counter() - t0
        gaps = torch.stack(gaps, 1).cpu()
        margins = torch.stack(margins, 1).cpu()
        for j, i in enumerate(rows):
            differ = (spec[j].cpu() != ar[j]).nonzero()
            if len(differ) == 0:
                log(f"  req {i}: spec == AR for all {MAX_NEW} tokens")
                continue
            at = int(differ[0, 0])
            gap = float(gaps[j, at])
            diverged += 1
            worst = max(worst, gap)
            log(f"  req {i}: spec == AR for {at} tokens, then diverges; AR "
                f"ranks the spec token {gap:.5f} below its top (bound "
                f"{MARGIN_BOUND}); AR top-2 margin {float(margins[j, at]):.5f}")
            if not gap < MARGIN_BOUND:
                fail(f"request {i} diverges from AR at token {at}, where AR "
                     f"ranks the spec token {gap} >= {MARGIN_BOUND} below "
                     f"its top")
    log(f"  ar_generate on the same groups: {REQUESTS * MAX_NEW} tokens in "
        f"{ar_seconds:.3f}s = {REQUESTS * MAX_NEW / ar_seconds:.1f} tok/s "
        f"(the margin readings included)")
    log(f"  divergences: {diverged} of {REQUESTS} requests "
        f"(largest AR gap to the spec token at a divergence {worst:.5f})")


def serve_counted(argv, weights=None):
    """One launcher run with the counts set to 0 just before it and read
    just after; returns (Served, counts)."""
    from repro_torch.launch import serve

    reset_counts()
    srv = serve.main(argv, weights=weights)
    counts = read_counts()
    check_served(srv, counts)
    steps = sum(srv.results[g]["steps"] for g in range(0, REQUESTS, SLOTS))
    ps = srv.cfg.page_size if srv.cfg.paged else 1
    check_routes(" ".join(argv[len(SERVE_ARGV):]) or "launcher",
                 counts if srv.cfg.verify_fusion else None,
                 k1_routes(srv.cfg, SLOTS, -(-MAX_LEN // ps) * ps, steps))
    return srv, counts


def same_answers(a, b) -> int:
    return sum(np.array_equal(x["output"], y["output"])
               for x, y in zip(a.results, b.results))


def phase_serve(dev):
    srv, counts = serve_counted(SERVE_ARGV)
    check_against_ar(srv, dev)
    return srv, counts


def map_encodings():
    """{kernel: tensor maps its library has encoded for weights}."""
    from repro_torch.kernels.cache_update import qkv_map_encodings
    from repro_torch.kernels.tree_attention import stats_map_encodings
    return {"K2": stats_map_encodings(), "K3": qkv_map_encodings()}


def phase_serve_fused(dev, srv):
    """The launcher with ``--verify-fusion`` on ``srv``'s weights: every K2
    and K3 launch on the wgmma route, and at most one tensor map encoded
    per weight tensor (3 per layer for K3, the lm head for K2)."""
    enc0 = map_encodings()
    fsrv, counts = serve_counted(SERVE_ARGV + ["--verify-fusion"],
                                 weights=(srv.params, srv.medusa_params))
    enc = {k: n - enc0[k] for k, n in map_encodings().items()}
    limit = {"K2": 1, "K3": 3 * fsrv.cfg.num_layers}
    log(f"  weight tensor maps encoded over the run: {enc} (at most {limit}: "
        f"one per weight tensor; {counts['K2']} K2 and {counts['K3']} K3 "
        f"launches)")
    if any(enc[k] > limit[k] for k in enc):
        fail(f"tensor maps encoded {enc}, more than one per weight tensor "
             f"{limit}")
    log(f"  {same_answers(fsrv, srv)} of {REQUESTS} answers token-identical "
        f"to the unfused launcher's; tokens/s {fsrv.tokens / fsrv.seconds:.1f}"
        f" fused, {srv.tokens / srv.seconds:.1f} unfused")
    check_against_ar(fsrv, dev)
    return fsrv, counts


def step_times(eng, steps: int = 10):
    """(wall ms, device ms) per step of the captured spec step ``eng``
    keeps, replayed ``steps`` times from where its last run stopped, each
    replay followed by the loop's exit test (a host read) as in
    ``generate``: wall from the host clock, device from the kernels' own
    time under ``torch.profiler``."""
    graph, c = eng.step_graphs.kept()[0]

    def step_and_exit_test():
        graph()
        bool(torch.any(c.n_out < 0))

    step_and_exit_test()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step_and_exit_test()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / steps
    return wall, device_ms(step_and_exit_test, steps, warmup=1)


def phase_serve_eager(dev, fsrv):
    """The phase 6 configuration served once more on the same weights
    with the eager step (``graphs=False``): its launches exact, and its
    answers, tokens/s and step times logged beside the graph's."""
    from repro_torch.core.engine import build_engine
    from repro_torch.launch.serve import serve_static

    eng = build_engine(fsrv.cfg, "medusa", use_kernel=True, device=dev,
                       graphs=False)
    reset_counts()
    results, seconds, tokens, _ = serve_static(
        eng, fsrv.params, fsrv.medusa_params, fsrv.prompts, SLOTS, MAX_NEW,
        MAX_LEN)
    counts = read_counts()
    steps = sum(results[g]["steps"] for g in range(0, REQUESTS, SLOTS))
    want = expected_counts(fsrv.cfg, steps)
    if counts != want:
        fail(f"eager fused launcher: launches {counts}, expected {want}")
    same = [np.array_equal(a["output"], b["output"])
            for a, b in zip(results, fsrv.results)]
    log(f"  eager step: {tokens} tokens in {seconds:.3f}s = "
        f"{tokens / seconds:.1f} tok/s; graph (phase 6): "
        f"{fsrv.tokens / fsrv.seconds:.1f} tok/s, "
        f"{fsrv.tokens / (fsrv.seconds - fsrv.capture_s):.1f} tok/s without "
        f"its {fsrv.capture_s:.3f}s of capture; launches {counts} (exact)")
    log(f"  {sum(same)} of {REQUESTS} answers token-identical to the graph's "
        f"(expected {REQUESTS} of {REQUESTS})")
    for i, ok in enumerate(same):
        if not ok:
            at = int(np.nonzero(results[i]["output"]
                                != fsrv.results[i]["output"])[0][0])
            log(f"  req {i}: eager differs from the graph from token {at}")
    wall, dev_ms = step_times(fsrv.engine)
    log(f"  captured fused step, replayed: wall {wall:.3f} ms/step, device "
        f"{dev_ms:.3f} ms/step (idle {1 - dev_ms / wall:.3f}); peak memory "
        f"with the graph pools {torch.cuda.max_memory_allocated() / 2**30:.2f}"
        f" GiB")


def phase_serve_layouts(dev, srv, fsrv):
    """The launcher on the same weights under the reference's other cache
    layouts: (a) ``--cache-layout paged --verify-fusion``, token-identical
    to the fused dense answers (phase 6); (b) ``--cache-dtype int8``, held
    to ``ar_generate`` on the int8 config under the ``MARGIN_BOUND`` rule;
    (c) ``--cache-dtype int8 --cache-layout paged --page-size 16``,
    token-identical to (b).  Returns {label: (Served, counts)}."""
    weights = (srv.params, srv.medusa_params)
    runs = {}
    log("  (a) --cache-layout paged --verify-fusion")
    enc0 = map_encodings()
    runs["paged fused"] = serve_counted(
        SERVE_ARGV + ["--cache-layout", "paged", "--verify-fusion"], weights)
    log(f"  weight tensor maps encoded over the run: "
        f"{ {k: n - enc0[k] for k, n in map_encodings().items()} } (the "
        f"weights of phase 6, already encoded)")
    same = same_answers(runs["paged fused"][0], fsrv)
    log(f"  {same} of {REQUESTS} answers token-identical to the fused dense "
        f"launcher's (phase 6)")
    if same != REQUESTS:
        fail(f"paged fused answers differ from dense fused: {same} of "
             f"{REQUESTS} identical")
    log("  (b) --cache-dtype int8")
    runs["int8"] = serve_counted(SERVE_ARGV + ["--cache-dtype", "int8"],
                                 weights)
    log(f"  {same_answers(runs['int8'][0], srv)} of {REQUESTS} int8 answers "
        f"token-identical to the bf16 cache's (phase 5)")
    check_against_ar(runs["int8"][0], dev)
    log("  (c) --cache-dtype int8 --cache-layout paged --page-size 16")
    runs["int8 paged"] = serve_counted(
        SERVE_ARGV + ["--cache-dtype", "int8", "--cache-layout", "paged",
                      "--page-size", "16"], weights)
    same = same_answers(runs["int8 paged"][0], runs["int8"][0])
    log(f"  {same} of {REQUESTS} answers token-identical to the int8 dense "
        f"launcher's (b)")
    if same != REQUESTS:
        fail(f"int8 paged answers differ from int8 dense: {same} of "
             f"{REQUESTS} identical")
    for label, (run, _) in runs.items():
        log(f"  tokens/s {label}: {run.tokens / run.seconds:.1f}")
    return runs


def eager_answers(run) -> list:
    """The answers of launcher run ``run`` served again on its weights,
    config, sampling and seed through the eager step (``graphs=False``)."""
    from repro_torch.core.engine import build_engine
    from repro_torch.launch.serve import serve_static

    e = run.engine
    eng = build_engine(e.cfg, "medusa", use_kernel=True, device=e.device,
                       accept=e.accept, sampling=e.sampling, graphs=False,
                       seed=SEED)
    return serve_static(eng, run.params, run.medusa_params, run.prompts,
                        SLOTS, MAX_NEW, MAX_LEN)[0]


def phase_serve_sampled(dev, srv, fsrv):
    """The launcher on the same weights with ``--accept sample``: at
    temperature 0.7, unfused and with ``--verify-fusion`` (K2 at per-row
    temperatures, every launch on the wgmma route), through the captured
    step with launches exact, each logged beside greedy's (phases 5 and 6)
    with the wall and device ms of its replayed step; at
    ``LOW_TEMPERATURE`` its accepted length and its answers against the
    eager step's; at temperature 0 all 8 answers token-identical to
    greedy's (phase 5)."""
    weights = (srv.params, srv.medusa_params)
    hot = SERVE_ARGV + ["--accept", "sample", "--temperature", "0.7"]
    torch.cuda.reset_peak_memory_stats()

    def summary(run):
        steps = sum(run.results[g]["steps"] for g in range(0, REQUESTS,
                                                           SLOTS))
        mean_acc = (sum(r["accepted"] for r in run.results)
                    / sum(r["steps"] for r in run.results))
        return (f"{run.tokens / run.seconds:.1f} tok/s, {steps} steps, mean "
                f"accepted {mean_acc:.3f}, capture {run.capture_s:.3f}s")

    runs = {}
    for label, argv, greedy in (("sampled", hot, srv),
                                ("sampled fused", hot + ["--verify-fusion"],
                                 fsrv)):
        log(f"  ({label}) {' '.join(argv[len(SERVE_ARGV):])}")
        run, _ = serve_counted(argv, weights)
        wall, dev_ms = step_times(run.engine)
        log(f"  {label}: {summary(run)}; greedy: {summary(greedy)}; "
            f"{same_answers(run, greedy)} of {REQUESTS} answers equal to "
            f"greedy's; replayed step wall {wall:.3f} ms, device "
            f"{dev_ms:.3f} ms (idle {1 - dev_ms / wall:.3f})")
        runs[label] = run
    log(f"  peak memory over the sampled runs, the weights and every kept "
        f"graph pool included: "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    cold = SERVE_ARGV + ["--accept", "sample", "--temperature",
                         str(LOW_TEMPERATURE)]
    for label, argv in (("cold", cold),
                        ("cold fused", cold + ["--verify-fusion"])):
        log(f"  ({label}) {' '.join(argv[len(SERVE_ARGV):])}")
        run, _ = serve_counted(argv, weights)
        eager = sum(np.array_equal(r["output"], e["output"])
                    for r, e in zip(run.results, eager_answers(run)))
        log(f"  {label}: {summary(run)}; {same_answers(run, srv)} of "
            f"{REQUESTS} answers equal to greedy's; {eager} of {REQUESTS} "
            f"token-identical to the eager step's from the same seed "
            f"(expected {REQUESTS})")
        del run
    log("  (zero) --accept sample --temperature 0")
    zero, _ = serve_counted(SERVE_ARGV + ["--accept", "sample",
                                          "--temperature", "0"], weights)
    same = same_answers(zero, srv)
    log(f"  {same} of {REQUESTS} answers at temperature 0 token-identical "
        f"to greedy's (phase 5)")
    if same != REQUESTS:
        fail(f"sampled at temperature 0: {same} of {REQUESTS} answers equal "
             f"to greedy's")
    return runs


# ---------------------------------------------------------------------------
# phase 8: timing at the main path's shapes
# ---------------------------------------------------------------------------

def bound(nbytes, flops):
    """(bound ms, what bounds it) on the H100's published peaks."""
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_BF16_FLOPS * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def time_verify_stats(dev, cfg, launches, max_err):
    """K2 at the spec step: hidden [4, 64, 4096] against the full
    153,376-column bf16 lm head (1.26 GB: every launch reads it from HBM,
    as the live step does)."""
    from repro_torch.kernels.tree_attention import (
        unembed_verify_stats, unembed_verify_stats_plain)

    B, T, d, V = 4, 64, cfg.d_model, cfg.vocab_size
    N = B * T
    gen = torch.Generator(device=dev).manual_seed(3)
    h = torch.randn((B, T, d), generator=gen, device=dev).to(torch.bfloat16)
    w = (torch.randn((d, V), generator=gen, device=dev)
         * d ** -0.5).to(torch.bfloat16)
    cand = torch.randint(0, V, (B, T), generator=gen, device=dev,
                         dtype=torch.int32)
    tmax = torch.ones((B,), device=dev)
    h2 = h.reshape(N, d)
    _, route = routed(unembed_verify_stats, h, w, cand, tmax)

    def kernel():
        uncounted(unembed_verify_stats, h, w, cand, tmax)

    ms = queued_ms(kernel, 20)
    ev_ms = cuda_ms(kernel, 20)
    rows_t = torch.tensor(TMAX_ROWS, dtype=torch.float32, device=dev)
    tmax_ms = queued_ms(
        lambda: uncounted(unembed_verify_stats, h, w, cand, rows_t), 20)
    plain_ms = queued_ms(
        lambda: unembed_verify_stats_plain(h, w, cand, tmax), 5)
    lib_ms = queued_ms(lambda: torch.matmul(h2, w), 20)
    h_ms = host_ms(kernel, 20)
    nbytes = d * V * 2 + N * d * 2 + N * 4 + B * 4 + N * 3 * 4 + N * T * 4
    flops = 2 * N * d * V
    b_ms, b_by = bound(nbytes, flops)
    log(f"  unembed_verify_stats (N={N} d={d} V={V} bf16, {route} route), "
        f"queued back to back: kernel {ms:.4f} ms ({ms / lib_ms:.2f}x the "
        f"library call; {ev_ms:.4f} ms issued as the host goes), plain "
        f"{plain_ms:.4f} ms, torch.matmul of the product only {lib_ms:.4f} "
        f"ms, bound {b_ms:.5f} ms ({b_by}: {nbytes} bytes, {flops} flops); "
        f"the wrapper's host time {h_ms:.4f} ms per call; at per-row tmax "
        f"{TMAX_ROWS} {tmax_ms:.4f} ms")
    return {"name": "unembed_verify_stats", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/verify_stats.cu",
            "replaces": "src/repro/kernels/tree_attention.py:298",
            "launches": launches, "max_abs_err": max_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib_ms, "host_ms": h_ms, "tmax_ms": tmax_ms}


def time_fused_qkv(dev, cfg, lens, launches, max_err, ps=0):
    """K3 at the spec step (T 64) and the AR step (T 1); with ``ps`` its
    paged variant on pools of that page size through a shuffled table.
    Each timed launch takes the next of 4 weight sets (201 MB, four times
    the L2), so it reads its weights from HBM as a layer of the live step
    does."""
    from repro_torch.kernels.cache_update import (
        fused_qkv_rope_commit, fused_qkv_rope_commit_plain)
    from repro_torch.models.layers import rope_cos_sin

    B, S, d, Hq, Hkv, hd = (4, 2048, cfg.d_model, cfg.num_heads,
                            cfg.num_kv_heads, cfg.resolved_head_dim)
    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(4)
    sets, cats = [], []
    for _ in range(4):
        p = {n: (torch.randn((d, H, hd), generator=gen, device=dev)
                 * d ** -0.5).to(bf)
             for n, H in (("wq", Hq), ("wk", Hkv), ("wv", Hkv))}
        sets.append(p)
        cats.append(torch.cat([p[n].reshape(d, -1) for n in
                               ("wq", "wk", "wv")], dim=1))
    table = None
    if ps:
        table = shuffled_table(B, S // ps, dev, 4)
        kc = torch.zeros((1 + B * S // ps, ps, Hkv, hd), dtype=bf,
                         device=dev)
    else:
        kc = torch.zeros((B, S, Hkv, hd), dtype=bf, device=dev)
    vc = torch.zeros_like(kc)
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    out = {}
    for T in (64, 1):
        N = B * T
        x = torch.randn((B, T, d), generator=gen, device=dev).to(bf)
        x2 = x.reshape(N, d)
        cos, sin = rope_cos_sin(lengths[:, None]
                                + torch.arange(T, device=dev), hd,
                                cfg.rope_theta)
        it = iter(range(10 ** 9))
        _, route = routed(fused_qkv_rope_commit, x, sets[0], lengths, kc, vc,
                          cos=cos, sin=sin, table=table)

        def kernel():
            uncounted(fused_qkv_rope_commit, x, sets[next(it) % 4], lengths,
                      kc, vc, cos=cos, sin=sin, table=table)

        # the wrapper's host cost is longer than the kernel: the launches
        # are queued so the card runs them back to back; as the host issues
        # them (CUDA events, no queue) beside it
        ms = queued_ms(kernel, 40)
        ev_ms = cuda_ms(kernel, 40)
        h_ms = host_ms(kernel, 40)
        plain_ms = queued_ms(lambda: fused_qkv_rope_commit_plain(
            x, sets[next(it) % 4], lengths, kc, vc, cos=cos, sin=sin,
            table=table), 8)
        lib_ms = queued_ms(lambda: torch.matmul(x2, cats[next(it) % 4]), 40)
        cols = (Hq + 2 * Hkv) * hd
        nbytes = (d * cols * 2 + N * d * 2 + N * cols * 2
                  + 2 * N * Hkv * hd * 2 + 2 * N * hd // 2 * 4 + B * 4
                  + (table.numel() * 4 if ps else 0))
        flops = 2 * N * d * cols
        b_ms, b_by = bound(nbytes, flops)
        out[T] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                      bound_ms=b_ms, bound_by=b_by, host_ms=h_ms)
        where = f" paged ps={ps}" if ps else ""
        log(f"  fused_qkv_rope_commit{where} T={T} (B={B} d={d} Hq={Hq} "
            f"Hkv={Hkv} hd={hd} bf16, lengths {lens}, {route} route), "
            f"queued back to back: kernel {ms:.4f} ms ({ms / lib_ms:.2f}x the "
            f"library call; {ev_ms:.4f} ms issued as the host goes), "
            f"plain {plain_ms:.4f} ms, torch.matmul of the product only "
            f"{lib_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}: {nbytes} bytes, "
            f"{flops} flops); the wrapper's host time {h_ms:.4f} ms per call")
    return {"name": "fused_qkv_rope_commit" + ("[paged]" if ps else ""),
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/fused_qkv_rope_commit.cu",
            "replaces": ("src/repro/kernels/cache_update.py:203" if ps else
                         "src/repro/kernels/cache_update.py:209"),
            "launches": launches, "max_abs_err": max_err, **out[64],
            **{k + "_t1": v for k, v in out[1].items() if k != "bound_by"}}


K1_REPLACES = {"": "src/repro/kernels/tree_attention.py:126",
               "int8": "src/repro/kernels/tree_attention.py:73",
               "paged": "src/repro/kernels/tree_attention.py:105",
               "int8+paged": "src/repro/kernels/tree_attention.py:105"}


# K1's yardstick: the SDPA backend that takes a boolean mask at this shape
# (flash attention takes none)
SDPA_BACKEND = "EFFICIENT_ATTENTION"


def sdpa_pinned(q, k, v, mask):
    """A call of ``scaled_dot_product_attention`` on these inputs, pinned to
    ``SDPA_BACKEND`` with ``torch.nn.attention.sdpa_kernel`` (it raises
    rather than fall back to another backend)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    def call():
        with sdpa_kernel(getattr(SDPBackend, SDPA_BACKEND)):
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                  scale=1.0)
    return call


def time_flash_decode(dev, prompt_lens, max_new, launches, max_err,
                      variant="", ps=64):
    """K1 at the spec (R 256) and AR (R 8) shapes, B 4, Hkv 8, D 128, a
    2048-row bf16 cache (int8 + f32 scales for the int8 variants; pools of
    page size ``ps`` through a shuffled table for the paged ones).  Kernel,
    plain version and yardstick are timed queued behind a spin kernel
    (``queued_ms``): the kernel is shorter than its wrapper's host cost.
    The yardstick is ``scaled_dot_product_attention`` with its backend
    pinned (``sdpa_pinned``) over the rows K1 sweeps, on the dense bf16
    view the cache holds: gathered from the pool for the paged variants,
    dequantized to bf16 for the int8 ones, neither step timed."""
    from repro_torch.kernels import paging as P
    from repro_torch.kernels.quant import dequantize, quantize_rows
    from repro_torch.kernels.tree_attention import (flash_decode,
                                                    flash_decode_plain)

    B, S, Hkv, D = 4, 2048, 8, 128
    bf = torch.bfloat16
    quantized, paged = "int8" in variant, "paged" in variant
    gen = torch.Generator(device=dev).manual_seed(0)
    # lengths mid-way through the first group's generation
    lens = [n + max_new // 2 for n in prompt_lens]
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    S_run = max(lens)
    n_cols = sum(lens)
    rows = {}
    for R in (256, 8):
        q = torch.randn((B, Hkv, R, D), generator=gen, device=dev,
                        dtype=bf) * (D ** -0.5)
        k = torch.randn((B, S, Hkv, D), generator=gen, device=dev, dtype=bf)
        v = torch.randn((B, S, Hkv, D), generator=gen, device=dev, dtype=bf)
        mask = (torch.arange(S, device=dev)[None, :]
                < lengths[:, None])[:, None, None, :]
        kw = {}
        if quantized:
            (k, kw["k_scale"]), (v, kw["v_scale"]) = (quantize_rows(k),
                                                      quantize_rows(v))
        if paged:
            table = shuffled_table(B, S // ps, dev, 10)
            k, v = to_pool(k, table, ps, gen), to_pool(v, table, ps, gen)
            kw = {n: to_pool(t, table, ps, gen) for n, t in kw.items()}
            kw["block_tables"] = table
        # the dense bf16 view the cache holds, as the library call needs it
        kd, vd = k, v
        ks, vs = kw.get("k_scale"), kw.get("v_scale")
        if paged:
            kd, vd = P.gather_cache(k, table), P.gather_cache(v, table)
            if quantized:
                ks, vs = P.gather_cache(ks, table), P.gather_cache(vs, table)
        if quantized:
            kd, vd = dequantize(kd, ks, bf), dequantize(vd, vs, bf)
        kt = kd.transpose(1, 2)[:, :, :S_run]
        vt = vd.transpose(1, 2)[:, :, :S_run]
        lib = sdpa_pinned(q, kt, vt, mask[..., :S_run])
        _, route = routed(flash_decode, q, k, v, lengths, **kw)

        def kernel():
            uncounted(flash_decode, q, k, v, lengths, **kw)

        ms = queued_ms(kernel, 100)
        ev_ms = cuda_ms(kernel, 100)
        h_ms = host_ms(kernel, 100)
        plain_ms = queued_ms(lambda: flash_decode_plain(q, k, v, lengths,
                                                        **kw), 20)
        lib_ms = queued_ms(lib, 100)
        # bytes: q, the swept rows of k and v (+ their f32 scales), the
        # lengths, the table entries of the swept rows, the f32 outputs
        row_bytes = Hkv * (D + 4) if quantized else Hkv * D * 2
        nbytes = (q.numel() * 2 + 2 * n_cols * row_bytes + B * 4
                  + B * Hkv * R * (D + 2) * 4
                  + (sum(-(-n // ps) for n in lens) * 4 if paged else 0))
        flops = 4 * R * D * Hkv * n_cols
        b_ms, b_by = bound(nbytes, flops)
        rows[R] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                       bound_ms=b_ms, bound_by=b_by, host_ms=h_ms,
                       library_backend=SDPA_BACKEND)
        what = variant + (f" ps={ps}" if paged else "")
        view = ("the dequantized bf16 view" if quantized else "the rows")
        view += ", gathered from the pool," if paged else ""
        log(f"  flash_decode {what or 'dense'} R={R} (B={B} Hkv={Hkv} D={D} "
            f"S={S} bf16, lengths {lens}, {route} route), queued back to "
            f"back: kernel {ms:.4f} ms ({ms / lib_ms:.2f}x the library call; "
            f"{ev_ms:.4f} ms issued as the host goes), plain {plain_ms:.4f} "
            f"ms, sdpa ({SDPA_BACKEND}) over {view} {S_run} rows {lib_ms:.4f} "
            f"ms, bound {b_ms:.5f} ms ({b_by}: {nbytes} bytes, {flops} "
            f"flops); "
            f"the wrapper's host time {h_ms:.4f} ms per call")
    return {"name": "flash_decode" + (f"[{variant}]" if variant else ""),
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_decode.cu",
            "replaces": K1_REPLACES[variant], "launches": launches,
            "max_abs_err": max_err, **rows[256],
            **{k + "_r8": v for k, v in rows[8].items() if k != "bound_by"}}


def time_commit(dev, launches, paged, ps=64):
    """K4 (or K5 with ``paged``) at the main path's commit: 5 bf16 rows of
    [8, 128] per slot of 4 slots into all 34 units of a 2048-row cache (a
    pool through a shuffled table), one launch.  The yardstick is one
    ``index_put_`` of the same rows at the same (precomputed) positions.
    Times are device times from the profiler (``device_ms``)."""
    from repro_torch.kernels import cache_update as CU
    from repro_torch.kernels import paging as P

    nu, B, S, K1, H, D = 34, 4, 2048, 5, 8, 128
    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(11)
    rows = torch.randn((nu, B, K1, H, D), generator=gen, device=dev).to(bf)
    lengths = torch.tensor([300, 517, 1300, 2000], dtype=torch.int32,
                           device=dev)
    if paged:
        table = shuffled_table(B, S // ps, dev, 12)
        cache = torch.zeros((nu, 1 + B * S // ps, ps, H, D), dtype=bf,
                            device=dev)
        fn, plain = CU.commit_rows_paged_stacked, \
            CU.commit_rows_paged_stacked_plain
        extra = (table,)
        flat = cache.view(nu, -1, H, D)
        phys = P.phys_rows(table, lengths, K1, ps).reshape(-1)
        rows2 = rows.reshape(nu, B * K1, H, D)

        def lib():
            flat.index_put_((torch.arange(nu, device=dev)[:, None],
                             phys[None, :]), rows2)
    else:
        cache = torch.zeros((nu, B, S, H, D), dtype=bf, device=dev)
        fn, plain = CU.commit_rows_stacked, CU.commit_rows_stacked_plain
        extra = ()
        pos = (lengths.long()[:, None]
               + torch.arange(K1, device=dev)).reshape(-1)
        slot = torch.arange(B, device=dev).repeat_interleave(K1)
        rows2 = rows.reshape(nu, B * K1, H, D)

        def lib():
            cache.index_put_((torch.arange(nu, device=dev)[:, None],
                              slot[None, :], pos[None, :]), rows2)
    # each call is shorter than the host's cost of issuing it: device
    # times from the profiler, and the host's rate beside them
    issue_ms = cuda_ms(lambda: uncounted(fn, cache, *extra, rows, lengths),
                      200)
    ms = device_ms(lambda: uncounted(fn, cache, *extra, rows, lengths), 50)
    plain_ms = device_ms(lambda: plain(cache, *extra, rows, lengths), 50)
    lib_ms = device_ms(lib, 50)
    empty_ms = device_ms(lambda: torch.cuda._sleep(0), 50)
    nbytes = 2 * rows.numel() * 2 + B * 4 + (B * 2 * 4 if paged else 0)
    b_ms, b_by = bound(nbytes, 0)
    name = "commit_rows_paged" if paged else "commit_rows"
    log(f"  {name} (via {fn.__name__}: nu={nu} B={B} K1={K1} rows [{H}, {D}] "
        f"bf16{f', page size {ps}' if paged else ''}), device time per call: "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, index_put_ of the same "
        f"rows {lib_ms:.4f} ms, an empty kernel {empty_ms:.4f} ms, bound "
        f"{b_ms:.5f} ms ({b_by}: {nbytes} bytes); back to back on CUDA "
        f"events the kernel's wrapper issues one call per {issue_ms:.4f} "
        f"ms")
    return {"name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/commit_rows.cu",
            "replaces": ("src/repro/kernels/cache_update.py:86" if paged else
                         "src/repro/kernels/cache_update.py:32"),
            "launches": launches, "max_abs_err": 0.0, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib_ms, "empty_kernel_ms": empty_ms}


def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {__file__}: run from a checkout of "
             "the repo")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs an "
             "NVIDIA GPU")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import build
    from repro_torch.runtime import resolve_device

    dev = resolve_device("cuda")
    t_start = time.perf_counter()
    smi = smi_line()
    log(f"phase 1: {smi}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; {torch.cuda.device_count()} device(s)")
    sources = sorted(p.stem for p in build.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    logs = build.build(sources)
    for name in sources:
        log(f"  built {build.target(name).name} "
            f"({time.perf_counter() - t0:.1f}s)")
        for line in logs[name].splitlines():
            if "registers" in line or "spill" in line:
                log(f"    {line.strip()}")

    log("phase 2: flash_decode kernel (dense, int8, paged, int8 + paged) vs "
        "plain version on the card")
    k1_err = phase_kernels(dev)
    k1_errs = phase_kernel_variants(dev)

    log("phase 3: unembed_verify_stats, fused_qkv_rope_commit (dense and "
        "paged) and commit_rows (dense and paged) kernels vs plain versions "
        "on the card")
    k2_err, k3_err, k3p_err = phase_fusion_kernels(dev)
    phase_commit_kernels(dev)
    torch.cuda.empty_cache()

    log("phase 4: float32, full width, 2 layers: speculative == AR on every "
        "cache layout, fused too; sampled at temperature 0 == AR, and "
        "sampled graph == eager")
    phase_graph_rng(dev)
    phase_f32(dev)
    torch.cuda.empty_cache()
    log("phase 4b: the sampled distribution gate (tiny vocabulary, 1024 "
        "rows), unfused and fused")
    phase_tvd(dev)
    torch.cuda.empty_cache()

    log("phase 5: the launcher on bf16 openPangu-7B, full width and depth, "
        "through the captured step")
    torch.cuda.reset_peak_memory_stats()
    srv, _ = phase_serve(dev)

    log("phase 6: the launcher with --verify-fusion on the same weights")
    fsrv, fused = phase_serve_fused(dev, srv)
    log("phase 6b: the same configuration through the eager step "
        "(graphs=False)")
    phase_serve_eager(dev, fsrv)

    log("phase 7: the launcher on the same weights under the paged and int8 "
        "cache layouts")
    runs = phase_serve_layouts(dev, srv, fsrv)
    layout_counts = {label: counts for label, (_, counts) in runs.items()}
    del runs
    torch.cuda.empty_cache()
    log("phase 7s: the launcher on the same weights with --accept sample "
        f"(temperature 0.7 and {LOW_TEMPERATURE}, unfused and fused; "
        "temperature 0)")
    phase_serve_sampled(dev, srv, fsrv)
    prompt_lens = [len(p) for p in srv.prompts[:4]]
    del srv, fsrv
    torch.cuda.empty_cache()

    log("phase 8: timing at the main path's shapes")
    cfg = get_config("openpangu-7b")
    mid = [n + MAX_NEW // 2 for n in prompt_lens]
    paged_fused = layout_counts["paged fused"]
    rows = [time_flash_decode(dev, prompt_lens, MAX_NEW, fused["K1"],
                              k1_err),
            time_flash_decode(dev, prompt_lens, MAX_NEW,
                              layout_counts["int8"]["K1"], k1_errs["int8"],
                              variant="int8"),
            time_flash_decode(dev, prompt_lens, MAX_NEW, paged_fused["K1"],
                              k1_errs["paged"], variant="paged"),
            time_flash_decode(dev, prompt_lens, MAX_NEW,
                              layout_counts["int8 paged"]["K1"],
                              k1_errs["int8+paged"], variant="int8+paged",
                              ps=16),
            time_verify_stats(dev, cfg, fused["K2"], k2_err),
            time_fused_qkv(dev, cfg, mid, fused["K3"], k3_err),
            time_fused_qkv(dev, cfg, mid, paged_fused["K3"], k3p_err, ps=64),
            time_commit(dev, fused["K4"], paged=False),
            time_commit(dev, paged_fused["K5"], paged=True)]
    log(f"chip_smoke: all phases passed in "
        f"{time.perf_counter() - t_start:.1f}s")
    print(smi_line(), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
