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
   shapes, f32 and bf16), and ``ops.tree_attention`` against the
   ``tree_attention_ref`` oracle;
3. hold the verify-fusion kernels against their plain versions on the
   card, f32 and bf16: ``unembed_verify_stats`` (K2) at the spec step's
   shape (B 4, T 64, d 4096, V 153376, which is not a multiple of the
   kernel's 128-column tile), with a candidate in the last partial tile,
   and with tied lm-head columns in different tiles (first index wins),
   plus a vocabulary whose rows are not 16-byte aligned;
   ``fused_qkv_rope_commit`` (K3) at the spec (T 64) and AR (T 1) shapes
   of openPangu-7B's attention, with biases, and with rows past the
   cache's end (dropped; the rest of the cache unchanged bit for bit);
4. float32 openPangu-7B at full width, 2 layers: speculative ``generate``
   == ``ar_generate`` token for token, both through K1, which must launch
   2 x (spec steps + AR steps) times; then, on the same weights with
   verify fusion, fused spec == fused AR == the unfused spec, with K1 and
   K3 launched 2 x (spec steps + AR steps) times and K2 once per spec step;
5. the launcher (``repro_torch.launch.serve.main``) serves 8 requests on
   bf16 openPangu-7B at full width and depth; every request must finish,
   and each one matches ``ar_generate`` up to its first divergence, where
   AR's logit for the token the speculative path emitted must lie within
   ``MARGIN_BOUND`` of AR's top logit;
6. the main path of this slice: the launcher with ``--verify-fusion``
   answers the same 8 requests on the same weights, through K1, K2 and K3
   (counts exact), each answer held to ``ar_generate`` on the fused
   config under the same rule; it prints how many answers are
   token-identical to phase 5's and the tokens/s of both;
7. time K1, K2 and K3, their plain versions, and one PyTorch call each as
   a yardstick the port never calls (``scaled_dot_product_attention`` for
   K1; for K2 and K3 one ``torch.matmul`` of the same product, which does
   only the product) at the main path's spec-step shape.

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


def scaled_err(got, ref) -> float:
    """max |got - ref| / max(1, |ref|): the absolute error for values below
    1 in magnitude, the relative error above (one bf16 step is 1/32 at
    magnitudes in [4, 8), so a bf16 tolerance of 2e-2 is relative there)."""
    g, r = got.float(), ref.float()
    return ((g - r).abs() / r.abs().clamp(min=1.0)).max().item()


def reset_counts():
    from repro_torch.kernels.cache_update import fused_qkv_rope_commit
    from repro_torch.kernels.tree_attention import (flash_decode,
                                                    unembed_verify_stats)
    wrappers = (flash_decode, unembed_verify_stats, fused_qkv_rope_commit)
    for f in wrappers:
        f.launches = 0
    return wrappers


def read_counts():
    """(K1, K2, K3) launches since ``reset_counts``, after the device is
    done."""
    from repro_torch.kernels.cache_update import fused_qkv_rope_commit
    from repro_torch.kernels.tree_attention import (flash_decode,
                                                    unembed_verify_stats)
    torch.cuda.synchronize()
    return (flash_decode.launches, unembed_verify_stats.launches,
            fused_qkv_rope_commit.launches)


def uncounted(fn, *args, **kwargs):
    """Call a kernel wrapper without counting the launch: comparison and
    timing launches are not main-path launches."""
    saved = fn.launches
    out = fn(*args, **kwargs)
    fn.launches = saved
    return out


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
        got = flash_decode(q, k, v, lens)
        ref = flash_decode_plain(q, k, v, lens)
        torch.cuda.synchronize()
        err, out_err = stats_errors(got, ref)
        tol = TOL["bfloat16" if dt == torch.bfloat16 else "float32"]
        log(f"  flash_decode {name}: B={B} S={S} Hkv={Hkv} R={R} D={D} "
            f"{dt} lengths={lengths}: max err {err:.3e} (tol {tol})")
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
    return main_err


# ---------------------------------------------------------------------------
# phase 3: the verify-fusion kernels against their plain versions
# ---------------------------------------------------------------------------

def bf16_step(x):
    """One bf16 step (8 significant bits) at the magnitude of ``x``."""
    return 2.0 ** (np.floor(np.log2(max(abs(x), 1e-30))) - 7)


def stats_case(dev, name, B, T, d, V, dt, tied=False):
    """K2 against its plain version; returns the max abs error of m and
    cand_w."""
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
    tmax = torch.ones((B,), device=dev)
    argm, m, l, cw = uncounted(unembed_verify_stats, h, w, cand, tmax)
    rargm, rm, rl, rcw = unembed_verify_stats_plain(h, w, cand, tmax)
    torch.cuda.synchronize()
    err = max(scaled_err(m, rm), scaled_err(cw, rcw),
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
        # step of the plain max
        logits = torch.matmul(h, w).float()
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
    log(f"  unembed_verify_stats {name}: B={B} T={T} d={d} V={V} {dt}: "
        f"max err {err:.3e} (tol {tol}; abs {abs_err:.3e}); argm differs in "
        f"{len(differ)} of {B * T} rows (largest gap {worst:.2f} bf16 steps)")
    if not err < tol:
        fail(f"unembed_verify_stats {name} disagrees with its plain version: "
             f"{err} >= {tol}")
    return abs_err


def qkv_case(dev, cfg, name, T, dt, lengths, S=2048, bias=False):
    """K3 against its plain version at ``cfg``'s attention widths; returns
    the max abs error."""
    from repro_torch.kernels.cache_update import (
        fused_qkv_rope_commit, fused_qkv_rope_commit_plain)
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
    kc, vc = rnd(B, S, Hkv, hd), rnd(B, S, Hkv, hd)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    cos, sin = rope_cos_sin(lens[:, None] + torch.arange(T, device=dev), hd,
                            cfg.rope_theta)
    k0, v0 = kc.clone(), vc.clone()
    k1, v1 = kc.clone(), vc.clone()
    got = uncounted(fused_qkv_rope_commit, x, p, lens, kc, vc, cos=cos,
                    sin=sin)
    ref = fused_qkv_rope_commit_plain(x, p, lens, k1, v1, cos=cos, sin=sin)
    torch.cuda.synchronize()
    pairs = list(zip((*got, kc, vc), (*ref, k1, v1)))
    err = max(scaled_err(g, r) for g, r in pairs)
    abs_err = max((g.float() - r.float()).abs().max().item() for g, r in pairs)
    pos = torch.arange(S, device=dev)[None, :]
    written = (pos >= lens[:, None]) & (pos < lens[:, None] + T)
    kept = ~written
    if not (torch.equal(kc[kept], k0[kept]) and torch.equal(vc[kept],
                                                           v0[kept])):
        fail(f"fused_qkv_rope_commit {name}: cache rows outside "
             f"[lengths, lengths + T) changed")
    tol = TOL["bfloat16" if dt == torch.bfloat16 else "float32"]
    log(f"  fused_qkv_rope_commit {name}: B={B} T={T} d={d} Hq={Hq} "
        f"Hkv={Hkv} hd={hd} S={S} {dt} lengths={lengths}: max err "
        f"{err:.3e} (tol {tol}; abs {abs_err:.3e}); rest of the cache "
        f"unchanged")
    if not err < tol:
        fail(f"fused_qkv_rope_commit {name} disagrees with its plain "
             f"version: {err} >= {tol}")
    return abs_err


def phase_fusion_kernels(dev):
    """K2 and K3 at openPangu-7B's widths (B 4, T 64: the spec step; T 1:
    the AR step).  Returns their max abs errors at the main bf16 spec-step
    shape."""
    from repro_torch.configs.registry import get_config

    cfg = get_config("openpangu-7b")
    d, V = cfg.d_model, cfg.vocab_size
    errs = {}
    for dt in (torch.float32, torch.bfloat16):
        errs["K2", dt] = stats_case(dev, "main", 4, 64, d, V, dt)
        stats_case(dev, "tied columns", 4, 64, d, V, dt, tied=True)
        stats_case(dev, "V 4099 (unaligned rows)", 2, 64, 512, 4099, dt)
        ragged = [1, 517, 1300, 1984]
        errs["K3", dt] = qkv_case(dev, cfg, "spec", 64, dt, ragged)
        qkv_case(dev, cfg, "AR", 1, dt, ragged)
        qkv_case(dev, cfg, "spec with biases", 64, dt, ragged, bias=True)
        qkv_case(dev, cfg, "rows past S", 64, dt, [2040, 0, 2047, 100])
    return errs["K2", torch.bfloat16], errs["K3", torch.bfloat16]


# ---------------------------------------------------------------------------
# phase 4: float32, full width, 2 layers: spec == AR exactly, fused too
# ---------------------------------------------------------------------------

def phase_f32(dev):
    from repro_torch.configs.registry import get_config
    from repro_torch.core.engine import ar_generate, build_engine
    from repro_torch.launch.serve import build_model, make_prompts
    from repro_torch.models.api import init_cache

    cfg = dataclasses.replace(get_config("openpangu-7b"), num_layers=2,
                              dtype="float32", param_dtype="float32",
                              name="openpangu-7b-2layer-f32")
    eng = build_engine(cfg, "medusa", use_kernel=True, device=dev)
    params, mp = build_model(cfg, 1, eng.dtree.K, dev)
    prompts = make_prompts(cfg.vocab_size, 4, 1, 16, 129)
    tok, plen = padded_batch(prompts, range(4))
    tok = torch.from_numpy(tok).to(dev)
    plen = torch.from_numpy(plen).to(dev)
    max_new, max_len = 32, 512
    reset_counts()
    sp, n_out, st = eng.generate(params, mp, tok, plen,
                                 eng.init_cache(4, max_len), max_new)
    ar, _ = ar_generate(cfg, params, tok, plen,
                        init_cache(cfg, 4, max_len, device=dev), max_new,
                        use_kernel=True)
    launches = read_counts()[0]
    sp, ar = sp.cpu(), ar.cpu()
    if not torch.equal(sp, ar):
        fail(f"float32 spec != AR:\nspec {sp.tolist()}\nAR   {ar.tolist()}")
    want = cfg.num_layers * (st.steps + max_new)
    mean_acc = st.accepted_sum.item() / (st.steps * 4)
    log(f"  f32 full width, 2 layers: spec == AR for 4 x {max_new} tokens; "
        f"{st.steps} spec steps (mean accepted {mean_acc:.3f}), "
        f"{max_new} AR steps, flash_decode launches {launches}")
    if launches != want:
        fail(f"flash_decode launched {launches} times, expected {want}")

    # the same weights with verify fusion: K2 verifies, K3 writes
    feng = build_engine(cfg, "medusa", use_kernel=True, device=dev,
                        verify_fusion=True)
    reset_counts()
    fsp, _, fst = feng.generate(params, mp, tok, plen,
                                feng.init_cache(4, max_len), max_new)
    far, _ = ar_generate(feng.cfg, params, tok, plen,
                         init_cache(cfg, 4, max_len, device=dev), max_new,
                         use_kernel=True)
    counts = read_counts()
    fsp, far = fsp.cpu(), far.cpu()
    if not (torch.equal(fsp, sp) and torch.equal(far, sp)):
        fail(f"float32 fused spec / fused AR != unfused spec:\nfused spec "
             f"{fsp.tolist()}\nfused AR   {far.tolist()}\nspec       "
             f"{sp.tolist()}")
    steps = cfg.num_layers * (fst.steps + max_new)
    want = (steps, fst.steps, steps)
    log(f"  f32 full width, 2 layers, verify fusion: fused spec == fused AR "
        f"== unfused spec; {fst.steps} spec steps, {max_new} AR steps; "
        f"launches K1 {counts[0]}, K2 {counts[1]}, K3 {counts[2]} "
        f"(expected {want})")
    if counts != want:
        fail(f"fused f32 launches {counts}, expected {want}")


# ---------------------------------------------------------------------------
# phases 5 and 6: the launcher on bf16 openPangu-7B, full width and depth,
# unfused and then with verify fusion on the same weights
# ---------------------------------------------------------------------------

REQUESTS, SLOTS, MAX_NEW, MAX_LEN = 8, 4, 64, 2048
SERVE_ARGV = ["--requests", str(REQUESTS), "--slots", str(SLOTS),
              "--max-new", str(MAX_NEW), "--max-len", str(MAX_LEN),
              "--min-prompt", "64", "--max-prompt", "257", "--seed", "0"]


def check_served(srv, counts, fused: bool):
    """Every request finished; the kernels of the path launched once per
    layer and step (K1, and with fusion K3) and once per step (K2)."""
    res = srv.results
    if any(r["status"] != "done" or len(r["output"]) != MAX_NEW
           for r in res):
        fail("not every request finished: "
             + str([(r["rid"], r["status"], len(r["output"])) for r in res]))
    steps = sum(res[g]["steps"] for g in range(0, REQUESTS, SLOTS))
    mean_acc = (sum(r["accepted"] for r in res)
                / sum(r["steps"] for r in res))
    per_layer = srv.cfg.num_layers * steps
    want = (per_layer, steps, per_layer) if fused else (per_layer, 0, 0)
    log(f"  served {REQUESTS} requests: {srv.tokens} tokens in "
        f"{srv.seconds:.3f}s = {srv.tokens / srv.seconds:.1f} tok/s; "
        f"{steps} decode steps; mean accepted length {mean_acc:.3f} "
        f"tokens per step (1 = no draft token accepted); launches K1 "
        f"{counts[0]}, K2 {counts[1]}, K3 {counts[2]} (expected {want})")
    if counts != want:
        fail(f"kernel launches on the path {counts}, expected {want}")


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


def phase_serve(dev):
    from repro_torch.launch import serve

    reset_counts()
    srv = serve.main(SERVE_ARGV)
    check_served(srv, read_counts(), fused=False)
    check_against_ar(srv, dev)
    return srv


def phase_serve_fused(dev, srv):
    """The launcher with ``--verify-fusion`` on ``srv``'s weights.  Returns
    the (K1, K2, K3) launches of its run."""
    from repro_torch.launch import serve

    reset_counts()
    fsrv = serve.main(SERVE_ARGV + ["--verify-fusion"],
                      weights=(srv.params, srv.medusa_params))
    counts = read_counts()
    check_served(fsrv, counts, fused=True)
    same = sum(np.array_equal(a["output"], b["output"])
               for a, b in zip(fsrv.results, srv.results))
    log(f"  {same} of {REQUESTS} answers token-identical to the unfused "
        f"launcher's; tokens/s {fsrv.tokens / fsrv.seconds:.1f} fused, "
        f"{srv.tokens / srv.seconds:.1f} unfused")
    check_against_ar(fsrv, dev)
    return counts


# ---------------------------------------------------------------------------
# phase 7: timing at the main path's spec-step shape
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
    ms = cuda_ms(lambda: uncounted(unembed_verify_stats, h, w, cand, tmax),
                 20)
    plain_ms = cuda_ms(
        lambda: unembed_verify_stats_plain(h, w, cand, tmax), 5)
    lib_ms = cuda_ms(lambda: torch.matmul(h2, w), 20)
    nbytes = d * V * 2 + N * d * 2 + N * 4 + B * 4 + N * 3 * 4 + N * T * 4
    flops = 2 * N * d * V
    b_ms, b_by = bound(nbytes, flops)
    log(f"  unembed_verify_stats (N={N} d={d} V={V} bf16): kernel {ms:.4f} "
        f"ms, plain {plain_ms:.4f} ms, torch.matmul of the product only "
        f"{lib_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}: {nbytes} bytes, "
        f"{flops} flops)")
    return {"name": "unembed_verify_stats", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/verify_stats.cu",
            "replaces": "src/repro/kernels/tree_attention.py:298",
            "launches": launches, "max_abs_err": max_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib_ms}


def time_fused_qkv(dev, cfg, lens, launches, max_err):
    """K3 at the spec step (T 64) and the AR step (T 1).  Each timed launch
    takes the next of 4 weight sets (201 MB, four times the L2), so it
    reads its weights from HBM as a layer of the live step does."""
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
        ms = cuda_ms(lambda: uncounted(
            fused_qkv_rope_commit, x, sets[next(it) % 4], lengths, kc, vc,
            cos=cos, sin=sin), 40)
        plain_ms = cuda_ms(lambda: fused_qkv_rope_commit_plain(
            x, sets[next(it) % 4], lengths, kc, vc, cos=cos, sin=sin), 8)
        lib_ms = cuda_ms(lambda: torch.matmul(x2, cats[next(it) % 4]), 40)
        cols = (Hq + 2 * Hkv) * hd
        nbytes = (d * cols * 2 + N * d * 2 + N * cols * 2
                  + 2 * N * Hkv * hd * 2 + 2 * N * hd // 2 * 4 + B * 4)
        flops = 2 * N * d * cols
        b_ms, b_by = bound(nbytes, flops)
        out[T] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                      bound_ms=b_ms, bound_by=b_by)
        log(f"  fused_qkv_rope_commit T={T} (B={B} d={d} Hq={Hq} Hkv={Hkv} "
            f"hd={hd} bf16, lengths {lens}): kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, torch.matmul of the product only "
            f"{lib_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}: {nbytes} bytes, "
            f"{flops} flops)")
    main = out[64]
    return {"name": "fused_qkv_rope_commit", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/fused_qkv_rope_commit.cu",
            "replaces": "src/repro/kernels/cache_update.py:209",
            "launches": launches, "max_abs_err": max_err, **main}


def time_flash_decode(dev, prompt_lens, max_new, launches, max_err):
    import torch.nn.functional as F

    from repro_torch.kernels.tree_attention import (flash_decode,
                                                    flash_decode_plain)

    B, S, Hkv, D = 4, 2048, 8, 128
    gen = torch.Generator(device=dev).manual_seed(0)
    # lengths mid-way through the first group's generation
    lens = [n + max_new // 2 for n in prompt_lens]
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    rows = {}
    for R in (256, 8):
        q = torch.randn((B, Hkv, R, D), generator=gen, device=dev,
                        dtype=torch.bfloat16) * (D ** -0.5)
        k = torch.randn((B, S, Hkv, D), generator=gen, device=dev,
                        dtype=torch.bfloat16)
        v = torch.randn((B, S, Hkv, D), generator=gen, device=dev,
                        dtype=torch.bfloat16)
        mask = (torch.arange(S, device=dev)[None, :]
                < lengths[:, None])[:, None, None, :]
        kt, vt = k.transpose(1, 2), v.transpose(1, 2)
        # the library call over the rows the kernel sweeps (the cache cut
        # to the longest row) and, for comparison, over the whole cache
        S_run = max(lens)
        kr, vr, mr = kt[:, :, :S_run], vt[:, :, :S_run], mask[..., :S_run]
        ms = cuda_ms(lambda: uncounted(flash_decode, q, k, v, lengths), 100)
        plain_ms = cuda_ms(lambda: flash_decode_plain(q, k, v, lengths), 20)
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, kr, vr, attn_mask=mr, scale=1.0), 20)
        lib_full_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, kt, vt, attn_mask=mask, scale=1.0), 20)
        n_cols = sum(lens)
        nbytes = (q.numel() * 2 + 2 * n_cols * Hkv * D * 2 + B * 4
                  + B * Hkv * R * (D + 2) * 4)
        flops = 4 * R * D * Hkv * n_cols
        t_bytes = nbytes / H100_BYTES_PER_S * 1e3
        t_ops = flops / H100_BF16_FLOPS * 1e3
        rows[R] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                       bound_ms=max(t_bytes, t_ops),
                       bound_by="bytes" if t_bytes >= t_ops else "operations")
        log(f"  flash_decode R={R} (B={B} Hkv={Hkv} D={D} S={S} bf16, "
            f"lengths {lens}): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"sdpa over {S_run} rows {lib_ms:.4f} ms (over all {S} rows "
            f"{lib_full_ms:.4f} ms), bound {rows[R]['bound_ms']:.5f} ms "
            f"({rows[R]['bound_by']}: {nbytes} bytes, {flops} flops; "
            f"f32 CUDA-core floor {flops / H100_F32_FLOPS * 1e3:.5f} ms)")
    main = rows[256]
    return {"name": "flash_decode", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_decode.cu",
            "replaces": "src/repro/kernels/tree_attention.py:126",
            "launches": launches, "max_abs_err": max_err,
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"]}


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

    log("phase 2: flash_decode kernel vs plain version on the card")
    k1_err = phase_kernels(dev)

    log("phase 3: unembed_verify_stats and fused_qkv_rope_commit kernels vs "
        "plain versions on the card")
    k2_err, k3_err = phase_fusion_kernels(dev)
    torch.cuda.empty_cache()

    log("phase 4: float32, full width, 2 layers: speculative == AR, fused "
        "too")
    phase_f32(dev)
    torch.cuda.empty_cache()

    log("phase 5: the launcher on bf16 openPangu-7B, full width and depth")
    srv = phase_serve(dev)

    log("phase 6: the launcher with --verify-fusion on the same weights")
    launches = phase_serve_fused(dev, srv)
    prompt_lens = [len(p) for p in srv.prompts[:4]]
    del srv
    torch.cuda.empty_cache()

    log("phase 7: timing at the main path's spec-step shape")
    cfg = get_config("openpangu-7b")
    rows = [time_flash_decode(dev, prompt_lens, MAX_NEW, launches[0],
                              k1_err),
            time_verify_stats(dev, cfg, launches[1], k2_err),
            time_fused_qkv(dev, cfg, [n + MAX_NEW // 2 for n in prompt_lens],
                           launches[2], k3_err)]
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
