#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA GPU.

  python3 chip_smoke.py

Run from the repo root of a checkout.  It imports nothing of JAX or of the
JAX package.  Every phase must pass, and any failure ends the run with a
non-zero exit:

1. print the card's name and power limit; build every CUDA kernel of the
   port from the checkout's sources (one nvcc per source, in parallel);
2. hold the ``flash_decode`` kernel against ``flash_decode_plain`` on the
   card (the reference's kernel-test shape sweep plus the main path's
   shapes, f32 and bf16), and ``ops.tree_attention`` against the
   ``tree_attention_ref`` oracle;
3. float32 openPangu-7B at full width, 2 layers: speculative ``generate``
   == ``ar_generate`` token for token, both through the kernel, which must
   launch 2 x (spec steps + AR steps) times;
4. the main path: the launcher (``repro_torch.launch.serve.main``) serves 8
   requests on bf16 openPangu-7B at full width and depth; every request
   must finish, and each one matches ``ar_generate`` up to its first
   divergence, where AR's logit for the token the speculative path emitted
   must lie within ``MARGIN_BOUND`` of AR's top logit;
5. time the kernel, its plain version and ``scaled_dot_product_attention``
   (a yardstick the port never calls) at the main path's spec-step shape;
   the yardstick sweeps the same rows as the kernel (the cache cut to the
   longest row), and is also timed over the whole cache.

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
# phase 3: float32, full width, 2 layers: spec == AR exactly
# ---------------------------------------------------------------------------

def phase_f32(dev):
    from repro_torch.configs.registry import get_config
    from repro_torch.core.engine import ar_generate, build_engine
    from repro_torch.kernels.tree_attention import flash_decode
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
    flash_decode.launches = 0
    sp, n_out, st = eng.generate(params, mp, tok, plen,
                                 eng.init_cache(4, max_len), max_new)
    ar, _ = ar_generate(cfg, params, tok, plen,
                        init_cache(cfg, 4, max_len, device=dev), max_new,
                        use_kernel=True)
    torch.cuda.synchronize()
    launches = flash_decode.launches
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


# ---------------------------------------------------------------------------
# phase 4: the main path through the launcher, bf16 full width and depth
# ---------------------------------------------------------------------------

def phase_serve(dev):
    from repro_torch.core.engine import ar_generate
    from repro_torch.kernels.tree_attention import flash_decode
    from repro_torch.launch import serve
    from repro_torch.models.api import init_cache

    requests, slots, max_new, max_len = 8, 4, 64, 2048
    argv = ["--requests", str(requests), "--slots", str(slots),
            "--max-new", str(max_new), "--max-len", str(max_len),
            "--min-prompt", "64", "--max-prompt", "257", "--seed", "0"]
    flash_decode.launches = 0
    srv = serve.main(argv)
    launches = flash_decode.launches
    res = srv.results
    if any(r["status"] != "done" or len(r["output"]) != max_new for r in res):
        fail("not every request finished: "
             + str([(r["rid"], r["status"], len(r["output"])) for r in res]))
    steps = sum(res[g]["steps"] for g in range(0, requests, slots))
    mean_acc = (sum(r["accepted"] for r in res)
                / sum(r["steps"] for r in res))
    log(f"  served {requests} requests: {srv.tokens} tokens in "
        f"{srv.seconds:.3f}s = {srv.tokens / srv.seconds:.1f} tok/s; "
        f"{steps} decode steps; mean accepted length {mean_acc:.3f} "
        f"tokens per step (1 = no draft token accepted); flash_decode "
        f"launches {launches}")
    if launches != srv.cfg.num_layers * steps:
        fail(f"flash_decode launched {launches} times on the main path, "
             f"expected {srv.cfg.num_layers * steps}")

    diverged, worst, ar_seconds = 0, 0.0, 0.0
    for g in range(0, requests, slots):
        rows = list(range(g, g + slots))
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

        cache = init_cache(srv.cfg, slots, max_len, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ar, _ = ar_generate(srv.cfg, srv.params, tok, plen, cache, max_new,
                            use_kernel=True, observe=observe)
        ar = ar.cpu()
        ar_seconds += time.perf_counter() - t0
        gaps = torch.stack(gaps, 1).cpu()
        margins = torch.stack(margins, 1).cpu()
        for j, i in enumerate(rows):
            differ = (spec[j].cpu() != ar[j]).nonzero()
            if len(differ) == 0:
                log(f"  req {i}: spec == AR for all {max_new} tokens")
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
    log(f"  ar_generate on the same groups: {requests * max_new} tokens in "
        f"{ar_seconds:.3f}s = {requests * max_new / ar_seconds:.1f} tok/s "
        f"(the margin readings included)")
    log(f"  divergences: {diverged} of {requests} requests "
        f"(largest AR gap to the spec token at a divergence {worst:.5f})")
    return srv, launches


# ---------------------------------------------------------------------------
# phase 5: timing at the main path's spec-step shape
# ---------------------------------------------------------------------------

def phase_timing(dev, prompt_lens, max_new, launches, max_err):
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
        saved = flash_decode.launches
        ms = cuda_ms(lambda: flash_decode(q, k, v, lengths), 100)
        flash_decode.launches = saved      # timing launches are not counted
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
    max_err = phase_kernels(dev)

    log("phase 3: float32, full width, 2 layers: speculative == AR")
    phase_f32(dev)
    torch.cuda.empty_cache()

    log("phase 4: the launcher on bf16 openPangu-7B, full width and depth")
    srv, launches = phase_serve(dev)
    prompt_lens = [len(p) for p in srv.prompts[:4]]
    del srv
    torch.cuda.empty_cache()

    log("phase 5: timing at the main path's spec-step shape")
    row = phase_timing(dev, prompt_lens, 64, launches, max_err)
    log(f"chip_smoke: all phases passed in "
        f"{time.perf_counter() - t_start:.1f}s")
    print(smi_line(), flush=True)
    print(json.dumps({"kernels": [row]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
