"""Static-batch speculative server for the port: greedy Medusa tree
decoding through the ``flash_decode`` kernel.

  PYTHONPATH=src python -m repro_torch.launch.serve --requests 8 --slots 4 \\
      --max-new 64 --max-len 2048 --min-prompt 64 --max-prompt 257

Counterpart of the reference launcher's static-batch path
(``repro/launch/serve.py::serve_tp`` without tensor parallelism): seeded
numpy prompts, each group of ``--slots`` requests answered by one
``SpecEngine.generate``.  It serves openPangu-7B at full width on the card
by default (random weights from ``--seed``, in the config's bf16);
``--reduced`` takes the reference's reduced CPU-test config and
``--device cpu`` the plain PyTorch versions of the kernels.  Decode
attention always goes through ``kernels.ops.tree_attention``: there is no
switch that turns the kernel off.  ``--verify-fusion`` (the reference
launcher's flag, off by default) verifies from the
``unembed_verify_stats`` kernel's statistics and runs each layer's write
side through the ``fused_qkv_rope_commit`` kernel.  ``--cache-dtype int8``
and ``--cache-layout paged`` (with ``--page-size``) select the
reference's other KV-cache layouts, under the same flags: an int8 cache
with per-head-per-row f32 scales, and a block pool read through per-slot
block tables (the identity table here; the serving scheduler's allocator
is a later slice).
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import ALL_ARCHS, get_config
from repro_torch.core import medusa as M
from repro_torch.core.engine import SpecEngine, build_engine
from repro_torch.models.api import get_model
from repro_torch.runtime import resolve_device


class Served(NamedTuple):
    """What one launcher run built and answered (for callers that check
    the answers, such as ``chip_smoke.py``)."""
    cfg: ModelConfig
    engine: SpecEngine
    params: dict
    medusa_params: dict
    prompts: list
    results: list          # one dict per request, in submission order
    seconds: float
    tokens: int


def make_prompts(vocab: int, n: int, seed: int, lo: int, hi: int):
    """``n`` prompts of uniform random token ids, lengths in [lo, hi), from
    a numpy generator seeded with ``seed`` (the reference launcher's
    recipe, with its 4..48 lengths as the defaults)."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=int(rng.integers(lo, hi)))
            .astype(np.int32) for _ in range(n)]


def build_model(cfg, seed: int, K: int, device):
    """Random backbone weights in ``cfg.dtype`` drawn on ``device`` from
    ``seed``, and Medusa heads seeded from the backbone's lm head (Medusa's
    init recipe: with the zero-initialised residual block every head
    starts as a copy of the lm head)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    params = get_model(cfg).init_params(gen, cfg, dtype=cfg.dtype)
    mp = M.init_medusa(gen, cfg, K, base_lm_head=params["lm_head"],
                       dtype=cfg.dtype)
    return params, mp


def serve_static(engine: SpecEngine, params, mp, prompts, slots: int,
                 max_new: int, max_len: int):
    """Answer ``prompts`` in groups of ``slots`` through one
    ``engine.generate`` each.  A request whose prompt, ``max_new`` tokens
    and one step's tree rows do not fit ``max_len`` cache rows is
    rejected.  Returns (results, seconds, tokens)."""
    dev = engine.device
    need = max_new + engine.dtree.K + engine.dtree.T
    results = [{"rid": i, "prompt_len": len(p), "status": "rejected",
                "output": np.zeros((0,), np.int32), "steps": 0,
                "accepted": 0}
               for i, p in enumerate(prompts)]
    fits = [i for i, p in enumerate(prompts) if len(p) + need <= max_len]
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for g in range(0, len(fits), slots):
        group = fits[g:g + slots]
        S = max(len(prompts[i]) for i in group)
        tok = np.zeros((slots, S), np.int32)
        plen = np.zeros((slots,), np.int32)
        for j in range(slots):      # ragged tail: repeat the group's first row
            p = prompts[group[j] if j < len(group) else group[0]]
            tok[j, :len(p)] = p
            plen[j] = len(p)
        cache = engine.init_cache(slots, max_len)
        out, n_out, stats = engine.generate(
            params, mp, torch.from_numpy(tok).to(dev),
            torch.from_numpy(plen).to(dev), cache, max_new)
        out, n_out = out.cpu().numpy(), n_out.cpu().numpy()
        acc = stats.accepted_per_slot.cpu().numpy()
        for j, i in enumerate(group):
            results[i].update(status="done", output=out[j, :n_out[j]],
                              steps=stats.steps, accepted=int(acc[j]))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    seconds = max(time.perf_counter() - t0, 1e-9)
    tokens = sum(len(r["output"]) for r in results)
    return results, seconds, tokens


def main(argv=None, weights=None) -> Served:
    """Run the launcher on ``argv``.  ``weights``, if given, is a
    (params, medusa_params) pair for the configuration ``argv`` names,
    served in place of the random weights drawn from ``--seed`` (so one
    set of weights can be served under two settings without building the
    model twice)."""
    ap = argparse.ArgumentParser(
        prog="repro_torch.launch.serve",
        description="static-batch greedy Medusa serving on the PyTorch port")
    ap.add_argument("--arch", default="openpangu-7b", choices=ALL_ARCHS)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4,
                    help="requests per static batch")
    ap.add_argument("--max-new", type=int, default=64)
    ap.add_argument("--max-len", type=int, default=2048,
                    help="cache rows per slot")
    ap.add_argument("--min-prompt", type=int, default=4,
                    help="shortest prompt length drawn")
    ap.add_argument("--max-prompt", type=int, default=48,
                    help="prompt lengths are drawn below this")
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds the prompts and the random weights")
    ap.add_argument("--reduced", action="store_true",
                    help="the reference's reduced CPU-test config")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--verify-fusion", action="store_true",
                    help="fused unembed + acceptance statistics and fused "
                         "qkv + RoPE + cache write kernels")
    ap.add_argument("--cache-dtype", default="", choices=("", "int8"),
                    help="KV-cache storage dtype; int8 halves cache bytes "
                         "per slot")
    ap.add_argument("--cache-layout", default="dense",
                    choices=("dense", "paged"),
                    help="KV-cache layout: dense per-slot rows, or a paged "
                         "global block pool with per-slot block tables")
    ap.add_argument("--page-size", type=int, default=64,
                    help="paged layout: logical rows per pool block")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=args.reduced)
    if args.cache_dtype or args.cache_layout != "dense":
        cfg = dataclasses.replace(cfg, cache_dtype=args.cache_dtype,
                                  cache_layout=args.cache_layout,
                                  page_size=args.page_size)
    engine = build_engine(cfg, "medusa", use_kernel=True, device=dev,
                          verify_fusion=args.verify_fusion)
    if weights is None:
        params, mp = build_model(cfg, args.seed, engine.dtree.K, dev)
    else:
        params, mp = weights
    prompts = make_prompts(cfg.vocab_size, args.requests, args.seed,
                           args.min_prompt, args.max_prompt)
    results, seconds, tokens = serve_static(engine, params, mp, prompts,
                                            args.slots, args.max_new,
                                            args.max_len)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "CPU"
    for r in results:
        tps = len(r["output"]) / max(r["steps"], 1)
        print(f"  req {r['rid']}: {r['status']} prompt={r['prompt_len']} "
              f"steps={r['steps']} tokens/step={tps:.2f}")
    fused = " with verify fusion" if engine.cfg.verify_fusion else ""
    layout = ""
    if cfg.resolved_cache_dtype == "int8" or cfg.paged:
        layout = (f" ({cfg.resolved_cache_dtype} {cfg.cache_layout} cache"
                  + (f", page size {cfg.page_size}" if cfg.paged else "")
                  + ")")
    print(f"{cfg.name}{fused}{layout}: {len(results)} requests, {tokens} "
          f"tokens in {seconds:.3f}s ({tokens / seconds:.1f} tok/s on "
          f"{where})")
    return Served(engine.cfg, engine, params, mp, prompts, results, seconds,
                  tokens)


if __name__ == "__main__":
    main()
