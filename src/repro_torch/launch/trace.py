"""Where a decode step's time goes, on the card: ``torch.profiler`` over a
few speculative steps and a few AR steps of the served model.

  PYTHONPATH=src python -m repro_torch.launch.trace [--steps 4] \
      [--cache-dtype int8] [--cache-layout paged] [--page-size 64]

Builds the launcher's model (bf16 openPangu-7B at full width and depth,
random weights from seed 0), prefills 4 prompts of 64–256 tokens from the
same seed and warms up, then traces ``--steps`` spec steps
(``SpecEngine.spec_step``), ``--steps`` AR decode steps
(``engine.ar_step``) and ``--steps`` spec steps of the verify-fusion
engine on the same weights (``build_engine(..., verify_fusion=True)``:
the ``unembed_verify_stats`` and ``fused_qkv_rope_commit`` kernels in
place of the [B, T, V] logits and the unfused write side).  For each it
prints the wall time per step (host clock around synchronised work, once
without the profiler and once under it: the difference is the profiler's
own cost on the host), the device time per step (sum of the CUDA
kernels' own time), the device's idle share (1 - device / wall without
the profiler), the kernel launches per step, and the kernels that take
the most device time.  ``--cache-dtype``, ``--cache-layout`` and
``--page-size`` (the launcher's flags, names and defaults) trace the same
steps on the int8 cache and on the paged pool.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs.registry import get_config
from repro_torch.core.engine import ar_step, build_engine
from repro_torch.launch.serve import build_model, make_prompts
from repro_torch.runtime import resolve_device


def _device_us(evt) -> float:
    return getattr(evt, "self_device_time_total",
                   getattr(evt, "self_cuda_time_total", 0.0))


def report(name: str, prof, wall_s: float, traced_s: float, steps: int,
           top: int = 12):
    """Print one traced phase's per-step breakdown."""
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(_device_us(e) for e in kernels) / 1e3 / steps
    launches = sum(e.count for e in kernels)
    wall_ms = wall_s * 1e3 / steps
    print(f"{name}: wall {wall_ms:.3f} ms/step ({traced_s * 1e3 / steps:.3f} "
          f"under the profiler), device {dev_ms:.3f} ms/step, device idle "
          f"{1 - dev_ms / wall_ms:.3f}, {launches / steps:.0f} kernel "
          f"launches/step")
    for e in sorted(kernels, key=_device_us, reverse=True)[:top]:
        print(f"  {_device_us(e) / 1e3 / steps:9.4f} ms/step "
              f"{e.count / steps:6.0f}x  {e.key[:90]}")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="repro_torch.launch.trace")
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--cache-dtype", default="", choices=("", "int8"))
    ap.add_argument("--cache-layout", default="dense",
                    choices=("dense", "paged"))
    ap.add_argument("--page-size", type=int, default=64)
    args = ap.parse_args(argv)

    dev = resolve_device("cuda")
    cfg = dataclasses.replace(get_config("openpangu-7b"),
                              cache_dtype=args.cache_dtype,
                              cache_layout=args.cache_layout,
                              page_size=args.page_size)
    print(f"{cfg.name}: {cfg.resolved_cache_dtype} {cfg.cache_layout} cache"
          + (f", page size {cfg.page_size}" if cfg.paged else ""))
    eng = build_engine(cfg, "medusa", use_kernel=True, device=dev)
    fused = build_engine(cfg, "medusa", use_kernel=True, device=dev,
                         verify_fusion=True)
    params, mp = build_model(cfg, 0, eng.dtree.K, dev)
    prompts = make_prompts(cfg.vocab_size, 4, 0, 64, 257)
    S = max(len(p) for p in prompts)
    tok = torch.zeros((4, S), dtype=torch.int32)
    for j, p in enumerate(prompts):
        tok[j, :len(p)] = torch.from_numpy(p)
    tok = tok.to(dev)
    plen = torch.tensor([len(p) for p in prompts], dtype=torch.int32,
                        device=dev)
    cache = eng.init_cache(4, 2048)
    cache, lengths, base, state = eng.prefill(params, mp, tok, plen, cache)

    def spec(engine=eng):
        nonlocal cache, lengths, base, state
        cache, lengths, verdict, state = engine.spec_step(
            params, mp, cache, lengths, base, state)
        base = verdict.next_token

    def ar():
        nonlocal cache, lengths, base
        logits, cache, lengths = ar_step(cfg, params, cache, base, lengths,
                                         use_kernel=True)
        base = torch.argmax(logits, dim=-1).to(torch.int32)

    def timed(step):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    for name, step in (("spec", spec), ("ar", ar),
                       ("spec-fused", lambda: spec(fused))):
        for _ in range(2):                                  # warm up
            step()
        wall = timed(step)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            traced = timed(step)
        report(name, prof, wall, traced, args.steps)


if __name__ == "__main__":
    main()
