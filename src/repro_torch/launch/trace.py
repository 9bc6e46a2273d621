"""Where a decode step's time goes, on the card: ``torch.profiler`` over a
few speculative steps and a few AR steps of the served model, each run
eagerly and as the captured CUDA graph the engine replays.

  PYTHONPATH=src python -m repro_torch.launch.trace [--steps 4] \
      [--cache-dtype int8] [--cache-layout paged] [--page-size 64] \
      [--temperature 0.7]

Builds the launcher's model (bf16 openPangu-7B at full width and depth,
random weights from seed 0), prefills 4 prompts of 64–256 tokens from the
same seed, then runs six kinds of step in turn on the one cache, each
from where the last left off: the speculative loop body
(``SpecEngine.loop_step``) eagerly (``graphs=False``) and as a graph,
the AR loop body (``ar_loop_step``) eagerly and as a graph, and the
verify-fusion engine's loop body (``verify_fusion=True``: the
``unembed_verify_stats`` and ``fused_qkv_rope_commit`` kernels in place
of the [B, T, V] logits and the unfused write side) eagerly and as a
graph; then the same three loop bodies sampled (``accept="sample"`` at
``--temperature``, the AR body ``ar_generate_sampled``'s): the warp,
the sort of the nucleus and the rejection-sampling walk in place of the
greedy rule, the fused kernel at per-row temperatures.  Each kind warms
up for two steps (a graph: its eager warm-up
step, then its capture and first replay), then runs ``--steps`` steps
timed and ``--steps`` under the profiler; the spec kinds end each step
with the loop's exit test, a host read, as ``generate`` does.  For each
it prints the wall time per step (host clock around synchronised work,
once without the profiler and once under it: the difference is the
profiler's own cost on the host), the device time per step (sum of the
CUDA kernels' own time), the device's idle share (1 - device / wall
without the profiler), the kernel launches per step as the profiler sees
them (inside the graph, for a graph kind), the graph replays per step
and the capture's seconds, the kernels that take the most device time
and every one of the port's own kernels, with their time per launch.
``--cache-dtype``, ``--cache-layout`` and ``--page-size`` (the
launcher's flags, names and defaults) trace the same steps on the int8
cache and on the paged pool.
"""
from __future__ import annotations

import argparse
import dataclasses
import re
import time

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs.base import SamplingParams
from repro_torch.configs.registry import get_config
from repro_torch.core.engine import ar_loop_step, build_engine
from repro_torch.launch.serve import build_model, make_prompts
from repro_torch.runtime import resolve_device


def _port_kernels() -> set:
    """Names of the kernels defined in the port's ``kernels/csrc/``."""
    from repro_torch.kernels.build import CSRC
    pat = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\(.*?\)\s+)?"
                     r"(\w+)\s*\(", re.S)
    return {m[1] for f in CSRC.glob("*.cu*")
            for m in pat.finditer(f.read_text())}


def _kernel_name(key: str) -> str:
    """The unqualified name in a profiler key such as
    ``void (anonymous namespace)::decode_mma<...>(...)``."""
    m = re.search(r"::(\w+)[<(]", key)
    return m[1] if m else key


def _device_us(evt) -> float:
    return getattr(evt, "self_device_time_total",
                   getattr(evt, "self_cuda_time_total", 0.0))


def report(name: str, prof, wall_s: float, traced_s: float, steps: int,
           replays: int, capture_s: float, top: int = 12):
    """Print one traced phase's per-step breakdown, with the graph
    replays under the profiler and the graph's capture seconds."""
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(_device_us(e) for e in kernels) / 1e3 / steps
    launches = sum(e.count for e in kernels)
    wall_ms = wall_s * 1e3 / steps
    print(f"{name}: wall {wall_ms:.3f} ms/step ({traced_s * 1e3 / steps:.3f} "
          f"under the profiler), device {dev_ms:.3f} ms/step, device idle "
          f"{1 - dev_ms / wall_ms:.3f}, {launches / steps:.0f} kernel "
          f"launches/step, {replays / steps:.2f} graph replays/step, "
          f"capture {capture_s:.3f} s")
    ranked = sorted(kernels, key=_device_us, reverse=True)
    own = _port_kernels()
    # the top kernels, then the port's own below them, each with its time
    # a launch
    for e in ranked[:top] + [e for e in ranked[top:]
                             if _kernel_name(e.key) in own]:
        print(f"  {_device_us(e) / 1e3 / steps:9.4f} ms/step "
              f"{e.count / steps:6.0f}x "
              f"{_device_us(e) / 1e3 / max(e.count, 1):8.4f} ms/launch  "
              f"{e.key[:90]}")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="repro_torch.launch.trace")
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--cache-dtype", default="", choices=("", "int8"))
    ap.add_argument("--cache-layout", default="dense",
                    choices=("dense", "paged"))
    ap.add_argument("--page-size", type=int, default=64)
    ap.add_argument("--temperature", type=float, default=0.7,
                    help="the sampled kinds' temperature")
    args = ap.parse_args(argv)

    dev = resolve_device("cuda")
    cfg = dataclasses.replace(get_config("openpangu-7b"),
                              cache_dtype=args.cache_dtype,
                              cache_layout=args.cache_layout,
                              page_size=args.page_size)
    print(f"{cfg.name}: {cfg.resolved_cache_dtype} {cfg.cache_layout} cache"
          + (f", page size {cfg.page_size}" if cfg.paged else ""))
    sp = SamplingParams(temperature=args.temperature)
    engines = {(vf, graphs, accept): build_engine(
        cfg, "medusa", use_kernel=True, device=dev, verify_fusion=vf,
        graphs=graphs, accept=accept, sampling=sp)
        for vf in (False, True) for graphs in (False, True)
        for accept in ("greedy", "sample")}
    eng = engines[False, False, "greedy"]
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
    # where the generation stands, handed from one kind of step to the next
    pos = {"lengths": lengths, "base": base, "state": state}
    n = 2 + 2 * args.steps                 # steps each kind runs

    def spec(vf, graphs, accept="greedy"):
        step, c = engines[vf, graphs, accept].loop_step(params, mp, cache,
                                                        pos["state"], n)
        c.load(pos["lengths"], pos["base"], pos["state"], sp.temperature,
               sp.top_p)

        def step_and_exit_test():
            step()
            bool(torch.any(c.n_out < n))  # the loop's exit test, a host read

        def done():
            pos.update(lengths=c.lengths.clone(), base=c.base.clone(),
                       state={k: t.clone() for k, t in c.state.items()})
        return step, step_and_exit_test, done

    def ar(graphs, accept="greedy"):
        e = engines[False, graphs, accept]
        sampled = (sp, e.generator) if accept == "sample" else ()
        step, c = ar_loop_step(cfg, params, cache, n, True, e.step_graphs,
                               *sampled)
        c.lengths.copy_(pos["lengths"])
        c.tok.copy_(pos["base"])
        c.i.zero_()
        c.temperature.fill_(sp.temperature)
        c.top_p.fill_(sp.top_p)

        def done():
            pos.update(lengths=c.lengths.clone(), base=c.tok.clone())
        return step, step, done

    def timed(step):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    kinds = (("spec", lambda: spec(False, False)),
             ("spec graph", lambda: spec(False, True)),
             ("ar", lambda: ar(False)), ("ar graph", lambda: ar(True)),
             ("spec-fused", lambda: spec(True, False)),
             ("spec-fused graph", lambda: spec(True, True)),
             ("spec sampled", lambda: spec(False, False, "sample")),
             ("spec sampled graph", lambda: spec(False, True, "sample")),
             ("ar sampled", lambda: ar(False, "sample")),
             ("ar sampled graph", lambda: ar(True, "sample")),
             ("spec-fused sampled", lambda: spec(True, False, "sample")),
             ("spec-fused sampled graph", lambda: spec(True, True, "sample")))
    for name, make in kinds:
        graph, step, done = make()
        for _ in range(2):          # warm up (a graph: warm-up, capture)
            step()
        wall = timed(step)
        replays = graph.replays
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            traced = timed(step)
        done()
        report(name, prof, wall, traced, args.steps, graph.replays - replays,
               graph.capture_s)


if __name__ == "__main__":
    main()
