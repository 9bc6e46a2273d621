"""Where a decode step's time goes, on the card: ``torch.profiler`` over a
few speculative steps and a few AR steps of the served model, each run
eagerly and as the captured CUDA graph the engine replays.

  PYTHONPATH=src python -m repro_torch.launch.trace [--arch openpangu-7b] \
      [--steps 4] [--cache-dtype int8] [--cache-layout paged] \
      [--page-size 64] [--temperature 0.7] [--only KIND,KIND] \
      [--proposer medusa|draft|ngram] [--gamma 4] [--one-unit]

Builds the launcher's model (bf16 ``--arch``, by default openPangu-7B,
at full width and depth, random weights from seed 0), prefills 4 prompts
of 64–256 tokens from the same seed, then runs each kind of step in turn
on the one cache, each from where the last left off: the speculative loop body
(``SpecEngine.loop_step``) eagerly (``graphs=False``) and as a graph,
the AR loop body (``ar_loop_step``) eagerly and as a graph, and the
verify-fusion engine's loop body (``verify_fusion=True``: the
``unembed_verify_stats`` and ``fused_qkv_rope_commit`` kernels in place
of the [B, T, V] logits and the unfused write side) eagerly and as a
graph; then the same three loop bodies sampled (``accept="sample"`` at
``--temperature``, the AR body ``ar_generate_sampled``'s): the warp,
the sort of the nucleus and the rejection-sampling walk in place of the
greedy rule, the fused kernel at per-row temperatures; then the greedy
unfused and fused loop bodies of a deferred engine (``deferred=True``:
no tree-row cache write, commit the only one; under fusion the unfused
projection and RoPE in place of ``fused_qkv_rope_commit``); then the
serving scheduler's iteration (``SpecServer.step_once``: the captured
serve step of all 4 slots with the masked commit and the on-device EOS
and budget scan, its one sync read and the host's apply and reap; the
kinds ``serve``, ``serve graph`` and ``serve-fused graph``) on a server
of its own over the same weights, the 4 prompts admitted in its first
iteration with budgets that outlast the trace.  Each kind warms
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
For the eager kinds it also prints the commit's row: the device ms and
launches per step of the kernels issued inside the model's ``commit``
and of ``decode``'s stacks of its in-flight rows (``aten::stack`` inside
``decode``), each kernel by name.  The script wraps the model module's
``decode`` and ``commit`` in ``record_function`` ranges itself (a
replayed graph carries no ranges), so it reads any tree of the port the
same way.  For a MoE ``--arch`` the eager kinds also print the MoE's
row: the device ms and launches per step of its four stages
(``layers.moe_route``: router, top-k, queue positions and the one-hot
dispatch and combine tensors; ``moe_dispatch``; ``moe_experts``: the
three expert products and the activation; ``moe_combine``), each
wrapped in a range the same way.  For an arch with SSM positions
(``--arch mamba2-2.7b``, or the hybrid) the eager kinds print the SSM
mixer's row: the device ms and launches per step of the kernels issued
inside ``ssm.mamba2_decode`` (the projections, the loop over the chain's
tokens, the gated norm and the output projection), wrapped in a range
the same way.  For the encoder-decoder (``--arch whisper-tiny``, every
request with random stub frames) the eager kinds print the
cross-attention's row: the device ms and launches per step of the
kernels issued inside ``layers.attention_cross`` (the query projection,
the scores over the frames' k/v, the output projection); the encoder
runs at prefill only, so its row comes once, before the kinds: the
device ms and launches of one prefill's ``encdec.encode`` and of its
``layers.cross_kv``, traced the same way.  ``--one-unit`` traces
jamba-1.5-large-398b at full width cut to one 4-position unit
(``configs.jamba_15_large_398b.ONE_UNIT``), the depth one card holds.
``--cache-dtype``, ``--cache-layout`` and ``--page-size`` (the
launcher's flags, names and defaults) trace the same steps on the int8
cache and on the paged pool.  ``--proposer`` and ``--gamma`` (the
launcher's flags) trace the spec kinds of the draft-model or n-gram
engine instead of the Medusa one (the draft: the launcher's 2-layer
sibling with its weights from ``proposer_params``); the AR kinds are the
same whatever the proposer.

``--tp N --tp-backend nccl|gloo`` traces the tensor-parallel step
instead: N ranks (``collectives.spawn``; nccl wants a card a rank, gloo
lets them share one) each build the model's slices and prefill the same
4 prompts, then run the eager TP spec step (``TPSpecEngine``'s loop
body): two warm-up steps, ``--steps`` timed, ``--steps`` with the
collectives metered (``collectives.metered``: their count, and their ms
by CUDA events under nccl, by the host clock around each synchronous
call under gloo, whose CUDA path copies through the host), ``--steps``
under the profiler.  Each rank reports (``tp_profile``) its wall and
device ms a step (NCCL's kernels apart: they spin until every rank
arrives), the device's idle share, the kernel launches a step,
the collectives' count and ms a step, the device ms a step of NCCL's
kernels and of the host copies (gloo's staging among them), and its top
kernels; rank 0's lines are printed with every rank's summary.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import re
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch.configs.base import SamplingParams
from repro_torch.configs.jamba_15_large_398b import ONE_UNIT
from repro_torch.configs.registry import ALL_ARCHS, get_config
from repro_torch.core.engine import ar_loop_step, build_engine
from repro_torch.launch.serve import (build_model, make_prompts,
                                      proposer_params, request_frames)
from repro_torch.models import encdec, layers, ssm
from repro_torch.models.api import get_model
from repro_torch.runtime import resolve_device, tree_map
from repro_torch.serving.scheduler import SpecServer

DECODE_RANGE, COMMIT_RANGE = "model.decode", "model.commit"
MOE_STAGES = ("moe_route", "moe_dispatch", "moe_experts", "moe_combine")
SSM_RANGE = "mamba2_decode"
CROSS_RANGE, ENCODE_RANGE, CROSS_KV_RANGE = ("attention_cross", "encode",
                                             "cross_kv")


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


def _ranged(name: str, fn):
    def call(*args, **kwargs):
        with record_function(name):
            return fn(*args, **kwargs)
    return call


def range_model(model, layers, ssm, encoder=None):
    """Wrap ``model.decode`` and ``model.commit`` (the model module every
    engine and the AR loop call through), the MoE's stages in ``layers``
    (``layers.moe`` calls them through the module), the SSM mixer's
    ``ssm.mamba2_decode`` (called through its module too) and the
    encoder-decoder's ``layers.attention_cross`` / ``cross_kv`` in
    profiler ranges; with the ``encoder`` module (``models.encdec``), its
    ``encode`` too."""
    model.decode = _ranged(DECODE_RANGE, model.decode)
    model.commit = _ranged(COMMIT_RANGE, model.commit)
    for name in MOE_STAGES + (CROSS_RANGE, CROSS_KV_RANGE):
        setattr(layers, name, _ranged(name, getattr(layers, name)))
    ssm.mamba2_decode = _ranged(SSM_RANGE, ssm.mamba2_decode)
    if encoder is not None:
        encoder.encode = _ranged(ENCODE_RANGE, encoder.encode)


def _within(evt, ranges) -> bool:
    t = evt.time_range
    return any(r.start <= t.start and t.end <= r.end for r in ranges)


def _inside(evt, name: str) -> bool:
    while evt.cpu_parent is not None:
        evt = evt.cpu_parent
        if evt.name == name:
            return True
    return False


def range_row(prof, steps: int, title: str, pick):
    """Print the device ms and launches per step of the kernels launched
    inside host ranges: ``pick(events)`` -> {label: [time ranges]}; each
    label's kernels by name and launches per step, under ``title``.  A
    kernel is matched to its launch (a CUDA runtime call, by correlation
    id) and the launch to the range by its host time: the port's kernels
    launch through ctypes, outside any PyTorch op, so only the runtime
    call ties them to the range."""
    cpu, cuda = (torch.autograd.DeviceType.CPU,
                 torch.autograd.DeviceType.CUDA)
    events = prof.events()
    kernels = collections.defaultdict(list)   # correlation id -> kernels
    for e in events:
        if e.device_type == cuda and not getattr(e, "is_user_annotation",
                                                 False):
            kernels[e.id].append(e)
    calls = [e for e in events if e.device_type == cpu
             and e.name.startswith("cu") and e.id in kernels]
    parts = {label: [k for c in calls if _within(c, rs) for k in kernels[c.id]]
             for label, rs in pick(events).items()}
    every = [k for ks in parts.values() for k in ks]

    def ms(ks):
        return sum(k.time_range.elapsed_us() for k in ks) / 1e3 / steps

    print(f"  {title}: {ms(every):.4f} ms/step device, "
          f"{len(every) / steps:.0f} launches/step")
    for label, ks in parts.items():
        names = collections.Counter(_kernel_name(k.name) for k in ks)
        print(f"    {label}: {ms(ks):.4f} ms/step, {len(ks) / steps:.0f} "
              f"launches/step: " + ", ".join(
                  f"{n} {c / steps:.0f}x" for n, c in names.most_common()))


def _cpu_ranges(events, name, inside=None):
    return [e.time_range for e in events
            if e.device_type == torch.autograd.DeviceType.CPU
            and e.name == name and (inside is None or _inside(e, inside))]


def commit_row(prof, steps: int):
    """The commit's row: the kernels launched inside the model's
    ``commit``, and those of ``decode``'s stacks of its in-flight rows."""
    range_row(prof, steps, "commit row", lambda ev: {
        "commit": _cpu_ranges(ev, COMMIT_RANGE),
        "decode's stacks": _cpu_ranges(ev, "aten::stack", DECODE_RANGE)})


def moe_row(prof, steps: int):
    """The MoE's row: the kernels launched inside each of its stages."""
    range_row(prof, steps, "MoE row", lambda ev: {
        name: _cpu_ranges(ev, name) for name in MOE_STAGES})


def ssm_row(prof, steps: int):
    """The SSM mixer's row: the kernels launched inside
    ``mamba2_decode``."""
    range_row(prof, steps, "SSM row", lambda ev: {
        SSM_RANGE: _cpu_ranges(ev, SSM_RANGE)})


def cross_row(prof, steps: int):
    """The encoder-decoder's cross-attention row: the kernels launched
    inside ``layers.attention_cross`` in the decode steps."""
    range_row(prof, steps, "cross-attention row", lambda ev: {
        CROSS_RANGE: _cpu_ranges(ev, CROSS_RANGE, DECODE_RANGE)})


def encoder_row(prof):
    """The encoder's row, for one prefill: the kernels launched inside
    ``encdec.encode`` and the cross k/v projections (``cross_kv``)."""
    range_row(prof, 1, "encoder row (one prefill)", lambda ev: {
        ENCODE_RANGE: _cpu_ranges(ev, ENCODE_RANGE),
        CROSS_KV_RANGE: _cpu_ranges(ev, CROSS_KV_RANGE)})


def report(name: str, prof, wall_s: float, traced_s: float, steps: int,
           replays: int, capture_s: float, top: int = 12):
    """Print one traced phase's per-step breakdown, with the graph
    replays under the profiler and the graph's capture seconds."""
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and e.key not in (DECODE_RANGE, COMMIT_RANGE, SSM_RANGE,
                                 CROSS_RANGE, ENCODE_RANGE, CROSS_KV_RANGE,
                                 *MOE_STAGES)]
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


def tp_profile(tpe, params, mp, prompts, steps: int, max_len: int = 2048,
               top: int = 8) -> dict:
    """The eager tensor-parallel spec step on this rank: ``tpe`` a
    ``TPSpecEngine`` with its sliced ``params`` and replicated Medusa heads
    ``mp`` (None for n-gram), ``prompts`` one group.  Every rank of the
    group must call it alike (the steps' collectives pair up).  Returns
    per-step figures: wall_ms (unmetered, unprofiled), device_ms (the
    kernels' own time under the profiler, NCCL's apart: an NCCL kernel
    runs on its own stream and spins until every rank has reached it, so
    its time is mostly the other ranks' lateness), idle (1 - device /
    wall), launches, collectives and collective_ms (metered), by_op and
    bytes_by_op (the metered collectives' count and result bytes a step,
    by op), nccl_ms and copy_ms (profiler device time of NCCL's kernels
    and of the memcpy records, gloo's staging among them), top (the
    kernels with the most device time: name, ms a step, launches a step),
    argument_bytes (the bytes of the step's arguments on this rank: its
    weights, proposer weights, cache, lengths, base tokens and proposer
    state)."""
    from repro_torch.distributed import collectives as C
    dev = tpe.device
    cuda = dev.type == "cuda"
    tok, plen = _padded(prompts, dev)
    cache = tpe.init_cache(len(prompts), max_len)
    cache, lengths, base, state = tpe.prefill(params, mp, tok, plen, cache)
    from repro_torch.launch.dryrun import leaves
    arg_bytes = sum(t.nbytes for t in leaves(
        (params, mp, cache, lengths, base, state)))
    n = 2 + 3 * steps
    step, c = tpe.local.loop_step(params, mp, cache, state, n)
    c.load(lengths, base, state, tpe.sampling.temperature,
           tpe.sampling.top_p)

    def step_and_exit_test():
        step()
        bool(torch.any(c.n_out < n))  # the loop's exit test, a host read

    def timed():
        if cuda:
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(steps):
            step_and_exit_test()
        if cuda:
            torch.cuda.synchronize(dev)
        return time.perf_counter() - t0

    for _ in range(2):
        step_and_exit_test()
    wall = timed()
    with C.metered() as meter:
        timed()
    count, coll_ms = meter.total()
    by_op = {op: n / steps for op, n in meter.count.items()}
    bytes_by_op = {op: b / steps for op, b in meter.bytes.items()}
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        timed()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]

    def ms(evts):
        return sum(_device_us(e) for e in evts) / 1e3 / steps

    nccl = [e for e in kernels if "nccl" in e.key.lower()]
    dev_ms = ms([e for e in kernels if e not in nccl])
    wall_ms = wall * 1e3 / steps
    ranked = sorted(kernels, key=_device_us, reverse=True)[:top]
    return {"wall_ms": wall_ms, "device_ms": dev_ms,
            "idle": 1 - dev_ms / wall_ms,
            "launches": sum(e.count for e in kernels) / steps,
            "collectives": count / steps, "collective_ms": coll_ms / steps,
            "by_op": by_op, "bytes_by_op": bytes_by_op,
            "argument_bytes": arg_bytes, "nccl_ms": ms(nccl),
            "copy_ms": ms([e for e in kernels
                           if e.key.lower().startswith("memcpy")]),
            "top": [(e.key[:80], _device_us(e) / 1e3 / steps,
                     e.count / steps) for e in ranked]}


def tp_lines(prof: dict) -> list:
    """``tp_profile``'s figures as printed lines."""
    lines = [f"wall {prof['wall_ms']:.3f} ms/step, device (NCCL apart) "
             f"{prof['device_ms']:.3f} ms/step, device idle "
             f"{prof['idle']:.3f}, {prof['launches']:.0f} kernel "
             f"launches/step; {prof['collectives']:.1f} collectives/step "
             f"taking {prof['collective_ms']:.3f} ms/step (metered); NCCL "
             f"kernels {prof['nccl_ms']:.4f} ms/step, memcpy "
             f"{prof['copy_ms']:.4f} ms/step on the device"]
    lines += [f"  {t:9.4f} ms/step {n:6.0f}x  {k}" for k, t, n in
              prof["top"]]
    return lines


def _padded(prompts, dev):
    S = max(len(p) for p in prompts)
    tok = torch.zeros((len(prompts), S), dtype=torch.int32)
    for j, p in enumerate(prompts):
        tok[j, :len(p)] = torch.from_numpy(p)
    plen = torch.tensor([len(p) for p in prompts], dtype=torch.int32)
    return tok.to(dev), plen.to(dev)


def _tp_trace_rank(rank, world, dev, argd):
    """One rank of ``--tp``: the model's slices, then ``tp_profile``."""
    from repro_torch.distributed import tp as TP
    args = argparse.Namespace(**argd)
    cfg = dataclasses.replace(get_config(args.arch),
                              cache_dtype=args.cache_dtype,
                              cache_layout=args.cache_layout,
                              page_size=args.page_size)
    mesh = TP.make_tp_group(world)
    tpe = TP.build_tp_engine(cfg, mesh, args.proposer, gamma=args.gamma,
                             use_kernel=True, device=dev)
    if args.proposer == "medusa":
        params, mp = build_model(cfg, 0, tpe.dtree.K, dev)
    else:
        params, mp = get_model(cfg).init_params(
            torch.Generator(device=dev).manual_seed(0), cfg,
            dtype=cfg.dtype), None
    sp = tpe.shard_params(params)
    del params
    torch.cuda.empty_cache()
    prof = tp_profile(tpe, sp, mp, make_prompts(cfg.vocab_size, 4, 0, 64,
                                                257), args.steps)
    if rank == 0:
        print(f"{cfg.name} tp={world} ({args.tp_backend}), rank 0 on {dev}: "
              + "\n".join(tp_lines(prof)), flush=True)
    return prof


def main(argv=None):
    ap = argparse.ArgumentParser(prog="repro_torch.launch.trace")
    ap.add_argument("--arch", default="openpangu-7b", choices=ALL_ARCHS)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--cache-dtype", default="", choices=("", "int8"))
    ap.add_argument("--cache-layout", default="dense",
                    choices=("dense", "paged"))
    ap.add_argument("--page-size", type=int, default=64)
    ap.add_argument("--temperature", type=float, default=0.7,
                    help="the sampled kinds' temperature")
    ap.add_argument("--only", default="",
                    help="comma-separated kinds to trace (e.g. "
                         "'spec-fused,spec-fused graph'); default: all")
    ap.add_argument("--proposer", default="medusa",
                    choices=("medusa", "draft", "ngram"),
                    help="the spec kinds' draft policy")
    ap.add_argument("--gamma", type=int, default=4,
                    help="chain length for the draft/ngram proposers")
    ap.add_argument("--one-unit", action="store_true",
                    help="jamba-1.5-large-398b at full width cut to one "
                         "4-position unit (the depth one card holds)")
    ap.add_argument("--tp", type=int, default=0,
                    help="trace the tensor-parallel step on this many "
                         "ranks instead (a dense --arch, medusa or ngram)")
    ap.add_argument("--tp-backend", default="nccl", choices=("nccl", "gloo"),
                    help="--tp's collectives: nccl (a card a rank) or gloo "
                         "(ranks sharing cards)")
    args = ap.parse_args(argv)
    if args.tp:
        from repro_torch.distributed import collectives as C
        profs = C.spawn(_tp_trace_rank, args.tp, backend=args.tp_backend,
                        args=(vars(args),))
        for r, prof in enumerate(profs):
            print(f"rank {r}: wall {prof['wall_ms']:.3f} ms/step, device "
                  f"{prof['device_ms']:.3f} ms/step, idle "
                  f"{prof['idle']:.3f}, {prof['collectives']:.1f} "
                  f"collectives/step in {prof['collective_ms']:.3f} ms/step")
        return profs
    if args.one_unit and args.arch != "jamba-1.5-large-398b":
        ap.error("--one-unit cuts jamba-1.5-large-398b")

    dev = resolve_device("cuda")
    base = ONE_UNIT if args.one_unit else get_config(args.arch)
    model = get_model(base)
    range_model(model, layers, ssm,
                encdec if model is encdec else None)
    cfg = dataclasses.replace(base,
                              cache_dtype=args.cache_dtype,
                              cache_layout=args.cache_layout,
                              page_size=args.page_size)
    print(f"{cfg.name}: {cfg.resolved_cache_dtype} {cfg.cache_layout} cache"
          + (f", page size {cfg.page_size}" if cfg.paged else "")
          + f"; {args.proposer} proposer"
          + ("" if args.proposer == "medusa" else f", gamma {args.gamma}"))
    sp = SamplingParams(temperature=args.temperature)
    engines = {(vf, graphs, accept, deferred): build_engine(
        cfg, args.proposer, gamma=args.gamma, use_kernel=True, device=dev,
        verify_fusion=vf, graphs=graphs, accept=accept, sampling=sp,
        deferred=deferred)
        for vf in (False, True) for graphs in (False, True)
        for accept, deferred in (("greedy", False), ("sample", False),
                                 ("greedy", True))}
    eng = engines[False, False, "greedy", False]
    if args.proposer == "medusa":
        params, mp = build_model(cfg, 0, eng.dtree.K, dev)
    else:
        params = model.init_params(
            torch.Generator(device=dev).manual_seed(0), cfg, dtype=cfg.dtype)
        mp = proposer_params(eng, 0)
    prompts = make_prompts(cfg.vocab_size, 4, 0, 64, 257)
    frames = request_frames(cfg, 4, 7, dev)
    extra = None if frames is None else \
        torch.from_numpy(np.stack(frames)).to(dev)
    S = max(len(p) for p in prompts)
    tok = torch.zeros((4, S), dtype=torch.int32)
    for j, p in enumerate(prompts):
        tok[j, :len(p)] = torch.from_numpy(p)
    tok = tok.to(dev)
    plen = torch.tensor([len(p) for p in prompts], dtype=torch.int32,
                        device=dev)
    cache = eng.init_cache(4, 2048)
    if extra is not None:
        # the encoder runs at prefill only: its row comes from one
        # prefill (after a warm-up one)
        eng.prefill(params, mp, tok, plen, cache, extra_embeds=extra)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            eng.prefill(params, mp, tok, plen, cache, extra_embeds=extra)
            torch.cuda.synchronize()
        encoder_row(prof)
    cache, lengths, base, state = eng.prefill(params, mp, tok, plen, cache,
                                              extra_embeds=extra)
    # where the generation stands, handed from one kind of step to the next
    pos = {"lengths": lengths, "base": base, "state": state}
    n = 2 + 2 * args.steps                 # steps each kind runs

    def spec(vf, graphs, accept="greedy", deferred=False):
        step, c = engines[vf, graphs, accept, deferred].loop_step(
            params, mp, cache, pos["state"], n)
        c.load(pos["lengths"], pos["base"], pos["state"], sp.temperature,
               sp.top_p)

        def step_and_exit_test():
            step()
            bool(torch.any(c.n_out < n))  # the loop's exit test, a host read

        def done():
            pos.update(lengths=c.lengths.clone(), base=c.base.clone(),
                       state=tree_map(torch.clone, c.state))
        return step, step_and_exit_test, done

    def ar(graphs, accept="greedy"):
        e = engines[False, graphs, accept, False]
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

    def serve(vf, graphs):
        """A server of 4 slots on the engine; its first iteration admits
        the 4 prompts and runs the eager warm-up step."""
        e = engines[vf, graphs, "greedy", False]
        srv = SpecServer(e, params, mp, batch_slots=4, max_len=2048)
        for r, p in enumerate(prompts):
            srv.submit(p, max_new=1000, max_steps=10 ** 6,
                       extra_embeds=None if frames is None else frames[r])
        srv.step_once()
        graph = srv.step_graphs()[e.dtree.K]
        return graph, srv.step_once, srv.release_all

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
             ("spec-fused sampled graph", lambda: spec(True, True, "sample")),
             ("spec deferred", lambda: spec(False, False, deferred=True)),
             ("spec deferred graph", lambda: spec(False, True, deferred=True)),
             ("spec-fused deferred", lambda: spec(True, False, deferred=True)),
             ("spec-fused deferred graph",
              lambda: spec(True, True, deferred=True)),
             ("serve", lambda: serve(False, False)),
             ("serve graph", lambda: serve(False, True)),
             ("serve-fused graph", lambda: serve(True, True)))
    only = set(filter(None, args.only.split(",")))
    if only - {name for name, _ in kinds}:
        ap.error(f"--only: no kind {sorted(only - {n for n, _ in kinds})}")
    for name, make in kinds:
        if only and name not in only:
            continue
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
        if not graph.capture:
            commit_row(prof, args.steps)
            if cfg.num_experts:
                moe_row(prof, args.steps)
            if cfg.num_ssm_layers:
                ssm_row(prof, args.steps)
            if model is encdec:
                cross_row(prof, args.steps)


if __name__ == "__main__":
    main()
