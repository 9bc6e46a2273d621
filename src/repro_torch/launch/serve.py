"""Speculative serving on the port: the continuous-batching
``SpecServer`` by default, or static batches with ``--static``; Medusa
tree decoding, or draft-model or n-gram chain speculation
(``--proposer``), through the port's kernels, greedy or lossless sampled.

  PYTHONPATH=src python -m repro_torch.launch.serve --requests 8 --slots 4 \\
      --max-new 64 --max-len 2048 --min-prompt 64 --max-prompt 257 \\
      [--proposer medusa|draft|ngram] [--gamma 4] [--static]

Counterpart of the reference launcher (``repro/launch/serve.py``).  By
default it serves seeded numpy prompts through one ``SpecServer``
(``serving/scheduler.py``): ``--slots`` decode slots, requests admitted
as slots free up (``--admission batched|serial``), each request's own
``max_new`` (drawn from ``--min-new`` .. ``--max-new``).  The reference
server's flags select its mechanisms: ``--cache-layout paged`` serves
from an allocator-managed block pool (``--n-blocks`` sizes it; default
every slot's worst case), ``--prefix-cache`` shares prompt-prefix blocks
(with copy-on-write at a partial block), ``--chunk-size`` prefills long
prompts in pieces beside decode steps, ``--preemption`` allocates blocks
optimistically and preempts on exhaustion, ``--adaptive-gamma`` picks
the speculation depth each step from one of several captured step
graphs, ``--families medusa,ngram,draft`` serves one
``FamilySpecServer`` with a lane per proposer (requests round-robin), and
``--replicas N`` a prefix-affinity ``ReplicaRouter`` over N servers.
``--shared-prefix L`` prefixes every prompt with one of 4 seeded bases
of L tokens (the prefix cache's traffic; with ``--replicas`` it defaults
to two pages, as in the reference).  ``--static`` keeps the static-batch
path: each group of ``--slots`` requests answered by one
``SpecEngine.generate``.  ``--tp N`` serves the static batches through
the tensor-parallel engine (``distributed/tp.py``) on N ranks, one
process each (``--mesh-shape DATAxMODEL`` for a grid whose data rows
repeat the work), over ``--tp-backend nccl`` (a card a rank, the
default; fewer cards raise) or ``gloo`` (ranks on the CPU or sharing a
card); every rank's answers must equal rank 0's, and each rank's step
time, collectives and peak memory are printed (``--profile-steps N``
adds a profiled step breakdown, ``launch/trace.py``'s ``tp_profile``).
The dense family only, with Medusa or n-gram, neither verify fusion nor
``--deferred``: the reference's ``serve_tp``.

It serves openPangu-7B at full width on the card by default, or with
``--arch`` any architecture of the registry: the dense decoders
granite-8b, qwen1.5-0.5b, qwen1.5-4b and gemma-2b, the mixture-of-experts
granite-moe-1b-a400m and phi3.5-moe-42b-a6.6b, internvl2-26b, served
on its text alone as the reference launcher serves it, the state-space
mamba2-2.7b and the hybrid jamba-1.5-large-398b (both chain-mode: their
Medusa heads verify a chain of 4; the prefix cache is refused for them),
and the encoder-decoder whisper-tiny, each request with random frames
(the stub audio frontend's embeddings, drawn from ``--seed``; the prefix
cache and chunking are refused for it)
(random weights from ``--seed``, in the config's bf16); ``--reduced``
takes the reference's reduced CPU-test config and
``--device cpu`` the plain PyTorch versions of the kernels.  On the card
every decode step is a CUDA graph, captured at its second run and
replayed after it (one graph a speculation level for the server; the
engine keeps one cache per batch shape, so the static path's graph
replays for every group); the capture's seconds are printed apart from
the serving seconds.  Decode attention always goes through
``kernels.ops.tree_attention``: there is no switch that turns the kernel
off.  ``--verify-fusion`` verifies from the ``unembed_verify_stats``
kernel's statistics and runs each layer's write side through the
``fused_qkv_rope_commit`` kernel.  ``--cache-dtype int8`` and
``--cache-layout paged`` (with ``--page-size``) select the reference's
other KV-cache layouts: an int8 cache with per-head-per-row f32 scales,
and a block pool read through per-slot block tables (the identity table
under ``--static``).  ``--accept sample`` verifies by lossless rejection
sampling at ``--temperature`` (0, the default, is exact greedy) and
``--top-p`` (``--top-p`` below 1 is refused with ``--verify-fusion``);
the draws come from a generator seeded with ``--seed``.  ``--deferred``
serves through ``SpecEngine(deferred=True)``: the decode step writes no
tree row and commit is its only cache write.  ``--proposer`` picks the
draft policy: ``medusa`` (the default: Medusa heads seeded from the lm
head), ``draft`` (a 2-layer sibling of the model as the draft model, its
random weights drawn from ``--seed`` on the device) or ``ngram``
(train-free prompt lookup, no weights); ``--gamma`` (default 4) is the
chain length of the last two.  Each request's line gives its tokens a
step.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.configs.base import (ModelConfig, SamplingParams,
                                      SchedulerParams)
from repro_torch.configs.registry import ALL_ARCHS, get_config
from repro_torch.core import medusa as M
from repro_torch.core.engine import SpecEngine, build_engine
from repro_torch.core.proposers import DraftModelProposer
from repro_torch.kernels.tree_attention import pitch_lm_head
from repro_torch.models.api import get_model
from repro_torch.models.frontends import frontend_embeds
from repro_torch.runtime import resolve_device
from repro_torch.serving.router import ReplicaRouter
from repro_torch.serving.scheduler import FamilySpecServer, SpecServer


class Served(NamedTuple):
    """What one launcher run built and answered (for callers that check
    the answers, such as ``chip_smoke.py``)."""
    cfg: ModelConfig
    engine: SpecEngine
    params: dict
    proposer_params: Optional[dict]  # Medusa heads, draft weights or None
    prompts: list
    results: list          # one dict per request, in submission order
    seconds: float         # serving, the graphs' capture included
    tokens: int
    capture_s: float       # capturing and instantiating the step graphs
    server: object = None  # the SpecServer / FamilySpecServer /
                           # ReplicaRouter that answered (None: --static)
    iterations: int = 0    # scheduler iterations (0: --static)
    frames: Optional[list] = None  # the encoder-decoder's frames, one
                                   # [F, fd] float32 array a request


class ServedTP(NamedTuple):
    """What one ``--tp`` run answered: rank 0's results (every rank's are
    checked equal to them) and each rank's own figures."""
    cfg: ModelConfig
    prompts: list
    results: list          # rank 0's, one dict per request
    seconds: float         # rank 0's serving seconds
    tokens: int
    ranks: list            # per rank: coords, seconds, steps, the
                           # collectives' count and ms, peak bytes, device
    backend: str
    mesh: tuple            # (data, model)


def make_prompts(vocab: int, n: int, seed: int, lo: int, hi: int):
    """``n`` prompts of uniform random token ids, lengths in [lo, hi), from
    a numpy generator seeded with ``seed`` (the reference launcher's
    recipe, with its 4..48 lengths as the defaults)."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=int(rng.integers(lo, hi)))
            .astype(np.int32) for _ in range(n)]


def request_frames(cfg, n: int, seed: int, device):
    """One stub frontend output a request for an encoder-decoder ``cfg``
    (``frontend_embeds`` in ``cfg.dtype``, drawn on ``device`` from
    ``seed``): ``n`` [frontend_len, frontend_dim] float32 numpy arrays, as
    ``SpecServer.submit`` takes them.  None for another family."""
    if cfg.family != "encdec":
        return None
    gen = torch.Generator(device=device).manual_seed(seed)
    return [frontend_embeds(cfg, 1, gen)[0].float().cpu().numpy()
            for _ in range(n)]


def build_model(cfg, seed: int, K: int, device):
    """Random backbone weights in ``cfg.dtype`` drawn on ``device`` from
    ``seed``, and Medusa heads seeded from the backbone's unembedding
    weight, the lm head or a tied model's embedding table (Medusa's init
    recipe: with the zero-initialised residual block every head starts as
    a copy of it)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    model = get_model(cfg)
    params = model.init_params(gen, cfg, dtype=cfg.dtype)
    # a tied model's embed.T, copied once into the heads' own [K, d, V]
    mp = M.init_medusa(gen, cfg, K,
                       base_lm_head=model.unembed_weight(params)[0],
                       dtype=cfg.dtype)
    return params, mp


def proposer_params(engine: SpecEngine, seed: int):
    """The chain proposers' weights: for a draft-model engine the draft's
    random weights, drawn on the engine's device from ``seed + 1`` in the
    draft config's dtype; None for the n-gram lookup, which has none.
    (Medusa heads come with the backbone, from ``build_model``.)"""
    p = engine.proposer
    if isinstance(p, DraftModelProposer):
        gen = torch.Generator(device=engine.device).manual_seed(seed + 1)
        return p.dm.init_params(gen, p.dc, dtype=p.dc.dtype)
    return None


def serve_static(engine: SpecEngine, params, mp, prompts, slots: int,
                 max_new: int, max_len: int, frames=None):
    """Answer ``prompts`` in groups of ``slots`` through one
    ``engine.generate`` each, every group on the engine's one cache of
    ``slots`` x ``max_len`` rows; ``frames`` (the encoder-decoder's, one
    [F, fd] array a request) go to ``generate`` as the group's
    ``extra_embeds``.  A request whose prompt, ``max_new`` tokens and one
    step's tree rows do not fit ``max_len`` cache rows is rejected.
    Returns (results, seconds, tokens, capture_s): capture_s is the part
    of ``seconds`` spent capturing step graphs."""
    dev = engine.device
    need = max_new + engine.dtree.K + engine.dtree.T
    results = [{"rid": i, "prompt_len": len(p), "status": "rejected",
                "output": np.zeros((0,), np.int32), "steps": 0,
                "accepted": 0}
               for i, p in enumerate(prompts)]
    fits = [i for i, p in enumerate(prompts) if len(p) + need <= max_len]
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    capture0 = engine.step_graphs.capture_s
    t0 = time.perf_counter()
    for g in range(0, len(fits), slots):
        group = fits[g:g + slots]
        S = max(len(prompts[i]) for i in group)
        tok = np.zeros((slots, S), np.int32)
        plen = np.zeros((slots,), np.int32)
        # ragged tail: repeat the group's first row
        rows = [group[j] if j < len(group) else group[0]
                for j in range(slots)]
        for j, i in enumerate(rows):
            tok[j, :len(prompts[i])] = prompts[i]
            plen[j] = len(prompts[i])
        extra = None
        if frames is not None:
            extra = torch.from_numpy(np.stack([frames[i] for i in rows]))
            extra = extra.to(dev)
        cache = engine.init_cache(slots, max_len)
        out, n_out, stats = engine.generate(
            params, mp, torch.from_numpy(tok).to(dev),
            torch.from_numpy(plen).to(dev), cache, max_new,
            extra_embeds=extra)
        out, n_out = out.cpu().numpy(), n_out.cpu().numpy()
        acc = stats.accepted_per_slot.cpu().numpy()
        for j, i in enumerate(group):
            results[i].update(status="done", output=out[j, :n_out[j]],
                              steps=stats.steps, accepted=int(acc[j]))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    seconds = max(time.perf_counter() - t0, 1e-9)
    tokens = sum(len(r["output"]) for r in results)
    return results, seconds, tokens, engine.step_graphs.capture_s - capture0


def serve_requests(srv, prompts, max_news, temperature: float,
                   top_p: float, groups=None, frames=None):
    """Submit ``prompts`` (with their ``max_news``) to ``srv`` (a
    ``SpecServer``, ``FamilySpecServer`` or ``ReplicaRouter``) and run it
    until every request is resolved; ``groups`` (optional) names each
    request's lane, ``frames`` (the encoder-decoder's) each request's
    frames.  Returns (results, seconds, tokens, iterations): one
    dict per request in submission order with its status, output, steps,
    latency and time to first token (host clock, seconds from submission;
    None where it never produced one)."""
    dev = _device_of(srv)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    rids = []
    for r, (p, n) in enumerate(zip(prompts, max_news)):
        kw = dict(max_new=int(n), temperature=temperature, top_p=top_p)
        if groups is not None:
            kw["group"] = groups[r]
        if frames is not None:
            kw["extra_embeds"] = frames[r]
        rids.append(srv.submit(p, **kw))
    iterations = srv.run()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    seconds = max(time.perf_counter() - t0, 1e-9)
    results = []
    for r, (rid, p, n) in enumerate(zip(rids, prompts, max_news)):
        req = srv.result(rid)
        done = req is not None and req.status == "done"
        results.append({
            "rid": r, "prompt_len": len(p), "max_new": int(n),
            "status": "lost" if req is None else req.status,
            "output": np.asarray(req.output if req is not None else [],
                                 np.int32),
            "steps": 0 if req is None else req.steps,
            "preemptions": 0 if req is None else req.preemptions,
            "latency_s": (req.finished_s - req.submitted_at) if done
            and req.finished_s is not None else None,
            "ttft_s": (req.first_token_s - req.submitted_at) if done
            and req.first_token_s is not None else None})
    tokens = sum(len(r["output"]) for r in results if r["status"] == "done")
    return results, seconds, tokens, iterations


def launcher_prompts(cfg, args):
    """The run's prompts: ``--requests`` seeded prompts, each after one of
    4 seeded bases of ``--shared-prefix`` tokens when asked (two pages
    with ``--replicas`` by default)."""
    prompts = make_prompts(cfg.vocab_size, args.requests, args.seed,
                           args.min_prompt, args.max_prompt)
    L = args.shared_prefix
    if L < 0:
        L = 2 * args.page_size if args.replicas else 0
    if L:
        rng = np.random.default_rng(args.seed + 3)
        bases = [rng.integers(0, cfg.vocab_size, size=L).astype(np.int32)
                 for _ in range(4)]
        prompts = [np.concatenate([bases[r % 4], p])
                   for r, p in enumerate(prompts)]
    return prompts


def _mesh_shape(args):
    """(data, model) from ``--mesh-shape DATAxMODEL`` (default 1x--tp)."""
    if not args.mesh_shape:
        return 1, args.tp
    try:
        d, m = (int(x) for x in args.mesh_shape.lower().split("x"))
    except ValueError:
        raise SystemExit(f"--mesh-shape wants DATAxMODEL (e.g. '1x4'), got "
                         f"{args.mesh_shape!r}") from None
    if m != args.tp:
        raise SystemExit(f"--mesh-shape model dim {m} != --tp {args.tp}")
    return d, m


def _tp_rank(rank, world, dev, cfg, argd, shape):
    """One rank of ``serve_tp``: the global weights from ``--seed`` on the
    rank's device, its slices kept and the rest freed, then the static
    batches through the sharded engine, its collectives metered."""
    import gc

    from repro_torch.distributed import collectives as C
    from repro_torch.distributed import tp as TP
    from repro_torch.kernels import cache_update as CU
    from repro_torch.kernels.tree_attention import flash_decode
    args = argparse.Namespace(**argd)
    data, tp = shape
    mesh = TP.make_tp_group(tp, data=data)
    tpe = TP.build_tp_engine(
        cfg, mesh, args.proposer, gamma=args.gamma, use_kernel=True,
        device=dev, accept=args.accept,
        sampling=SamplingParams(temperature=args.temperature,
                                top_p=args.top_p), seed=args.seed)
    if args.proposer == "medusa":
        params, mp = build_model(cfg, args.seed, tpe.dtree.K, dev)
    else:
        params, mp = get_model(cfg).init_params(
            torch.Generator(device=dev).manual_seed(args.seed), cfg,
            dtype=cfg.dtype), None
    sp = tpe.shard_params(params)
    del params
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    prompts = launcher_prompts(cfg, args)
    # the kernels on the TP path: K1 and the commit (K4 dense, K5 paged)
    kernels = {"K1": flash_decode, "K4": CU.commit_rows_stacked,
               "K5": CU.commit_rows_paged_stacked}
    before = {k: f.launches for k, f in kernels.items()}
    with C.metered() as meter:
        results, seconds, tokens, _ = serve_static(
            tpe, sp, mp, prompts, args.slots, args.max_new, args.max_len)
    count, ms = meter.total()
    launches = {k: f.launches - before[k] for k, f in kernels.items()}
    out = {"rank": rank, "coords": (mesh.data_index, mesh.model_index),
           "results": results, "seconds": seconds, "tokens": tokens,
           "steps": tpe.steps, "collectives": count, "collective_ms": ms,
           "by_op": dict(meter.count), "device": str(dev),
           "launches": launches,
           "peak_bytes": (torch.cuda.max_memory_allocated(dev)
                          if dev.type == "cuda" else 0)}
    if args.profile_steps:
        from repro_torch.launch.trace import tp_profile
        out["profile"] = tp_profile(tpe, sp, mp, prompts[:args.slots],
                                    args.profile_steps, args.max_len)
    return out


def serve_tp(args) -> ServedTP:
    """``--tp``: static batches through the tensor-parallel engine on
    ``data x tp`` ranks (``--mesh-shape``), one process a rank started by
    ``collectives.spawn`` over ``--tp-backend`` (nccl: a card a rank;
    gloo: ranks on the CPU or sharing cards).  Each data row serves every
    request, as the reference's replicated specs do; every rank's answers
    must equal rank 0's."""
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed import tp as TP
    if args.families or args.replicas:
        raise SystemExit("--tp serves static batches through the sharded "
                         "engine; it does not combine with --families or "
                         "--replicas")
    if (args.prefix_cache or args.chunk_size or args.preemption
            or args.adaptive_gamma or args.n_blocks
            or args.admission != "batched"):
        raise SystemExit("--tp serves static batches; the scheduler's flags "
                         "need the server")
    if args.deferred:
        raise SystemExit("--tp runs the write-then-attend step; --deferred "
                         "is single-device")
    data, tp = _mesh_shape(args)
    cfg = get_config(args.arch, reduced=args.reduced)
    cfg = dataclasses.replace(cfg, cache_dtype=args.cache_dtype,
                              cache_layout=args.cache_layout,
                              page_size=args.page_size)
    try:
        TP._validate(dataclasses.replace(
            cfg, verify_fusion=args.verify_fusion), args.proposer, tp)
        C.check_backend(args.tp_backend, data * tp, args.device)
    except ValueError as e:
        raise SystemExit(f"--tp: {e}") from None
    threads = (max(1, (os.cpu_count() or 1) // (data * tp))
               if args.device == "cpu" else 0)
    ranks = C.spawn(_tp_rank, data * tp, backend=args.tp_backend,
                    device=args.device, threads=threads,
                    args=(cfg, vars(args), (data, tp)))
    head = ranks[0]
    for r in ranks[1:]:
        for a, b in zip(head["results"], r["results"]):
            if not np.array_equal(a["output"], b["output"]):
                raise SystemExit(f"rank {r['rank']} answered request "
                                 f"{a['rid']} unlike rank 0")
    for r in head["results"]:
        tps = len(r["output"]) / max(r["steps"], 1)
        print(f"  req {r['rid']}: {r['status']} prompt={r['prompt_len']} "
              f"steps={r['steps']} tokens/step={tps:.2f}")
    where = ("CPU" if args.device == "cpu"
             else torch.cuda.get_device_name(0))
    seconds, tokens = head["seconds"], head["tokens"]
    print(f"tp={tp} mesh=({data}x{tp}) proposer={args.proposer}: "
          f"{len(head['results'])} requests, {tokens} tokens in "
          f"{seconds:.3f}s ({tokens / seconds:.1f} tok/s across "
          f"{data * tp} ranks on {where}); backend {args.tp_backend}")
    for r in ranks:
        steps = max(r["steps"], 1)
        print(f"  rank {r['rank']} {r['coords']} on {r['device']}: "
              f"{r['seconds'] * 1e3 / steps:.3f} ms a step, "
              f"{r['collectives'] / steps:.1f} collectives "
              f"({r['collective_ms'] / steps:.3f} ms) a step, peak "
              f"{r['peak_bytes'] / 2 ** 30:.2f} GiB, launches "
              f"{r['launches']}")
        if "profile" in r:
            from repro_torch.launch.trace import tp_lines
            for line in tp_lines(r["profile"]):
                print(f"    {line}")
    return ServedTP(cfg, launcher_prompts(cfg, args), head["results"],
                    seconds, tokens, ranks, args.tp_backend, (data, tp))


def _lanes(srv) -> List[SpecServer]:
    """The ``SpecServer``s behind a server, a family façade or a router."""
    if isinstance(srv, FamilySpecServer):
        return list(srv.groups.values())
    if isinstance(srv, ReplicaRouter):
        return list(srv.replicas.values())
    return [srv]


def _device_of(srv) -> torch.device:
    return _lanes(srv)[0].device


def main(argv=None, weights=None) -> Served:
    """Run the launcher on ``argv``.  ``weights``, if given, is a
    (params, proposer_params) pair for the configuration and proposer
    ``argv`` names, served in place of the random weights drawn from
    ``--seed`` (so one set of weights can be served under two settings
    without building the model twice; with ``--families`` it gives the
    backbone and the lane of ``--proposer``)."""
    ap = argparse.ArgumentParser(
        prog="repro_torch.launch.serve",
        description="continuous-batching (or --static) speculative serving "
                    "on the PyTorch port")
    ap.add_argument("--arch", default="openpangu-7b", choices=ALL_ARCHS)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4,
                    help="decode slots (--static: requests per batch)")
    ap.add_argument("--max-new", type=int, default=64)
    ap.add_argument("--min-new", type=int, default=0,
                    help="draw each request's max_new from "
                         "[min-new, max-new]; 0 = every request max-new")
    ap.add_argument("--max-len", type=int, default=2048,
                    help="cache rows per slot")
    ap.add_argument("--min-prompt", type=int, default=4,
                    help="shortest prompt length drawn")
    ap.add_argument("--max-prompt", type=int, default=48,
                    help="prompt lengths are drawn below this")
    ap.add_argument("--shared-prefix", type=int, default=-1,
                    help="prefix every prompt with one of 4 seeded bases "
                         "of this many tokens (-1: two pages with "
                         "--replicas, else none)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds the prompts, the random weights and the "
                         "sampling draws")
    ap.add_argument("--reduced", action="store_true",
                    help="the reference's reduced CPU-test config")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--static", action="store_true",
                    help="static batches through SpecEngine.generate "
                         "instead of the continuous-batching server")
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
    ap.add_argument("--n-blocks", type=int, default=0,
                    help="paged layout: physical pool blocks (trash block "
                         "included); 0 = every slot's worst case")
    ap.add_argument("--admission", default="batched",
                    choices=("batched", "serial"),
                    help="bucketed group prefill (default) or one prefill "
                         "per request")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="reuse shared prompt-prefix blocks across requests "
                         "(requires --cache-layout paged)")
    ap.add_argument("--chunk-size", type=int, default=0,
                    help="chunked prefill: admit long prompts in pieces of "
                         "this many tokens beside decode steps; 0 = "
                         "whole-prompt prefill")
    ap.add_argument("--preemption", action="store_true",
                    help="optimistic block allocation with preempt-and-"
                         "requeue on pool exhaustion (requires "
                         "--cache-layout paged)")
    ap.add_argument("--adaptive-gamma", action="store_true",
                    help="adapt the speculation depth each step from the "
                         "acceptance EMA, among captured step graphs")
    ap.add_argument("--families", default="",
                    help="comma-separated proposer kinds (e.g. "
                         "'medusa,ngram,draft'): one FamilySpecServer with "
                         "a lane per kind, requests round-robin across "
                         "lanes; --proposer names the lane --weights "
                         "feeds")
    ap.add_argument("--replicas", type=int, default=0,
                    help="a prefix-affinity ReplicaRouter over this many "
                         "server replicas; 0 = one server")
    ap.add_argument("--accept", default="greedy", choices=("greedy", "sample"),
                    help="verification mode: greedy argmax match or lossless "
                         "stochastic rejection sampling")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature (accept=sample; 0 is exact "
                         "greedy)")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="nucleus truncation (accept=sample; 1.0 with "
                         "--verify-fusion)")
    ap.add_argument("--deferred", action="store_true",
                    help="skip the per-step tree-row cache write (commit "
                         "is the only write)")
    ap.add_argument("--proposer", default="medusa",
                    choices=("medusa", "draft", "ngram"),
                    help="draft policy: trained Medusa heads, a 2-layer "
                         "draft-model sibling, or train-free n-gram prompt "
                         "lookup")
    ap.add_argument("--gamma", type=int, default=4,
                    help="chain length for the draft/ngram proposers "
                         "(medusa uses its static tree)")
    ap.add_argument("--tp", type=int, default=0,
                    help="tensor-parallel decode on this many ranks, one "
                         "process each: heads, ffn, vocab and the KV cache "
                         "shard; static batches only; 0 = one device")
    ap.add_argument("--mesh-shape", default="",
                    help="DATAxMODEL grid of ranks for --tp (e.g. '2x2'); "
                         "each data row serves every request; default "
                         "'1x<tp>'")
    ap.add_argument("--tp-backend", default="nccl", choices=("nccl", "gloo"),
                    help="--tp's collectives: nccl (one card a rank) or "
                         "gloo (ranks on the CPU, or sharing cards)")
    ap.add_argument("--profile-steps", type=int, default=0,
                    help="--tp: after serving, trace this many more eager "
                         "spec steps on every rank (launch/trace.py's "
                         "tp_profile)")
    args = ap.parse_args(argv)

    kinds = [k.strip() for k in args.families.split(",") if k.strip()]
    server_only = (kinds or args.replicas or args.prefix_cache
                   or args.chunk_size or args.preemption
                   or args.adaptive_gamma or args.n_blocks
                   or args.admission != "batched")
    if args.static and server_only:
        raise SystemExit("--static serves static batches; the scheduler's "
                         "flags need the server")
    if args.replicas and kinds:
        raise SystemExit("--replicas routes across single-proposer "
                         "replicas; it does not combine with --families")
    for k in kinds:
        if k not in ("medusa", "draft", "ngram"):
            raise SystemExit(f"--families: unknown proposer {k!r}")
    if args.tp:
        return serve_tp(args)
    if args.mesh_shape or args.profile_steps:
        raise SystemExit("--mesh-shape and --profile-steps go with --tp")

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=args.reduced)
    if args.cache_dtype or args.cache_layout != "dense":
        cfg = dataclasses.replace(cfg, cache_dtype=args.cache_dtype,
                                  cache_layout=args.cache_layout,
                                  page_size=args.page_size)

    def engine_for(kind):
        return build_engine(
            cfg, kind, gamma=args.gamma, use_kernel=True, device=dev,
            accept=args.accept,
            sampling=SamplingParams(temperature=args.temperature,
                                    top_p=args.top_p),
            verify_fusion=args.verify_fusion, seed=args.seed,
            deferred=args.deferred)

    # one engine per proposer the run serves (``--proposer`` first), and
    # its weights: the backbone's draws are build_model's first, so every
    # proposer serves the same target
    engines = {k: engine_for(k)
               for k in dict.fromkeys([args.proposer] + kinds)}
    engine = engines[args.proposer]
    pps = {}
    if weights is not None:
        params, pps[args.proposer] = weights
        if "lm_head" in params:
            # weights made elsewhere: the head at the verify kernel's pitch
            params = dict(params, lm_head=pitch_lm_head(params["lm_head"]))
    elif "medusa" in engines:
        params, pps["medusa"] = build_model(cfg, args.seed,
                                            engines["medusa"].dtree.K, dev)
    else:
        params = get_model(cfg).init_params(
            torch.Generator(device=dev).manual_seed(args.seed), cfg,
            dtype=cfg.dtype)
    for k, e in engines.items():
        if k not in pps:
            pps[k] = (build_model(cfg, args.seed, e.dtree.K, dev)[1]
                      if k == "medusa" else proposer_params(e, args.seed))
    mp = pps[args.proposer]
    prompts = launcher_prompts(cfg, args)
    frames = request_frames(cfg, len(prompts), args.seed + 7, dev)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "CPU"

    if args.static:
        results, seconds, tokens, capture_s = serve_static(
            engine, params, mp, prompts, args.slots, args.max_new,
            args.max_len, frames)
        for r in results:
            tps = len(r["output"]) / max(r["steps"], 1)
            print(f"  req {r['rid']}: {r['status']} "
                  f"prompt={r['prompt_len']} steps={r['steps']} "
                  f"tokens/step={tps:.2f}")
        # every answered request's tokens over its steps (its group's)
        steps = sum(r["steps"] for r in results if r["status"] == "done")
        print(f"{_describe(cfg, engine, args)}: {len(results)} requests, "
              f"{tokens} tokens in {seconds:.3f}s ({tokens / seconds:.1f} "
              f"tok/s on {where}; {capture_s:.3f}s of it capturing the step "
              f"graph); {args.proposer} proposer: "
              f"{tokens / max(steps, 1):.2f} tokens a step")
        return Served(engine.cfg, engine, params, mp, prompts, results,
                      seconds, tokens, capture_s, frames=frames)

    sched = SchedulerParams(chunk_size=args.chunk_size,
                            preemption=args.preemption,
                            adaptive_gamma=args.adaptive_gamma)
    n_blocks = args.n_blocks or None

    def make_server(kind):
        return SpecServer(engines[kind], params, pps[kind],
                          batch_slots=args.slots, max_len=args.max_len,
                          admission=args.admission, n_blocks=n_blocks,
                          prefix_cache=args.prefix_cache, sched=sched)

    if args.replicas:
        srv = ReplicaRouter({f"r{i}": make_server(args.proposer)
                             for i in range(args.replicas)},
                            page_size=args.page_size)
    elif kinds:
        srv = FamilySpecServer({k: make_server(k) for k in kinds})
    else:
        srv = make_server(args.proposer)
    rng = np.random.default_rng(args.seed + 5)
    lo = args.min_new or args.max_new
    max_news = [int(rng.integers(lo, args.max_new + 1)) for _ in prompts]
    groups = [kinds[r % len(kinds)] for r in range(len(prompts))] \
        if kinds else None
    capture0 = sum(e.step_graphs.capture_s for e in engines.values())
    results, seconds, tokens, iterations = serve_requests(
        srv, prompts, max_news, args.temperature, args.top_p, groups, frames)
    capture_s = sum(e.step_graphs.capture_s
                    for e in engines.values()) - capture0
    for r in results:
        tps = len(r["output"]) / max(r["steps"], 1)
        print(f"  req {r['rid']}: {r['status']} prompt={r['prompt_len']} "
              f"max_new={r['max_new']} steps={r['steps']} "
              f"tokens/step={tps:.2f}")
    print(f"{_describe(cfg, engine, args)}: {len(results)} requests, "
          f"{tokens} tokens in {seconds:.3f}s ({tokens / seconds:.1f} tok/s "
          f"on {where}; {capture_s:.3f}s of it capturing step graphs); "
          f"{iterations} scheduler iterations")
    for lane in _lanes(srv):
        st = lane.stats
        gs = ", ".join(f"gamma{g}={n}" for g, n in
                       sorted(st["gamma_steps"].items()))
        line = (f"  {type(lane.engine.proposer).__name__}: "
                f"{st['admitted']} admissions in {st['prefill_calls']} "
                f"prefill calls, {st['steps']} decode steps ({gs}), "
                f"{st['chunk_calls']} chunk calls")
        if lane.paged:
            line += (f"; paged: peak {st['peak_blocks']}/"
                     f"{lane.n_blocks - 1} blocks, {st['deferred']} "
                     f"deferred, {st['cached_tokens']} prompt tokens from "
                     f"the prefix cache ({st['cow_copies']} CoW copies), "
                     f"{st['preemptions']} preemptions "
                     f"({st['resumed']} resumed), {st['grown_blocks']} "
                     f"blocks grown, {st['reclaimed_blocks']} reclaimed")
        print(line)
    if args.replicas:
        snap = srv.snapshot()
        total = snap["affinity_hits"] + snap["affinity_misses"]
        print(f"router: {snap['affinity_hits']}/{total} affinity hits, "
              f"{snap['rebalances']} rebalances, {snap['requeues']} "
              f"requeues; routed "
              + ", ".join(f"{n}={c}" for n, c in snap["routed"].items()))
    failed = [r["rid"] for r in results if r["status"] == "failed"]
    if failed:
        why = [f for lane in _lanes(srv) for f in lane.failures]
        raise SystemExit(f"requests {failed} failed (refused at admission "
                         f"as too long for the cache or the pool, or out of "
                         f"retries); the step failures recovered from: "
                         f"{why}")
    return Served(engine.cfg, engine, params, mp, prompts, results, seconds,
                  tokens, capture_s, srv, iterations, frames)


def _describe(cfg, engine, args) -> str:
    """The configuration's one-line name for the summary."""
    fused = "" if args.proposer == "medusa" else \
        f", {args.proposer} proposer (gamma {args.gamma})"
    fused += " with verify fusion" if engine.cfg.verify_fusion else ""
    if engine.deferred:
        fused += ", deferred write"
    if engine.accept == "sample":
        fused += (f", sampled at temperature {args.temperature} top-p "
                  f"{args.top_p}")
    layout = ""
    if cfg.resolved_cache_dtype == "int8" or cfg.paged:
        layout = (f" ({cfg.resolved_cache_dtype} {cfg.cache_layout} cache"
                  + (f", page size {cfg.page_size}" if cfg.paged else "")
                  + ")")
    return f"{cfg.name}{fused}{layout}"


if __name__ == "__main__":
    main()
