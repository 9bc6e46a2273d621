"""Dry-run planner (counterpart of ``repro.launch.dryrun``): trace every
(architecture x input shape) cell on a mesh with fake tensors, and record
each device's argument bytes, its FLOPs, the bytes its ops move, the peak
of its intermediate storage and its collectives, without a card and
without allocating the model.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch openpangu-7b --shape decode_32k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod | --both-meshes] [--delta]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out results/dryrun.jsonl

What is traced.  The port cannot reproduce GSPMD, so a record says which
program it traced (``program``) and whether its FLOPs, temp bytes and
bytes accessed are one device's (``per_device``):

  * "tp": dense decode and prefill, where ``TPSpecEngine`` accepts the
    mesh's ``model`` size (``tp._validate``): rank 0's program at its
    own shapes (heads / ff / vocab cut over ``model``, the batch over
    the DP axes).  Per device.
  * "dp": training with its gradient all-reduce over the DP axes
    (``steps.all_reduce_grads``), rank 0's rows of the batch, the
    parameters whole (the port has no tensor-parallel training: the
    ``model`` axis repeats the work).  Per device.
  * "single": a one-device mesh.  Per device.
  * "global": everything else, the whole program on one fake device;
    ``per_device`` is false and ``collectives`` null.  Nothing is
    divided to guess a device's share.

Every program runs the plain path (``use_kernel=False``): the hand-written
kernels take device pointers, which a fake tensor does not have (their
wrappers raise on one).

The record keeps the reference's keys; each is obtained so:

  * ``mem.argument_bytes``: per device, exact: every argument leaf's
    bytes divided by the mesh sizes its spec shards it over (the
    reference's placement, ``launch/specs.py::build_cell``).
  * ``mem.alias_bytes``: the same sum over the donated arguments that
    the program returns (written in place).
  * ``mem.output_bytes``: ``alias_bytes`` plus the other outputs' bytes:
    the traced program's own tensors, cut over the DP axes along a
    leading batch dimension when the program is global.
  * ``mem.temp_bytes``: the peak of live storage the traced ops created
    (``StorageTracker``: a storage's bytes count from the op that made it
    until it dies; views and in-place ops allocate nothing).
  * ``mem.peak_bytes``: the traced program's argument bytes plus temp
    (``mem.program_argument_bytes``: the rank's own tensors for a per
    device program, the global ones otherwise).
  * ``flops_per_device``: ``torch.utils.flop_counter.FlopCounterMode``.
  * ``bytes_accessed_per_device``: the sum of every traced op's operand
    and result bytes (view ops excluded): the eager program's traffic,
    with no fusion.
  * ``collectives``: ``{kind: {count, bytes, bytes_body}}`` from the
    planning axes' meter (``collectives.metered``), bytes the results'
    as the reference counts them; ``bytes_body`` is 0 since the trace
    unrolls every unit, so nothing is counted once for many trips.
  * ``trace_s``: building the cell plus the trace (the reference's
    ``lower_s`` and ``compile_s``).

Planner numbers are counts of bytes and operations, not times.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig
from repro_torch.configs.registry import get_config, iter_cells
from repro_torch.distributed import collectives as C
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch import specs as SP

# the meter's op names -> the reference's HLO kinds
KINDS = {"psum": "all-reduce", "pmax": "all-reduce",
         "all_gather": "all-gather", "ppermute": "collective-permute"}


class StorageTracker(TorchDispatchMode):
    """Counts, over the ops dispatched inside it: the bytes of every new
    storage an op creates while it lives (``current``, its ``peak``), and
    the bytes every op that returns a tensor reads and writes, views
    excepted (``accessed``).  A storage is new
    when no operand of the op shares it and it is not tracked yet, so a
    view, an in-place op and an ``out=`` op allocate nothing."""

    def __init__(self):
        super().__init__()
        self.live = {}
        self.current = 0
        self.peak = 0
        self.accessed = 0

    def _free(self, key):
        self.current -= self.live.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = [t for t in tree_flatten((args, kwargs))[0]
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        if outs and not func.is_view:      # metadata queries move nothing
            self.accessed += sum(t.nbytes for t in ins + outs)
        seen = {t.untyped_storage()._cdata for t in ins}
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in seen or key in self.live:
                continue
            seen.add(key)
            self.live[key] = st.nbytes()
            self.current += self.live[key]
            weakref.finalize(st, self._free, key)
        self.peak = max(self.peak, self.current)
        return out


def leaves(tree) -> list:
    """The tensors of nested dicts, lists and tuples."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def _pairs(args, specs):
    """(tensor, spec) for every argument leaf (``specs``: the same
    nesting, spec tuples at the tensors)."""
    if isinstance(args, torch.Tensor):
        return [(args, specs)]
    if isinstance(args, dict):
        return [p for k in args for p in _pairs(args[k], specs[k])]
    return [p for a, s in zip(args, specs) for p in _pairs(a, s)]


def shard_bytes(t, spec, mesh) -> int:
    """Bytes of one device's piece of ``t`` placed by ``spec``."""
    n = t.nbytes
    for ax in spec:
        if ax is not None:
            n //= math.prod(mesh.shape[a]
                            for a in (ax if isinstance(ax, tuple) else (ax,)))
    return n


def argument_bytes(cell, mesh, argnums=None) -> int:
    """Per-device bytes of the cell's arguments (``argnums``: only
    those)."""
    total = 0
    for i, (a, s) in enumerate(zip(cell.args, cell.in_shardings)):
        if argnums is None or i in argnums:
            total += sum(shard_bytes(t, sp, mesh) for t, sp in _pairs(a, s))
    return total


def _storage_keys(tree) -> set:
    return {t.untyped_storage()._cdata for t in leaves(tree)}


def _collectives(meter) -> dict:
    out = {}
    for op, n in meter.count.items():
        e = out.setdefault(KINDS[op], {"count": 0, "bytes": 0,
                                       "bytes_body": 0})
        e["count"] += n
        e["bytes"] += meter.bytes[op]
    return out


def plan(cfg: ModelConfig, shape: ShapeConfig, mesh, multi_pod: bool, *,
         optimized: bool = False, rank: int = 0) -> dict:
    """Trace one cell on ``mesh`` (device ``rank``'s program, where the
    port has a sharded one) and return its record without the naming
    keys (see the module's docstring)."""
    t0 = time.time()
    with C.planning():
        cell = SP.build_cell(cfg, shape, mesh, multi_pod, optimized=optimized)
        program = SP.rank_program(cfg, shape, mesh, multi_pod) or "global"
        run = cell if program == "global" else SP.rank_cell(
            cfg, shape, mesh, multi_pod, optimized=optimized,
            program=program, rank=rank)
        per_device = program != "global"
        mode = SP._mode_of(run.args)
        tracker = StorageTracker()
        flops = FlopCounterMode(display=False)
        with mode, C.metered() as meter:
            arg_keys = _storage_keys(run.args)
            with flops, tracker:
                out = run.fn(*run.args)
            out_leaves = leaves(out)
            B = shape.global_batch
            dp = SP.batch_ranks(mesh, multi_pod)
            other = 0
            for t in out_leaves:
                if t.untyped_storage()._cdata in arg_keys:
                    continue
                n = t.nbytes
                if not per_device and t.dim() and t.shape[0] == B \
                        and B % dp == 0:
                    n //= dp
                other += n
            returned = {t.untyped_storage()._cdata for t in out_leaves}
            alias_args = tuple(i for i in run.donate
                               if _storage_keys(run.args[i]) & returned)
            del out, out_leaves
    # the donated arguments, placed as the reference's cell places them
    alias = argument_bytes(cell, mesh, alias_args)
    args = argument_bytes(cell, mesh)
    prog_args = sum(t.nbytes for t in leaves(run.args))
    return {
        "devices": math.prod(mesh.shape.values()),
        "mesh": dict(mesh.shape),
        "program": program, "per_device": per_device, "path": "plain",
        "trace_s": round(time.time() - t0, 2),
        "flops_per_device": float(flops.get_total_flops()),
        "bytes_accessed_per_device": float(tracker.accessed),
        "mem": {
            "argument_bytes": args,
            "output_bytes": alias + other,
            "temp_bytes": tracker.peak,
            "peak_bytes": prog_args + tracker.peak,
            "alias_bytes": alias,
            "program_argument_bytes": prog_args,
        },
        "collectives": _collectives(meter) if per_device else None,
        "meta": cell.meta if run is cell else dict(cell.meta, **run.meta),
    }


def run_cell(arch: str, shape_name: str, multi_pod: bool, *, n_units=None,
             optimized=False, verbose=True):
    cfg = get_config(arch)
    if n_units is not None:
        cfg = SP.with_num_units(cfg, n_units)
    shape = SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod)
    rec = {"arch": arch, "shape": shape_name, "kind": shape.kind,
           "multi_pod": multi_pod, "n_units": n_units,
           "optimized": optimized}
    rec.update(plan(cfg, shape, mesh, multi_pod, optimized=optimized))
    if verbose:
        print(summary(rec), flush=True)
    return rec


def summary(rec: dict) -> str:
    mem = rec["mem"]
    colls = rec["collectives"]
    cb = ("n/a" if colls is None else
          f"{sum(c['bytes'] for c in colls.values()) / 2**20:.1f}MiB")
    return (f"  OK {rec['arch']} x {rec['shape']} (multi_pod="
            f"{rec['multi_pod']}, nu={rec['n_units']}): trace "
            f"{rec['trace_s']:.1f}s {rec['program']} per_device="
            f"{rec['per_device']} args {mem['argument_bytes'] / 2**30:.2f}GiB"
            f" temp {mem['temp_bytes'] / 2**30:.2f}GiB flops "
            f"{rec['flops_per_device']:.3g} colls {cb}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--optimized", action="store_true",
                    help="beyond-paper optimized decode variant (deferred write)")
    ap.add_argument("--delta", action="store_true",
                    help="also trace at 1 and 2 stacked units for per-layer "
                         "costing (single-pod only)")
    ap.add_argument("--out", default=None, help="append JSONL to this path")
    args = ap.parse_args(argv)

    cells = []
    if args.all:
        for arch, shape, ok, why in iter_cells(include_skipped=True):
            if ok:
                cells.append((arch, shape))
            else:
                print(f"  SKIP {arch} x {shape}: {why}", flush=True)
    else:
        if args.arch is None or args.shape is None:
            ap.error("pass --arch and --shape, or --all")
        cells.append((args.arch, args.shape))

    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    records, failures = [], []
    for arch, shape_name in cells:
        for mp in meshes:
            try:
                records.append(run_cell(arch, shape_name, mp,
                                        optimized=args.optimized))
                if args.delta and not mp:
                    for nu in (1, 2):
                        records.append(run_cell(arch, shape_name, mp,
                                                n_units=nu,
                                                optimized=args.optimized))
            except Exception as e:  # report every failing cell, then exit 1
                traceback.print_exc()
                failures.append((arch, shape_name, mp, repr(e)))
                print(f"  FAIL {arch} x {shape_name} multi_pod={mp}: {e}",
                      flush=True)

    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "a") as f:
            for r in records:
                f.write(json.dumps(r) + "\n")
    else:
        for r in records:
            print(json.dumps(r), flush=True)
    print(f"\n{len(records)} traces OK, {len(failures)} failures")
    for f_ in failures:
        print("  FAILED:", f_)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
