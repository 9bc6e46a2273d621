"""The benchmark of the PyTorch/CUDA port: one run of one cell.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout.  The cell (``BENCHMARK.json``'s
``workloads``) names a configuration (``perfbench/configs/<name>.json``)
and a traffic mix (``perfbench/traffic/<name>.json``); the metrics it
reports are ``BENCHMARK.json``'s ``end_to_end`` ones with ``--trace 0``
and its ``per_layer`` ones with ``--trace 1``, each read by
``perfbench/metrics/<name>.py``.  The last line of standard output is
the result, one JSON object; the last lines of standard error list each
number the correctness check compared beside its limit.  Without a card
(or with fewer than the cell asks for) it exits 2 and prints no result;
after any failure it exits non-zero and prints no result."""
import time

T_START = time.monotonic()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
# every build and kernel cache at a fixed path inside the checkout
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell_metrics(bench: dict, cell: str, trace: bool) -> list:
    """The metrics the cell reports in this kind of run."""
    return [m for m in bench["per_layer" if trace else "end_to_end"]
            if cell in m.get("workloads", [cell])]


def reader(name: str):
    """``perfbench/metrics/<name>.py``'s ``read``."""
    path = ROOT / "perfbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_metrics(run, metrics: list) -> dict:
    out = {}
    for m in metrics:
        value = reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, its libraries' or
    the JAX package's."""
    return sorted({n for n in sys.modules if n.split(".")[0] in FORBIDDEN})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = load_benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"unknown workload {args.workload!r}; have {sorted(cells)}",
              file=sys.stderr)
        return 2
    cell = cells[args.workload]

    import torch
    # the host's work is Python and launches: one thread, no spinning pool
    torch.set_num_threads(1)
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"{cards} visible", file=sys.stderr)
        return 2

    from perfbench import correctness, harness, tracing
    from perfbench.traffic import load_mix
    cfg = json.loads((ROOT / "perfbench" / "configs"
                      / f"{cell['config']}.json").read_text())
    mix = load_mix(cell["traffic"])
    limits = correctness.load_limits(args.workload)
    torch.cuda.reset_peak_memory_stats()
    run, weights = harness.run_cell(args.workload, cfg, mix, args.seed,
                                    args.seconds, bool(args.trace), "cuda",
                                    T_START)
    metrics = read_metrics(run, cell_metrics(bench, args.workload,
                                             bool(args.trace)))
    correct, checks = correctness.check(run, weights, limits)
    found = forbidden_modules()
    if found:
        print(f"the run loaded {found}: the benchmark and the port must not "
              "import JAX or the JAX package", file=sys.stderr)
        return 3
    result = {
        "correct": bool(correct),
        "attempted": len(run.attempted()),
        "failed": checks["failed"]["value"],
        "metrics": metrics,
        "device": {"platform": "gpu", "kind": run.device_kind, "count": 1,
                   "memory_peak_bytes": int(run.memory_peak_bytes)},
    }
    if args.trace:
        if run.profile is None:
            print("the profiler recorded no sub-window", file=sys.stderr)
            return 4
        result["device"]["busy_s"] = run.profile["busy_s"]
        result["device"]["window_s"] = run.profile["window_s"]
        result["breakdown"] = tracing.breakdown(run.profile)
    result["checks"] = checks
    print(f"# {args.workload} seed {args.seed}: "
          f"{len(run.completed())} requests completed in "
          f"{run.window_s:.3f} s, {run.delivered} tokens, "
          f"{run.timing.get('iterations')} iterations; set-up "
          + ", ".join(f"{name} {t - run.t_start:.2f}"
                      for name, t in run.marks), file=sys.stderr)
    if run.step_ms:
        busy = (sum(run.step_ms) + sum(ms for ms, _ in run.prefill_ms)) / 1e3
        print(f"# events: {len(run.step_ms)} steps of "
              f"{sum(run.step_ms) / len(run.step_ms):.3f} ms, "
              f"{len(run.prefill_ms)} prefills; step + prefill device "
              f"share of the window {busy / run.window_s:.4f}",
              file=sys.stderr)
    for name, c in checks.items():
        print(f"{name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
