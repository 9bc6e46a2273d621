"""The readings the correctness limits are set from, on the card.

    python3 perfbench/calibrate.py --workload <cell> --seconds <s> --seeds <n> [<n> ...] [--out <file>]

For each seed, in one process (the kernels load once): a run of the cell
at its own load for ``--seconds``, then over the run's own sample the
program's widest gap and the control's (the reference in float8, in the
program's place), and the sample's size.  One JSON line a seed on
standard output and, with ``--out``, appended to that file.  The
benchmark's runs never run the control."""
import argparse
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from perfbench import run as bench_run  # noqa: E402  (caches, import path)

import torch  # noqa: E402

from perfbench import correctness, harness  # noqa: E402
from perfbench.traffic import load_mix  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    bench = bench_run.load_benchmark()
    cell = {w["name"]: w for w in bench["workloads"]}[args.workload]
    cfg = json.loads((bench_run.ROOT / "perfbench" / "configs"
                      / f"{cell['config']}.json").read_text())
    mix = load_mix(cell["traffic"])
    for seed in args.seeds:
        t0 = time.monotonic()
        run, weights = harness.run_cell(args.workload, cfg, mix, seed,
                                        args.seconds, False, "cuda", t0)
        picks = correctness.sample(run)
        t1 = time.monotonic()
        g = correctness.gaps(weights, cfg, picks, control=True)
        t2 = time.monotonic()
        rec = {"workload": args.workload, "seed": seed,
               "program": correctness.widest(g["program"]),
               "control": correctness.widest(g["control"]),
               "program_p99": float(torch.tensor(
                   [x for a in g["program"] for x in a.tolist()]
               ).quantile(0.99)) if picks else None,
               "requests": len(picks),
               "tokens": int(sum(len(a) for a in g["program"])),
               "completed": len(run.completed()),
               "setup_s": run.setup_s, "window_s": run.window_s,
               "check_s": t2 - t1}
        print(json.dumps(rec), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")
        del run, weights
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
