"""The harness's run on the CPU, through its internal functions, on the
reduced configurations: the closed loop serves, the readers read, and
the check against the reference passes; the command itself refuses to
run without a card."""
import json
import subprocess
import sys
import time

import pytest

from perfbench import correctness, harness
from perfbench.tests.conftest import ROOT, reduced, small_mix

CELLS = {"openpangu-7b": "pangu7b-chat", "mamba2-2.7b": "mamba2-chat"}


def serve(name, seed=2**31 + 11, seconds=2.0):
    return harness.run_cell(CELLS[name], reduced(name), small_mix(), seed,
                            seconds, False, "cpu", time.monotonic())


@pytest.mark.parametrize("name", sorted(CELLS))
def test_closed_loop_serves_and_checks(name):
    run, w = serve(name)
    mix = small_mix()
    done = run.completed()
    assert len(done) >= mix["clients"]
    assert run.delivered > 0 and run.window_s >= 2.0
    # every request sent in the window was answered, in full
    assert all(s.done for s in run.attempted())
    assert all(len(s.req.output) == s.req.max_new for s in run.sent
               if s.done)
    # the clients never had more than one request each in flight
    for c in range(mix["clients"]):
        mine = [s for s in run.sent if s.client == c]
        assert all(a.end_s <= b.sent_s for a, b in zip(mine, mine[1:]))
    # every step was recorded with its active slots
    assert run.steps and all(0 < len(ctx) <= mix["clients"]
                             for _, ctx in run.steps)
    assert sum(len(g) for _, gs in run.prefills for g in gs) >= len(done)
    ok, checks = correctness.check(run, w, {"max_gap": 1e-3})
    assert ok, checks
    # float32 on the CPU serves the reference's argmax
    assert checks["max_gap"]["value"] < 1e-4


def test_readers_report_each_cell_metric():
    spec = __import__("importlib.util").util.spec_from_file_location(
        "bench_run", ROOT / "perfbench" / "run.py")
    mod = __import__("importlib.util").util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    bench = mod.load_benchmark()
    run, _ = serve("openpangu-7b")
    got = mod.read_metrics(run, mod.cell_metrics(bench, "pangu7b-chat",
                                                 False))
    assert set(got) == {"output_tok_s", "tpot_p95_ms", "setup_s"}
    assert all(v["value"] > 0 for v in got.values())
    # the per-layer readers that need no card read on the CPU too
    got = mod.read_metrics(run, mod.cell_metrics(bench, "pangu7b-chat",
                                                 True))
    assert {"sched_host_ms", "accept_len"} <= set(got)
    assert got["accept_len"]["value"] >= 1.0


@pytest.mark.parametrize("name,key,value", [
    ("openpangu-7b", "tree", "cartesian"),
    ("openpangu-7b", "tree", "chain"),
    ("mamba2-2.7b", "tree", "medusa_63"),
    ("openpangu-7b", "loop", "open"),
])
def test_unsupported_settings_fail_the_run(name, key, value):
    cfg, mix = reduced(name), small_mix()
    if key == "loop":
        mix["loop"] = value
    else:
        cfg["serving"] = dict(cfg["serving"], **{key: value})
    with pytest.raises(ValueError, match=key):
        harness.run_cell(CELLS[name], cfg, mix, 5, 1.0, False, "cpu",
                         time.monotonic())


def test_command_refuses_without_a_card():
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        "pangu7b-chat", "--seed", "5", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_benchmark_file_names_existing_files():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        assert (ROOT / c["file"]).is_file()
    for w in bench["workloads"]:
        assert (ROOT / "perfbench" / "traffic"
                / f"{w['traffic']}.json").is_file()
        assert (ROOT / "perfbench" / "limits" / f"{w['name']}.json").is_file()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert (ROOT / "perfbench" / "metrics" / f"{m['name']}.py").is_file()
