"""The import guard: every module a run of the benchmark loads, and every
module the references load, compared by its whole top-level name.  A run
(the command's module, the harness serving a reduced cell on the CPU,
every metric reader, the correctness check) loads neither JAX nor the
JAX package ``repro``; the references load nothing of the port
(``repro_torch``) either."""
import json
import subprocess
import sys

from perfbench.tests.conftest import ROOT

JAX = {"jax", "jaxlib", "flax", "repro"}

RUN = r"""
import importlib.util, json, sys, time
sys.path[:0] = [{root!r}, {src!r}]
spec = importlib.util.spec_from_file_location("bench_run", {run!r})
run_mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(run_mod)
from perfbench import calibrate, correctness, harness, tracing
from perfbench.tests.conftest import reduced, small_mix
bench = run_mod.load_benchmark()
for name, cell in (("openpangu-7b", "pangu7b-chat"),
                   ("mamba2-2.7b", "mamba2-chat")):
    r, w = harness.run_cell(cell, reduced(name), small_mix(), 5, 1.0,
                            False, "cpu", time.monotonic())
    run_mod.read_metrics(r, bench["end_to_end"] + bench["per_layer"])
    correctness.check(r, w, correctness.load_limits(cell))
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REFERENCE = r"""
import json, sys
sys.path[:0] = [{root!r}]
from perfbench.families import family
from perfbench.reference import forward
from perfbench.tests.conftest import reduced
for name in ("openpangu-7b", "mamba2-2.7b"):
    cfg = reduced(name)
    w = family(cfg["family"]).draw(cfg, 3, "cpu")
    for p in ("f32", "fp8"):
        forward(cfg["family"])(w, cfg, [[1, 2, 3, 4]], [(0, 4)], p)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def loaded(code: str) -> set:
    src = code.format(root=str(ROOT), src=str(ROOT / "src"),
                      run=str(ROOT / "perfbench" / "run.py"))
    p = subprocess.run([sys.executable, "-c", src], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    return set(json.loads(p.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    names = loaded(RUN)
    assert "repro_torch" in names and "perfbench" in names
    assert not names & JAX, names & JAX


def test_the_references_load_nothing_of_the_port():
    names = loaded(REFERENCE)
    assert "perfbench" in names and "torch" in names
    assert not names & (JAX | {"repro_torch"}), names & (JAX | {"repro_torch"})
