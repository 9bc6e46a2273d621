"""On the card, at each cell's own size: a short run at the cell's load,
whose served tokens pass the cell's limit while the control (the
reference in float8, in the program's place, over the same sample) fails
it.  Run there with

    python3 -m pytest -q perfbench/tests/test_cuda.py -m cuda

(a few minutes a cell: the weights, the warm-up, a 5 s window and the
reference twice)."""
import json
import time

import pytest
import torch

from perfbench import correctness, harness
from perfbench.tests.conftest import ROOT
from perfbench.traffic import load_mix

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_where_the_program_passes(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    w = {x["name"]: x for x in BENCH["workloads"]}[cell]
    cfg = json.loads((ROOT / "perfbench" / "configs"
                      / f"{w['config']}.json").read_text())
    limit = correctness.load_limits(cell)["max_gap"]
    run, weights = harness.run_cell(cell, cfg, load_mix(w["traffic"]),
                                    4000000007, 5.0, False, "cuda",
                                    time.monotonic())
    g = correctness.gaps(weights, cfg, correctness.sample(run),
                         control=True)
    assert correctness.widest(g["program"]) <= limit
    assert correctness.widest(g["control"]) > limit
