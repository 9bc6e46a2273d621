"""The operations and bytes the roofline metrics count: K2's bound at
openPangu-7B is the lm head's stream (PERF.md §6's 0.3757 ms at N 256),
and a serve step's operations agree with the port's dry-run planner at
the decode shapes."""
import json

import pytest

from perfbench.families import dense, ssm
from perfbench.roofline import bound_s, peaks
from perfbench.tests.conftest import ROOT

H100 = "NVIDIA H100 80GB HBM3"


def config(name):
    return json.loads((ROOT / "perfbench" / "configs"
                       / f"{name}.json").read_text())


def test_k2_bound_is_the_lm_head_stream():
    cfg = config("openpangu-7b")
    d, V = 4096, 153376
    flops, nbytes = dense.k2_cost(cfg, 256)
    assert nbytes == d * V * 2 + 256 * d * 2
    assert flops == 2 * 256 * d * V
    assert bound_s(flops, nbytes, peaks(H100)) * 1e3 == pytest.approx(
        0.3757, abs=5e-5)
    # at the benchmark's 8 slots x 64 tree rows K2 is compute-bound
    f512, b512 = dense.k2_cost(cfg, 512)
    assert f512 / 989e12 > b512 / 3.35e12


def test_k3_bound_at_one_layer():
    cfg = config("openpangu-7b")
    flops, nbytes = dense.k3_cost(cfg, 64)
    n_out = (32 + 2 * 8) * 128
    assert flops == 2 * 64 * 4096 * n_out
    assert nbytes == 2 * (4096 * n_out + 64 * 4096 + 64 * n_out)


def test_unknown_card_has_no_peaks():
    assert peaks("cpu") is None
    assert peaks(H100)["bf16_flops_s"] == 989e12


def _planned_flops(arch: str, units: int, B: int, S: int) -> float:
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.dryrun import plan
    from repro_torch.launch.mesh import make_dev_mesh
    from repro_torch.launch.specs import with_num_units
    cfg = with_num_units(get_config(arch), units)
    rec = plan(cfg, ShapeConfig("bench", S, B, "decode"), make_dev_mesh(),
               False)
    return rec["flops_per_device"]


@pytest.mark.parametrize("arch,fam,units,T,tol", [
    # the planner traces the plain path, whose attention reads all S rows:
    # the count is given S committed rows a slot; both count the same
    # products, so they agree exactly (274.2 GFLOP at B 2, S 256)
    ("openpangu-7b", dense, 2, 64, 1e-9),
    # the planner counts products only; the count adds the recurrence's
    # state update (2 H P N a token and layer beyond the read-out's
    # product) and the convolutions: 0.42 % more at B 2
    ("mamba2-2.7b", ssm, 2, 5, 0.01),
])
def test_step_flops_match_the_dry_run_planner(arch, fam, units, T, tol):
    B, S = 2, 256
    cfg = dict(config(arch), num_layers=units)
    ours, _ = fam.step_cost(cfg, T, [S] * B)
    theirs = _planned_flops(arch, units, B, S)
    assert ours == pytest.approx(theirs, rel=tol)
    if fam is ssm:
        assert ours > theirs
