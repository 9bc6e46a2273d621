"""The check catches a broken timed path: on the CPU, at the reduced
sizes, the harness runs with one fault planted in the port underneath
and ``correct`` comes out false against the cell's own limit.  The
faults a served model can have: a step that returns its state unchanged
(the commit advances no length), half of the batch left out (its rows'
hidden states never computed), and a token altered where it is produced
(the step's sync read)."""
import time

import pytest
import torch

from perfbench import correctness, harness
from perfbench.tests.conftest import reduced, small_mix

CELLS = {"openpangu-7b": "pangu7b-chat", "mamba2-2.7b": "mamba2-chat"}


def plant(monkeypatch, fault: str):
    from repro_torch.models import transformer
    if fault == "state_unchanged":
        def frozen(cfg, spec_cache, lengths, *args, **kw):
            # nothing committed: the cache, the recurrent state and the
            # lengths stay as they were before the step
            cache = {pos: {n: t for n, t in entry.items()
                           if not n.endswith("_new")}
                     for pos, entry in spec_cache.items()}
            return cache, lengths
        monkeypatch.setattr(transformer, "commit", frozen)
    elif fault == "half_batch":
        decode = transformer.decode

        def half(*args, **kw):
            hidden, spec = decode(*args, **kw)
            hidden = hidden.clone()
            hidden[hidden.shape[0] // 2:] = 0
            return hidden, spec
        monkeypatch.setattr(transformer, "decode", half)
    elif fault == "token_altered":
        build = harness.build

        def altered(*args, **kw):
            w, engine, srv = build(*args, **kw)
            step = srv._step_fn
            V = engine.cfg.vocab_size

            def step_fn(level):
                sync = step(level)
                sync[:, 3] = (sync[:, 3] + 1) % V
                return sync
            srv._step_fn = step_fn
            return w, engine, srv
        monkeypatch.setattr(harness, "build", altered)


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "token_altered"])
@pytest.mark.parametrize("name", sorted(CELLS))
def test_a_planted_fault_is_not_correct(monkeypatch, name, fault):
    plant(monkeypatch, fault)
    cell = CELLS[name]
    with torch.no_grad():
        run, w = harness.run_cell(cell, reduced(name), small_mix(), 77, 2.0,
                                  False, "cpu", time.monotonic())
        ok, checks = correctness.check(run, w, correctness.load_limits(cell))
    assert not ok, checks
    assert checks["max_gap"]["value"] > checks["max_gap"]["limit"]


@pytest.mark.parametrize("name", sorted(CELLS))
def test_control_reads_far_above_the_program(name):
    """The control (the reference in float8, in the program's place) on
    the same sample reads far above the float32 program at this size."""
    with torch.no_grad():
        run, w = harness.run_cell(CELLS[name], reduced(name), small_mix(),
                                  78, 2.0, False, "cpu", time.monotonic())
        g = correctness.gaps(w, run.cfg, correctness.sample(run),
                             control=True)
    program, control = (correctness.widest(g["program"]),
                        correctness.widest(g["control"]))
    assert control > 1e-2
    assert control > 100 * program
