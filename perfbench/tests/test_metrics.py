"""The end-to-end arithmetic on a scripted server and clock: a rate is
taken over the whole window and all its tokens, a tail over every
request, and a one-second stall inside the window moves both."""
from types import SimpleNamespace

import numpy as np
import pytest

from perfbench import harness
from perfbench.metrics import (accept_len, output_tok_s, sched_host_ms,
                               setup_s, tpot_p95_ms, ttft_mean_ms,
                               ttft_p95_ms)
from perfbench.tests.conftest import reduced, small_mix
from perfbench.traffic import Stream


class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


class ScriptedServer:
    """A server of ``slots`` slots that, each iteration, admits queued
    requests into free slots and gives every running request one token
    (its first the iteration after admission), ``dt`` seconds an
    iteration; the first iteration begun at or after ``stall_at`` (a time)
    takes one second more."""

    def __init__(self, clock, slots=4, dt=0.01, stall_at=None):
        self.clock, self.slots, self.dt = clock, slots, dt
        self.stall_at, self.iterations = stall_at, 0
        self.queue, self.running, self._rid = [], [], 0
        self.timing = {"iterations": 0, "iter_s": 0.0, "step_s": 0.0,
                       "admit_s": 0.0, "suffix_calls": 0}

    def submit(self, prompt, max_new):
        self._rid += 1
        self.queue.append(SimpleNamespace(
            rid=self._rid, prompt=prompt, max_new=max_new, output=[],
            steps=0, status="queued", first_token_s=None, finished_s=None))
        return self._rid

    def step_once(self):
        t0 = self.clock.t
        while self.queue and len(self.running) < self.slots:
            req = self.queue.pop(0)
            req.status = "running"
            self.running.append(req)
        self.clock.t += self.dt
        if self.stall_at is not None and t0 >= self.stall_at:
            self.clock.t += 1.0
            self.stall_at = None
        self.iterations += 1
        for req in self.running:
            req.output.append(7)
            req.steps += 1
            req.first_token_s = req.first_token_s or self.clock.t
        for req in [r for r in self.running
                    if len(r.output) >= r.max_new]:
            req.status, req.finished_s = "done", self.clock.t
            self.running.remove(req)
        self.timing["iterations"] += 1
        self.timing["iter_s"] += self.clock.t - t0
        self.timing["step_s"] += self.dt * 0.75


def drive(stall_at=None, seconds=5.0):
    clock = Clock()
    srv = ScriptedServer(clock, stall_at=stall_at)
    mix = dict(small_mix(), new_tokens=[64, 256])
    cfg = reduced("openpangu-7b")
    run = harness.Run(cell="c", cfg=cfg, mix=mix, seed=3, family=None,
                      slots=mix["clients"], tree_rows=64, device_kind="cpu",
                      t_start=clock.t - 2.0)
    loop = harness.ClosedLoop(srv, Stream(mix, 3, 256), mix["clients"],
                              clock)
    harness.drive(loop, run, seconds)
    return run


def test_rate_over_the_whole_window():
    run = drive()
    # 4 slots, one token each every 10 ms, whatever the requests' lengths
    assert run.window_s == pytest.approx(5.0, abs=0.011)
    assert output_tok_s.read(run) == pytest.approx(400.0, rel=0.01)
    # the steady tokens a step and the scripted host share
    assert accept_len.read(run) == pytest.approx(1.0)
    assert sched_host_ms.read(run) == pytest.approx(2.5, rel=1e-6)
    assert setup_s.read(run) == pytest.approx(run.t_open - run.t_start)


def test_tails_over_every_request():
    run = drive()
    done = run.completed()
    assert len(done) >= 8
    # every request takes 10 ms a token after its first
    assert tpot_p95_ms.read(run) == pytest.approx(10.0, rel=1e-6)
    waits = sorted(1e3 * (s.req.first_token_s - s.sent_s) for s in run.sent
                   if run.in_window(s.req.first_token_s))
    assert ttft_p95_ms.read(run) == pytest.approx(
        float(np.percentile(waits, 95)))
    assert ttft_mean_ms.read(run) == pytest.approx(float(np.mean(waits)))


def test_a_one_second_stall_moves_rate_and_tail():
    calm, stalled = drive(), drive(stall_at=105.0)
    # the stall lies inside the window
    assert stalled.t_open < 105.0 < stalled.t_close
    # the rate counts the stalled second: fewer tokens in a window of
    # the same length
    assert output_tok_s.read(stalled) < 0.85 * output_tok_s.read(calm)
    # the requests in flight through the stall take 1 s more: the tail
    # of the time a token grows
    assert tpot_p95_ms.read(stalled) > 1.5 * tpot_p95_ms.read(calm)



def test_a_stall_before_a_first_token_moves_its_mean():
    calm = drive()
    # the iteration right after a send inside the window stalls: the
    # request just sent waits a second more for its first token
    t = next(s.sent_s for s in calm.sent if calm.t_open < s.sent_s < 106.0)
    stalled = drive(stall_at=t)
    waits = [1e3 * (s.req.first_token_s - s.sent_s) for s in calm.sent
             if calm.in_window(s.req.first_token_s)]
    assert ttft_mean_ms.read(stalled) > ttft_mean_ms.read(calm) \
        + 1e3 / (len(waits) + 1)


def test_requests_that_end_after_the_close_are_drained_not_counted():
    run = drive()
    late = [s for s in run.sent if s.req.finished_s > run.t_close]
    assert late and all(s.done for s in late)
    assert not any(s is c for s in late for c in run.completed())
    assert all(s.done for s in run.attempted())
