"""The traced run's instruments, all from the benchmark's side: profiler
ranges around the host's phases (``perfbench.<phase>``: admission and
inside it each prefill call, the step and inside it the graph's replay,
the reap, the clients), CUDA events around the serve step's replay and
each prefill call, and one ``torch.profiler`` session over a short
steady sub-window of the run, just before the measured window opens
(the profiler drops records in long sessions over the captured steps),
reduced to busy time, idle gaps, and device time and launches by
kernel."""
from __future__ import annotations

import contextlib
import re

import torch

PROFILE_S = 1.0     # the sub-window's seconds (whole iterations)
PREFIX = "perfbench."
SUBWINDOW = PREFIX + "subwindow"


def span(name: str):
    """A profiler range around one of the host's phases."""
    return torch.profiler.record_function(PREFIX + name)


def no_span(name: str):
    return contextlib.nullcontext()


def event_pair():
    return (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))


def settle(run, dev):
    """The window's CUDA-event readings in ms: every serve step's replay
    and every prefill call (with its prompt tokens) that began inside
    the window."""
    if dev.type != "cuda":
        return
    torch.cuda.synchronize(dev)
    run.step_ms = [a.elapsed_time(b) for t, a, b in run.step_events
                   if run.in_window(t)]
    run.prefill_ms = [(a.elapsed_time(b), n)
                      for t, a, b, n in run.prefill_events
                      if run.in_window(t)]
    run.step_events.clear()
    run.prefill_events.clear()


def profile_iterations(loop, dev, seconds: float = PROFILE_S):
    """Whole scheduler iterations for ``seconds`` under the profiler,
    inside one range (``SUBWINDOW``) that begins and ends with the device
    idle."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function(SUBWINDOW):
            t0 = loop.clock()
            while loop.clock() - t0 < seconds:
                loop.iterate()
            torch.cuda.synchronize(dev)
    return prof


def kernel_name(key: str) -> str:
    """A kernel's unqualified name (``verify_stats_wgmma`` for ``void
    (anonymous namespace)::verify_stats_wgmma<...>(...)``)."""
    m = re.search(r"::(\w+)\s*[<(]", key)
    if m:
        return m[1]
    m = re.match(r"(?:void\s+)?(\w+)\s*[<(]", key)
    return m[1] if m else key[:80]


def _union(intervals):
    """Merged, sorted [start, end] intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def summarize(prof) -> dict:
    """The sub-window's device record: ``window_s``, ``busy_s`` (the union
    of the intervals in which an operation ran on the device), ``ops``
    {kernel name: [seconds, launches]} and ``gaps`` [[host phase,
    seconds]] (each idle stretch of the device, named by the innermost
    host phase that held its middle)."""
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    events = prof.events()
    sub = [e for e in events if e.device_type == cpu and e.name == SUBWINDOW]
    if not sub:
        return None
    w0, w1 = sub[0].time_range.start, sub[0].time_range.end
    ops, spans, busy = {}, [], []
    for e in events:
        if e.device_type == cuda:
            if getattr(e, "is_user_annotation", False):
                continue
            a, b = max(e.time_range.start, w0), min(e.time_range.end, w1)
            if b <= a:
                continue
            busy.append((a, b))
            rec = ops.setdefault(kernel_name(e.name), [0.0, 0])
            rec[0] += (b - a) / 1e6
            rec[1] += 1
        elif e.name.startswith(PREFIX) and e.name != SUBWINDOW:
            spans.append((e.time_range.start, e.time_range.end,
                          e.name[len(PREFIX):]))
    merged = _union(busy)
    gaps, prev = [], w0
    for a, b in merged + [[w1, w1]]:
        if a > prev:
            mid = (a + prev) / 2
            held = [s for s in spans if s[0] <= mid <= s[1]]
            name = (min(held, key=lambda s: s[1] - s[0])[2] if held
                    else "host")
            gaps.append([name, (a - prev) / 1e6])
        prev = max(prev, b)
    return {"window_s": (w1 - w0) / 1e6,
            "busy_s": sum(b - a for a, b in merged) / 1e6,
            "ops": ops, "gaps": gaps}


def breakdown(profile: dict, top: int = 10) -> dict:
    """The result line's ``breakdown``: the device operations that took
    most time, and the longest idle gaps with the host phase under each."""
    ops = sorted(profile["ops"].items(), key=lambda kv: -kv[1][0])
    gaps = sorted(profile["gaps"], key=lambda g: -g[1])
    return {"device_ops": [[name, rec[0]] for name, rec in ops[:top]],
            "idle_gaps": [list(g) for g in gaps[:top]]}
