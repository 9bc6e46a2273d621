"""Device resolution shared by the port's entry points, the kernel wrappers'
launch counters, and the capture of a decode step as a CUDA graph."""
from __future__ import annotations

import contextlib
import gc
import time

import torch


def resolve_device(device="cuda") -> torch.device:
    """-> ``torch.device`` for an entry point.

    ``"cuda"`` (the default everywhere) raises when no GPU is visible: the
    port never falls back to the CPU on its own, only when the caller asks
    for ``device="cpu"`` (the tests do).  Float32 matrix products and
    convolutions are pinned to full float32 here, so no entry point runs
    in TF32 by accident.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible; pass device='cpu' to "
                           "run the plain PyTorch versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev


def torch_dtype(name: str) -> torch.dtype:
    """Config dtype string ("float32", "bfloat16", "int8" for the
    quantized cache) -> torch dtype."""
    try:
        return {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "int8": torch.int8}[name]
    except KeyError:
        raise NotImplementedError(
            f"dtype {name!r}: the port carries float32 and bfloat16 (and "
            f"int8 for the KV cache)")


# ---------------------------------------------------------------------------
# launch counters
# ---------------------------------------------------------------------------

_COUNTED = []   # every kernel wrapper that counts its launches


def counted(fn, routes=()):
    """Give the kernel wrapper ``fn`` its launch counters, ``fn.launches``
    (plus ``fn.launches_by_route`` when ``routes`` are named), which the
    wrapper bumps where it launches its kernel, and register them with
    ``StepGraph``: a captured step adds its launches at every replay."""
    fn.launches = 0
    if routes:
        fn.launches_by_route = dict.fromkeys(routes, 0)
    _COUNTED.append(fn)
    return fn


def launch_counts() -> dict:
    """{wrapper: (launches, {route: launches})} of every counted wrapper."""
    return {fn: (fn.launches, dict(getattr(fn, "launches_by_route", {})))
            for fn in _COUNTED}


def _set_counts(counts: dict, plus: dict = None):
    """Set every wrapper's counters to ``counts``, plus ``plus`` if given."""
    for fn, (n, routes) in counts.items():
        dn, droutes = plus.get(fn, (0, {})) if plus else (0, {})
        fn.launches = n + dn
        for r, k in routes.items():
            fn.launches_by_route[r] = k + droutes.get(r, 0)


def _count_delta(after: dict, before: dict) -> dict:
    return {fn: (n - before[fn][0],
                 {r: k - before[fn][1].get(r, 0) for r, k in routes.items()})
            for fn, (n, routes) in after.items() if fn in before}


# ---------------------------------------------------------------------------
# the captured step
# ---------------------------------------------------------------------------

# the CUDA calls of the capture, one function each (the tests stub them)

def _capturable(device) -> bool:
    return device.type == "cuda"


@contextlib.contextmanager
def _on_side_stream(device):
    """Run the enclosed work on a fresh side stream, ordered after and
    before the current stream's work (the warm-up ``torch.cuda.graph``
    asks for)."""
    cur = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        yield
    cur.wait_stream(side)


def _capture_graph(fn, pool, device, generators=()):
    """-> a ``torch.cuda.CUDAGraph`` of the work ``fn()`` issues, captured
    into ``pool``.  The Python of ``fn`` runs; its device work is recorded,
    not executed.  Each of ``generators`` (CUDA ``torch.Generator``s that
    ``fn`` draws from) is registered with the graph before the capture, so
    every replay advances its Philox offset and draws fresh numbers, the
    ones the same work run eagerly from the same state would draw.  A draw
    from a CUDA generator that is not registered fails the capture.

    Python's cyclic garbage collector is held off during the capture: a
    dead graph in a reference cycle that the collector destroyed while
    another graph is capturing would invalidate that capture.  (The
    engines hold no such cycle: a dropped engine frees its graphs at
    once.)"""
    graph = torch.cuda.CUDAGraph()
    for gen in generators:
        graph.register_generator_state(gen)
    collecting = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph, pool=pool):
            fn()
    finally:
        if collecting:
            gc.enable()
    torch.cuda.synchronize(device)
    return graph


def _graph_pool():
    return torch.cuda.graph_pool_handle()


class StepGraph:
    """One step of a decode loop, run as a CUDA graph on the card.

    ``step()`` does one step's work and reads and writes only tensors whose
    addresses do not change from step to step: the loop's static carry,
    the cache and the weights.  Every call of the ``StepGraph`` does one
    step.  On the card the first call runs ``step`` eagerly on a side
    stream: the warm-up that ``torch.cuda.graph`` needs (every library
    loaded, every kernel attribute set), and a real step, since a step
    writes the cache in place.  The second call captures ``step`` into
    ``pool`` and replays the capture; every later call replays it.  A
    failed capture raises: there is no eager fallback.  With
    ``capture=False``, or on the CPU, every call runs ``step`` eagerly.

    Launch counts: the kernel wrappers count in Python, which runs only at
    capture.  So a capture adds nothing to their counters, and every
    replay adds the launches (and routes) the capture recorded.

    Randomness: ``generators`` are the ``torch.Generator``s the step draws
    from.  They are registered with the capture, so each replay draws new
    numbers (see ``_capture_graph``) and a run replays the draws of the
    same run made eagerly from the same generator state.
    """

    def __init__(self, step, device, pool=None, capture: bool = True,
                 generators=()):
        self.step = step
        self.device = torch.device(device)
        self.pool = pool
        self.generators = tuple(generators)
        self.capture = capture and _capturable(self.device)
        self.graph = None
        self.warm = False
        self.replays = 0
        self.capture_s = 0.0          # capture plus instantiation, seconds
        self.launches = {}            # what one replay adds to the counters

    def __call__(self):
        if not self.capture:
            self.step()
        elif not self.warm:
            with _on_side_stream(self.device):
                self.step()
            self.warm = True
        else:
            if self.graph is None:
                self._capture()
            self.graph.replay()
            self.replays += 1
            _set_counts(launch_counts(), self.launches)

    def _capture(self):
        before = launch_counts()
        t0 = time.perf_counter()
        try:
            graph = _capture_graph(self.step, self.pool, self.device,
                                   self.generators)
        except Exception as e:
            raise RuntimeError("capturing the decode step as a CUDA graph "
                               "failed; the port has no eager fallback "
                               "(build the engine with graphs=False to run "
                               "the step eagerly)") from e
        finally:
            after = launch_counts()
            _set_counts(before)
        self.capture_s = time.perf_counter() - t0
        self.launches = _count_delta(after, before)
        self.graph = graph


class StepGraphs:
    """The captured steps of one engine, sharing one memory pool.

    ``get(key, binding, make)`` returns the (StepGraph, carry) pair kept
    under ``key`` (a step's shape) while the tensors it was captured on,
    ``binding`` (see ``binding``), are the same; otherwise it drops that
    pair and keeps ``make()`` in its place.  ``make`` builds its
    ``StepGraph`` with ``graph(step, generators)``.  With ``capture=False``
    the steps run eagerly."""

    def __init__(self, device, capture: bool = True):
        self.device = torch.device(device)
        self.capture = capture
        self._pool = None
        self._kept = {}

    def graph(self, step, generators=()) -> StepGraph:
        if self.capture and _capturable(self.device) and self._pool is None:
            self._pool = _graph_pool()
        return StepGraph(step, self.device, self._pool, self.capture,
                         generators)

    def get(self, key, binding, make):
        held = self._kept.get(key)
        if held is None or held[0] != binding:
            self._kept.pop(key, None)
            held = self._kept[key] = (binding, make())
        return held[1]

    def kept(self) -> list:
        """Every kept (StepGraph, carry) pair."""
        return [pair for _, pair in self._kept.values()]

    @property
    def capture_s(self) -> float:
        """Seconds spent capturing and instantiating the kept graphs."""
        return sum(g.capture_s for g, _ in self.kept())


def binding(*trees) -> tuple:
    """(address, shape, dtype) of every tensor in nested dicts, and every
    ``torch.Generator`` itself (held, and compared by identity): a graph
    captured on these tensors, drawing from these generators, replays
    right on any others that match."""
    out = []

    def walk(t):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k])
        elif isinstance(t, torch.Tensor):
            out.append((t.data_ptr(), tuple(t.shape), t.dtype))
        elif isinstance(t, torch.Generator):
            out.append(t)
    for t in trees:
        walk(t)
    return tuple(out)
