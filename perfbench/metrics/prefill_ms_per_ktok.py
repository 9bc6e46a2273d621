"""Device ms a thousand prompt tokens admitted: CUDA events around each
prefill call (one bucket group, eager), summed over the window, over
the groups' prompt tokens (padding not counted)."""


def read(run):
    tokens = sum(n for _, n in run.prefill_ms)
    if not tokens:
        return None
    return sum(ms for ms, _ in run.prefill_ms) / (tokens / 1e3)
