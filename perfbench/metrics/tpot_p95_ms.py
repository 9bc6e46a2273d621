"""The 95th percentile, over every request completed inside the window,
of its time per output token after the first: (finish - first token) /
(tokens - 1), host clock."""
from perfbench.harness import percentile


def read(run):
    return percentile([1e3 * (s.req.finished_s - s.req.first_token_s)
                       / (len(s.req.output) - 1)
                       for s in run.completed() if len(s.req.output) > 1],
                      95)
