"""The 95th percentile, over every request whose first token came inside
the window, of the time from the client's send to that token (host
clock)."""
from perfbench.harness import percentile


def read(run):
    return percentile([1e3 * (s.req.first_token_s - s.sent_s)
                       for s in run.sent
                       if run.in_window(s.req.first_token_s)], 95)
