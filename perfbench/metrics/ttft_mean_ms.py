"""The mean, over every request whose first token came inside the
window, of the time from the client's send to that token (host
clock)."""


def read(run):
    waits = [1e3 * (s.req.first_token_s - s.sent_s) for s in run.sent
             if run.in_window(s.req.first_token_s)]
    return sum(waits) / len(waits) if waits else None
