"""Every output token delivered inside the window, divided by the
window's seconds (host clock)."""


def read(run):
    return run.delivered / run.window_s if run.window_s > 0 else None
