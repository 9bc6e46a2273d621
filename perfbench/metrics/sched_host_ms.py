"""Host ms per scheduler iteration outside the serve step's replay and
its sync read, over the window: (SpecServer.timing's iter_s - step_s) /
iterations.  Admission's host work is in it, and the part of an eager
prefill the device has not finished when the next step's sync waits is
not (the sync absorbs it)."""


def read(run):
    t = run.timing
    if not t.get("iterations"):
        return None
    return 1e3 * (t["iter_s"] - t["step_s"]) / t["iterations"]
