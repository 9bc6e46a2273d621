"""Device ms of one serve step's replay: CUDA events around the server's
step call (the captured graph's replay), the mean over the window."""


def read(run):
    return sum(run.step_ms) / len(run.step_ms) if run.step_ms else None
