"""From the process's start to the opening of the window: drawing the
weights, building (on a checkout's first run) and loading the kernels,
the warm-up of every prefill shape and the capture of the serve step,
and the closed loop until every client has completed one request."""


def read(run):
    return run.setup_s
