"""Tokens a serve step delivers a request: the tokens of every request
completed inside the window over their serve steps (Request.steps)."""


def read(run):
    done = run.completed()
    steps = sum(s.req.steps for s in done)
    return sum(len(s.req.output) for s in done) / steps if steps else None
