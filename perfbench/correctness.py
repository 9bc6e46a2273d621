"""Whether what the timed path served is right: the plain reference over
a sample of the requests the window finished.

The sample is drawn from the seed among the requests completed (done)
inside the window: the longest one (prompt and answer), the one with the
most served tokens, one served by each decode slot (a fault that spares
some slots still shows), then others in the seed's order until
``check_tokens`` served tokens or ``check_requests`` requests.  The
reference runs once over each sampled prompt followed by its served
tokens, and reads the logits before each served token.  A served
token's gap is how far its logit lies below the reference's best there;
``max_gap`` is the widest over the sample.  Greedy decoding serves the
argmax, so an exact program's gaps are 0; one in bfloat16 gives small
gaps where two logits lie close.

The control puts the reference in the program's place, computed with
every product's operands in float8: at the same positions it reads the
gap of the token float8 puts first.

Also compared: requests that never completed (``failed``) and completed
requests whose answer is not the length asked for (``short_answers``):
the mix sends no EOS, so every answer has exactly its ``max_new``
tokens."""
from __future__ import annotations

import json
import pathlib

import numpy as np
import torch

from perfbench.families import sub_seed
from perfbench.reference import forward

HERE = pathlib.Path(__file__).resolve().parent
GROUP = 4       # sequences the reference runs together


def load_limits(cell: str) -> dict:
    return json.loads((HERE / "limits" / f"{cell}.json").read_text())


def sample(run) -> list:
    """The sampled requests (``harness.Sent``), drawn from the run's
    seed."""
    done = run.completed()
    if not done:
        return []
    rng = np.random.default_rng(sub_seed(run.seed, "check"))
    order = [done[i] for i in rng.permutation(len(done))]
    longest = max(done, key=lambda s: len(s.req.prompt) + len(s.req.output))
    most = max(done, key=lambda s: len(s.req.output))
    picks = [longest] + ([most] if most is not longest else [])
    slots = {run.slot_of.get(s.req.rid) for s in picks}
    for s in order:
        slot = run.slot_of.get(s.req.rid)
        if slot not in slots:
            slots.add(slot)
            picks.append(s)
    for s in order:
        if (len(picks) >= run.mix["check_requests"]
                or sum(len(p.req.output) for p in picks)
                >= run.mix["check_tokens"]):
            break
        if not any(s is p for p in picks):
            picks.append(s)
    return picks


def gaps(weights, cfg: dict, picks, control: bool = False) -> dict:
    """{"program": per-request arrays of the served tokens' gaps} and,
    with ``control``, {"control": the gaps of the float8 argmax}."""
    seqs = [np.concatenate([s.req.prompt, np.asarray(s.req.output,
                                                     np.int32)])
            for s in picks]
    reads = [(len(s.req.prompt) - 1, len(s.req.output)) for s in picks]
    fwd = forward(cfg["family"])
    with torch.no_grad():
        ref = fwd(weights, cfg, seqs, reads, "f32")
        out = {"program": []}
        best = [r.max(dim=-1).values for r in ref]
        for r, b, s in zip(ref, best, picks):
            tok = torch.as_tensor(np.asarray(s.req.output, np.int64),
                                  device=r.device)
            out["program"].append((b - r.gather(1, tok[:, None])[:, 0])
                                  .cpu().numpy())
        if control:
            low = fwd(weights, cfg, seqs, reads, "fp8")
            out["control"] = []
            for r, b, c in zip(ref, best, low):
                tok = c.argmax(dim=-1)
                out["control"].append((b - r.gather(1, tok[:, None])[:, 0])
                                      .cpu().numpy())
    return out


def widest(per_request) -> float:
    return float(max((float(g.max()) for g in per_request if len(g)),
                     default=0.0))


def check(run, weights, limits: dict) -> tuple:
    """(correct, checks): each compared number beside its limit."""
    attempted = run.attempted()
    failed = sum(1 for s in attempted if not s.done)
    short = sum(1 for s in run.sent
                if s.done and len(s.req.output) != s.req.max_new)
    picks = sample(run)
    g = gaps(weights, run.cfg, picks)
    served = int(sum(len(x) for x in g["program"]))
    checks = {
        "max_gap": {"value": widest(g["program"]),
                    "limit": limits["max_gap"]},
        "failed": {"value": failed, "limit": 0},
        "short_answers": {"value": short, "limit": 0},
        "no_tokens_checked": {"value": int(served == 0), "limit": 0},
    }
    correct = (checks["max_gap"]["value"] <= limits["max_gap"]
               and failed == 0 and short == 0 and served >= 1)
    return correct, checks
