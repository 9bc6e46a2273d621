"""The card's peaks (``peaks.json``, by the name the card gives) and the
least time a piece of work can take on it."""
from __future__ import annotations

import json
import pathlib
from typing import Optional

HERE = pathlib.Path(__file__).resolve().parent


def peaks(kind: str) -> Optional[dict]:
    """The peaks of the card named ``kind``; None for a card (or a CPU)
    the table lacks."""
    return json.loads((HERE / "peaks.json").read_text()).get(kind)


def bound_s(flops: float, nbytes: float, pk: dict) -> float:
    """The larger of the compute time at the bf16 peak and the memory time
    at the HBM peak."""
    return max(flops / pk["bf16_flops_s"], nbytes / pk["hbm_bytes_s"])


def kernel_share(run, names, main: str, cost) -> Optional[float]:
    """A kernel's share of its roofline in the profiled sub-window, in %:
    the launches of ``main`` (one a call) times the bound of one call
    (``cost(rows)`` -> (flops, bytes), rows the serve step's slots times
    its tree rows), over the device time of every kernel in ``names``.
    None without a profile, a known card or a launch."""
    pk = peaks(run.device_kind)
    if run.profile is None or pk is None:
        return None
    ops = run.profile["ops"]
    launches = ops.get(main, [0.0, 0])[1]
    spent = sum(ops.get(n, [0.0, 0])[0] for n in names)
    if not launches or spent <= 0:
        return None
    return 100.0 * launches * bound_s(*cost(run.slots * run.tree_rows),
                                      pk) / spent
