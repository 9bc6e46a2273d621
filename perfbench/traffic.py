"""The one traffic generator: reads a mix's file (``traffic/<name>.json``)
and makes its requests from the run's seed.

Lengths are drawn log-uniformly over each range, stratified: the range
is cut into ``strata`` equal steps of log-length, and every block of
``strata`` consecutive requests takes each step's midpoint once (prompt
and answer lengths apart), in an order fixed by the mix, the same for
every seed.  In a closed loop the order decides which long prompts meet
in one admission round, and so the tail of the time to the first token:
a seed that reordered the sizes would change the work a run holds, not
only its content.  The seed draws the token ids (uniform over the
vocabulary), as it draws the weights."""
from __future__ import annotations

import json
import math
import pathlib

import numpy as np

from perfbench.families import sub_seed

HERE = pathlib.Path(__file__).resolve().parent


def load_mix(name: str) -> dict:
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def strata(lo: int, hi: int, n: int) -> np.ndarray:
    """The midpoints of ``n`` equal steps of log-length over [lo, hi]."""
    k = (np.arange(n) + 0.5) / n
    return np.rint(np.exp(math.log(lo) + k * (math.log(hi) - math.log(lo))
                          )).astype(np.int64)


class Stream:
    """Request ``j`` of a mix under one seed: (prompt ids [len] int32,
    max_new).  The same (seed, j) always gives the same request, and
    every seed the same lengths."""

    def __init__(self, mix: dict, seed: int, vocab: int):
        self.seed, self.vocab, self.name = seed, vocab, mix["name"]
        self.n = mix["strata"]
        self.prompts = strata(*mix["prompt_tokens"], self.n)
        self.news = strata(*mix["new_tokens"], self.n)
        self._orders = {}

    def _order(self, block: int):
        if block not in self._orders:
            rng = np.random.default_rng(
                sub_seed(0, f"{self.name}/order{block}"))
            self._orders[block] = (rng.permutation(self.n),
                                   rng.permutation(self.n))
        return self._orders[block]

    def request(self, j: int):
        po, no = self._order(j // self.n)
        plen = int(self.prompts[po[j % self.n]])
        rng = np.random.default_rng(sub_seed(self.seed, f"request{j}"))
        prompt = rng.integers(0, self.vocab, size=plen, dtype=np.int32)
        return prompt, int(self.news[no[j % self.n]])


def warm_prompts(mix: dict, seed: int, vocab: int):
    """Prompts that fill every prefill shape the mix can reach: for each
    prompt bucket, groups of 1, 2, 4, ... (the server pads a group to a
    power of two) up to the clients, each prompt the bucket's length."""
    rng = np.random.default_rng(sub_seed(seed, "warm"))
    groups = []
    for bucket in mix["prompt_buckets"]:
        n = 1
        while True:
            m = min(n, mix["clients"])
            groups.append([rng.integers(0, vocab, size=bucket,
                                        dtype=np.int32) for _ in range(m)])
            if m == mix["clients"]:
                break
            n *= 2
    return groups
