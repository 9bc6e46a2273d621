"""One module a model family, found by the ``family`` key of a
configuration's file: ``draw`` makes the weights from the seed in the
benchmark's own layout, ``to_port`` hands them to the port (its config,
its parameter tree and the Medusa heads, as views where the layouts
agree), and ``step_cost`` / ``prefill_cost`` count the operations and
bytes that a serve step and a prefill need at least."""
import importlib

import numpy as np


def family(name: str):
    """The module of the family ``name`` (``perfbench.families.<name>``)."""
    return importlib.import_module(f"perfbench.families.{name}")


def sub_seed(seed: int, tag: str) -> int:
    """A 64-bit seed for one use (``tag``) of the run's ``--seed``, which
    may be any whole number."""
    words = [int(b) for b in tag.encode()]
    ss = np.random.SeedSequence([int(seed) % 2**64] + words)
    return int(ss.generate_state(1, np.uint64)[0])
