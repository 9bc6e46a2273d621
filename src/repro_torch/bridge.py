"""Carry parameters across from the reference package.

``to_torch`` turns a parameter tree of nested dicts of **numpy** arrays
(the reference's ``split_params`` output after ``np.asarray`` on each leaf)
into the same nesting of torch tensors, leaf by leaf, with names and
layouts unchanged: ``wq [d, Hq, hd]``, the stacked ``params["units"]``,
Medusa's ``w1``/``b1``/``lm``.  It never sees a JAX object.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.runtime import resolve_device


def _leaf(a: np.ndarray, device) -> torch.Tensor:
    if a.dtype.name == "bfloat16":
        # numpy has no bfloat16 of its own; ml_dtypes' arrays share its bits
        t = torch.from_numpy(np.array(a).view(np.uint16))
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def to_torch(tree, device="cuda"):
    """Nested dicts of numpy arrays -> the same nesting of tensors on
    ``device`` (the card by default; raises if there is none)."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if not isinstance(node, np.ndarray):
            raise TypeError(f"to_torch takes numpy leaves, got {type(node)}")
        return _leaf(node, dev)

    return conv(tree)
