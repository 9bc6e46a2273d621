"""Carry parameters across from the reference package.

``to_torch`` turns a parameter tree of nested dicts of **numpy** arrays
(the reference's ``split_params`` output after ``np.asarray`` on each leaf)
into the same nesting of torch tensors, leaf by leaf, with names and
layouts unchanged: ``wq [d, Hq, hd]``, the stacked ``params["units"]``,
Medusa's ``w1``/``b1``/``lm``; a leaf named ``lm_head`` keeps its name and
shape and is laid out on its device at the 16-byte row pitch the verify
kernel reads (``pitch_lm_head``; ``Tensor.to`` would give a contiguous
copy of a pitched view, so the pitch is made after the move).
``adamw_to_torch`` carries an AdamW state
(``step``, ``mu``, ``nu`` as numpy) across into the port's
``optimizer.AdamWState``.  Neither ever sees a JAX object.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.tree_attention import pitch_lm_head
from repro_torch.runtime import resolve_device
from repro_torch.training.optimizer import AdamWState


def _leaf(a: np.ndarray, device) -> torch.Tensor:
    if a.dtype.name == "bfloat16":
        # numpy has no bfloat16 of its own; ml_dtypes' arrays share its bits
        t = torch.from_numpy(np.array(a).view(np.uint16))
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def to_torch(tree, device="cuda"):
    """Nested dicts of numpy arrays -> the same nesting of tensors on
    ``device`` (the card by default; raises if there is none); an
    ``lm_head`` leaf is pitched on ``device``."""
    dev = resolve_device(device)

    def conv(node, name=None):
        if isinstance(node, dict):
            return {k: conv(v, k) for k, v in node.items()}
        if not isinstance(node, np.ndarray):
            raise TypeError(f"to_torch takes numpy leaves, got {type(node)}")
        t = _leaf(node, dev)
        return pitch_lm_head(t) if name == "lm_head" else t

    return conv(tree)


def adamw_to_torch(step, mu, nu, device="cuda") -> AdamWState:
    """An AdamW state given as numpy (``step`` a 0-dim int32 array, ``mu``
    and ``nu`` nested dicts of arrays, the reference's ``AdamWState``
    fields) -> the port's ``AdamWState`` on ``device``."""
    return AdamWState(step=to_torch({"s": np.asarray(step)}, device)["s"],
                      mu=to_torch(mu, device), nu=to_torch(nu, device))
