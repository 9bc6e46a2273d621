"""Draft proposers for the speculative-decoding core (counterpart of
``repro.core.proposers``).  The port's first slice carries the protocol
and the paper's Medusa proposer; the draft-model and n-gram proposers are
ROADMAP queue 1 item 12.

Static-shape contract: the candidate topology is fixed at construction,
``init_state`` allocates every tensor the proposer will own, and
``propose``/``observe`` change values only, never shapes.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import medusa as M
from repro_torch.core import verify as V
from repro_torch.core.tree import TreeBuffers, default_tree


class Proposer:
    """Protocol for candidate proposers.

    Subclasses set ``tb``/``dtree`` in ``__init__`` and implement
    ``init_state`` / ``prime`` / ``propose`` / ``observe``.  Class
    attributes describe the contract to the engine:

    * ``consumes_key``  — propose() draws randomness from the ``key`` it is
      given (the engine's ``torch.Generator``).  The Medusa proposer draws
      nothing.
    * ``q_kind``        — the draft distribution's form, "mprob" (per-node
      head probabilities, verified by ``sample_verify_tree``) or "logits"
      (per-position draft logits, the chain walk of item 12).
    * ``supports_prefix`` — the proposer can be primed from a prompt
      suffix.
    """

    tb: TreeBuffers
    dtree: V.DeviceTree
    consumes_key: bool = False
    q_kind: str = "mprob"
    supports_prefix: bool = True

    def init_state(self, batch: int, capacity: int):
        """Allocate the proposer's device state for ``batch`` rows holding
        up to ``capacity`` tokens each."""
        raise NotImplementedError

    def prime(self, pp, state, tokens, lengths, hidden, base):
        """(Re)initialise ``state`` after a target prefill: tokens [B, S_p]
        right-padded prompt, lengths [B] prompt lengths, hidden [B, d] the
        target's last hidden state, base [B] the first emitted token."""
        raise NotImplementedError

    def propose(self, pp, state, base, key=None, temperature=1.0,
                top_k: int = 0, top_p=1.0, stochastic: bool = False):
        """-> (candidates [B, T] int32, q, state').  ``key`` is the
        generator a proposer that ``consumes_key`` draws from;
        ``temperature``/``top_k``/``top_p`` the warp its draws use
        (per-row [B] tensors allowed) and ``stochastic`` whether the
        engine verifies by sampling."""
        raise NotImplementedError

    def observe(self, pp, state, verdict, hidden, lengths):
        """Fold the verification outcome back into the state: ``hidden``
        [B, d] is the target hidden at the last accepted node, ``lengths``
        the post-commit cache lengths."""
        raise NotImplementedError


class MedusaProposer(Proposer):
    """The paper's trained K-head proposer (§3.1).

    State is the pair (mtok, mprob) [B, K, max_topk]: the head top-k
    computed from the target hidden at the previous step's last accepted
    node.  ``propose`` is a pure gather.
    """

    consumes_key = False
    q_kind = "mprob"
    supports_prefix = True

    def __init__(self, cfg: ModelConfig, device,
                 tb: Optional[TreeBuffers] = None):
        self.cfg = cfg
        self.device = torch.device(device)
        self.tb = tb if tb is not None else default_tree(cfg.spec_mode)
        self.dtree = V.device_tree(self.tb, self.device)

    def _heads(self, pp, hidden):
        if self.dtree.K == 0 or pp is None:
            return self.init_state(hidden.shape[0], 0)
        mtok, mprob = M.medusa_topk(pp, hidden, self.dtree.max_topk)
        return {"mtok": mtok.permute(1, 0, 2), "mprob": mprob.permute(1, 0, 2)}

    def init_state(self, batch: int, capacity: int):
        z = torch.zeros((batch, max(self.dtree.K, 1), self.dtree.max_topk),
                        dtype=torch.int32, device=self.device)
        return {"mtok": z, "mprob": z.float()}

    def prime(self, pp, state, tokens, lengths, hidden, base):
        return self._heads(pp, hidden)

    def propose(self, pp, state, base, key=None, temperature=1.0,
                top_k: int = 0, top_p=1.0, stochastic: bool = False):
        cand = V.generate_candidates(base, state["mtok"], self.dtree)
        return cand, state["mprob"], state

    def observe(self, pp, state, verdict, hidden, lengths):
        return self._heads(pp, hidden)
