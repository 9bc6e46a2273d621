"""Static tree verification + zero-copy retrieval (paper §3.2) in PyTorch;
counterpart of ``repro.core.verify``, greedy acceptance only, fed either
by the [B, T, V] logits (``greedy_verify``) or by the fused kernel's
statistics (``greedy_verify_stats``).

Everything here is fixed-shape tensor algebra on the device: the
acceptance outcome changes only values (indices fed to gathers), never
shapes, and nothing reads back to the host.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.tree import TreeBuffers


class DeviceTree(NamedTuple):
    """TreeBuffers uploaded as device constants."""
    mask: torch.Tensor            # [T, T] bool
    depths: torch.Tensor          # [T] int32
    node_head: torch.Tensor       # [T-1] int64 (index tensors)
    node_choice: torch.Tensor     # [T-1] int64
    retrieve: torch.Tensor        # [P, K+1] int64
    retrieve_valid: torch.Tensor  # [P, K+1] bool
    children: torch.Tensor        # [T, Cmax] int32, -1 padded
    T: int
    K: int
    P: int
    max_topk: int
    Cmax: int


def _children_table(tb: TreeBuffers):
    """[T, Cmax] child-node table (-1 padded) from the parent array."""
    kids = [[] for _ in range(tb.T)]
    for n in range(1, tb.T):
        kids[int(tb.parent[n])].append(n)
    cmax = max((len(k) for k in kids), default=0) or 1
    tab = np.full((tb.T, cmax), -1, np.int32)
    for n, k in enumerate(kids):
        tab[n, : len(k)] = k
    return tab, cmax


def device_tree(tb: TreeBuffers, device) -> DeviceTree:
    """Upload the offline numpy tree buffers to ``device``.  Index buffers
    become int64, the dtype PyTorch indexing takes."""
    children, cmax = _children_table(tb)

    def up(a, dtype):
        return torch.as_tensor(a, dtype=dtype, device=device)

    return DeviceTree(
        mask=up(tb.mask, torch.bool), depths=up(tb.depths, torch.int32),
        node_head=up(tb.node_head, torch.int64),
        node_choice=up(tb.node_choice, torch.int64),
        retrieve=up(tb.retrieve, torch.int64),
        retrieve_valid=up(tb.retrieve_valid, torch.bool),
        children=up(children, torch.int32),
        T=tb.T, K=tb.K, P=tb.P, max_topk=tb.max_topk, Cmax=cmax)


def generate_candidates(base_token, medusa_tok, dt: DeviceTree):
    """Assemble the tree token tensor.

    base_token [B] int32 (the certain next token), medusa_tok
    [B, K, max_topk] int32 (per-head top-k) -> candidates [B, T] int32 via
    the static node -> (head, slot) gather.
    """
    if dt.T == 1:
        return base_token[:, None]
    others = medusa_tok[:, dt.node_head, dt.node_choice]      # [B, T-1]
    return torch.cat([base_token[:, None], others], dim=1)


class Verdict(NamedTuple):
    acc: torch.Tensor             # [B] int32 in [1, K+1] — tokens committed
    path_slots: torch.Tensor      # [B, K+1] int64 — best path's node slots
    path_tokens: torch.Tensor     # [B, K+1] int32 — committed tokens (first acc valid)
    next_token: torch.Tensor      # [B] int32 — next step's certain base token
    last_slot: torch.Tensor       # [B] int64 — node whose hidden seeds the next step


def _select(acc_per_path, cand_paths, pred_paths, dtree):
    best = torch.argmax(acc_per_path, dim=1)                   # [B] first max wins
    acc = torch.gather(acc_per_path, 1, best[:, None])[:, 0]
    path_slots = dtree.retrieve[best]                          # [B, K+1]
    rows = torch.arange(best.shape[0], device=best.device)
    path_tokens = cand_paths[rows, best]                       # [B, K+1]
    preds = pred_paths[rows, best]
    next_token = torch.gather(preds, 1, (acc - 1)[:, None])[:, 0]
    last_slot = torch.gather(path_slots, 1, (acc - 1)[:, None])[:, 0]
    return Verdict(acc.to(torch.int32), path_slots, path_tokens,
                   next_token.to(torch.int32), last_slot)


def greedy_verify(candidates, logits, dtree: DeviceTree) -> Verdict:
    """Lossless greedy acceptance: a node is accepted iff its token equals
    the backbone argmax at its parent.

    candidates [B, T] int32, logits [B, T, V] f32/bf16 -> Verdict.  Ties in
    the argmax go to the first index, as in the reference."""
    argm = torch.argmax(logits, dim=-1).to(torch.int32)        # [B, T]
    return _greedy_from_argm(candidates, argm, dtree)


def _greedy_from_argm(candidates, argm, dtree: DeviceTree) -> Verdict:
    """The greedy rule after the argmax: argm [B, T] int32 -> Verdict."""
    cand_paths = candidates[:, dtree.retrieve]                 # [B, P, K+1]
    pred_paths = argm[:, dtree.retrieve]
    match = ((cand_paths[:, :, 1:] == pred_paths[:, :, :-1])
             & dtree.retrieve_valid[None, :, 1:])
    acc_per_path = 1 + torch.sum(torch.cumprod(match.to(torch.int32), dim=-1),
                                 dim=-1)
    return _select(acc_per_path, cand_paths, pred_paths, dtree)


# ---------------------------------------------------------------------------
# fused-stats acceptance: the same rule, fed by the kernel epilogue's
# Verdict-sized statistics instead of the [B, T, V] logits tensor
# ---------------------------------------------------------------------------

class VerifyStats(NamedTuple):
    """Output of ``kernels.ops.verify_stats``: everything acceptance needs.

    ``exp(cand_w[b, t, j] - m[b, t]) / l[b, t]`` is the warped target
    probability of candidate token j under node t's row; ``argm`` is the
    per-row first-wins argmax.  The greedy rule reads ``argm`` only; the
    rest serves the sampling walks (ROADMAP queue 1 item 8)."""
    argm: torch.Tensor            # [B, T] int32
    m: torch.Tensor               # [B, T] f32
    l: torch.Tensor               # [B, T] f32
    cand_w: torch.Tensor          # [B, T, T] f32


def greedy_verify_stats(candidates, stats: VerifyStats,
                        dtree: DeviceTree) -> Verdict:
    """``greedy_verify`` from fused statistics: the same ops after the
    argmax, so the Verdict is bit-identical to the unfused path whenever
    ``stats.argm`` equals ``argmax(logits)`` (the kernel's merge keeps the
    first index on ties, as ``torch.argmax`` does)."""
    return _greedy_from_argm(candidates, stats.argm, dtree)
