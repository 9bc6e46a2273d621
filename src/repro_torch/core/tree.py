"""Static speculation-tree topology (the paper's §3.2 "Tensorization of
Tree Topology").

A tree spec is a set of paths — tuples of per-depth top-k choice indices,
e.g. ``(0, 1)`` = "head 1's top-0 followed by head 2's top-1".  All topology
is precomputed offline into invariant numpy buffers:

  * ``mask``             [T, T]   — the paper's ``medusa_attn_mask``
                                    (ancestor-or-self visibility)
  * ``node_head/choice`` [T-1]    — the paper's ``tree_indices`` (flat node ->
                                    (medusa head, top-k slot) in the candidate grid)
  * ``retrieve``         [P, K+1] — the paper's ``retrieve_indices`` zero-copy
                                    lookup table (per-path node offsets)
  * ``depths``           [T]      — RoPE/position offsets per node

These load once as device constants; the verification graph is identical on
every step regardless of acceptance outcome (Static Shape execution).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence, Tuple

import numpy as np


@dataclass(frozen=True)
class TreeBuffers:
    paths: tuple                 # prefix-closed, sorted node paths (excl. root)
    T: int                       # total nodes incl. root
    K: int                       # max depth == number of medusa heads needed
    P: int                       # number of retrieval paths (leaves)
    topk_per_head: tuple         # required top-k size per head (len K)
    mask: np.ndarray             # [T, T] bool
    depths: np.ndarray           # [T] int32
    parent: np.ndarray           # [T] int32 (root's parent = -1)
    node_head: np.ndarray        # [T-1] int32
    node_choice: np.ndarray      # [T-1] int32
    retrieve: np.ndarray         # [P, K+1] int32, padded with repeats of last
    retrieve_valid: np.ndarray   # [P, K+1] bool
    path_len: np.ndarray         # [P] int32 (nodes incl. root)

    @property
    def is_chain(self) -> bool:
        return self.P == 1 and all(c == 0 for p in self.paths for c in p)

    @property
    def max_topk(self) -> int:
        return max(self.topk_per_head) if self.topk_per_head else 1


def _closure(paths: Sequence[Tuple[int, ...]]):
    out = set()
    for p in paths:
        for i in range(1, len(p) + 1):
            out.add(tuple(p[:i]))
    return sorted(out, key=lambda p: (len(p), p))


def build_tree(paths: Sequence[Tuple[int, ...]]) -> TreeBuffers:
    paths = _closure(paths)
    if not paths:
        paths = []
    T = 1 + len(paths)
    K = max((len(p) for p in paths), default=0)
    index = {(): 0}
    for i, p in enumerate(paths):
        index[p] = i + 1

    depths = np.zeros(T, np.int32)
    parent = np.full(T, -1, np.int32)
    node_head = np.zeros(max(T - 1, 1), np.int32)
    node_choice = np.zeros(max(T - 1, 1), np.int32)
    mask = np.zeros((T, T), bool)
    mask[0, 0] = True
    for p in paths:
        i = index[p]
        depths[i] = len(p)
        parent[i] = index[p[:-1]]
        node_head[i - 1] = len(p) - 1
        node_choice[i - 1] = p[-1]
        mask[i, 0] = True
        for d in range(1, len(p) + 1):
            mask[i, index[p[:d]]] = True

    # leaves: nodes that are nobody's parent
    is_parent = set(parent[1:].tolist())
    leaves = [i for i in range(T) if i not in is_parent] if T > 1 else [0]
    if T > 1 and 0 in leaves:
        leaves.remove(0)
    P = len(leaves)
    retrieve = np.zeros((P, K + 1), np.int32)
    valid = np.zeros((P, K + 1), bool)
    path_len = np.zeros(P, np.int32)
    for r, leaf in enumerate(leaves):
        chain = []
        n = leaf
        while n != -1:
            chain.append(n)
            n = parent[n] if n != 0 else -1
        chain = chain[::-1]
        path_len[r] = len(chain)
        for j in range(K + 1):
            retrieve[r, j] = chain[min(j, len(chain) - 1)]
            valid[r, j] = j < len(chain)

    topk = tuple(int(node_choice[(node_head == h).nonzero()[0]].max()) + 1
                 for h in range(K)) if K else ()
    return TreeBuffers(paths=tuple(paths), T=T, K=K, P=P, topk_per_head=topk,
                       mask=mask, depths=depths, parent=parent,
                       node_head=node_head[: max(T - 1, 1)],
                       node_choice=node_choice[: max(T - 1, 1)],
                       retrieve=retrieve, retrieve_valid=valid, path_len=path_len)


def chain_tree(K: int) -> TreeBuffers:
    """Degenerate single-path tree (SSM/hybrid chain mode, DESIGN.md §4)."""
    return build_tree([tuple([0] * d) for d in range(1, K + 1)])


def cartesian_tree(topk: Sequence[int]) -> TreeBuffers:
    """Full cartesian tree, e.g. (3, 2, 1) -> 3*2*1 leaves."""
    paths = [()]
    for k in topk:
        paths = [p + (c,) for p in paths for c in range(k)]
    return build_tree(paths)


# The sparse 63-node tree shipped with Medusa (mc_sim_7b_63, Cai et al. 2024);
# 4 heads, 64 nodes including root, 42 retrieval paths.
MC_SIM_7B_63 = [
    (0,), (0, 0), (1,), (0, 1), (2,), (0, 0, 0), (1, 0), (0, 2), (3,), (0, 3),
    (4,), (0, 4), (2, 0), (0, 5), (0, 0, 1), (5,), (0, 6), (6,), (0, 7),
    (0, 1, 0), (1, 1), (7,), (0, 8), (0, 0, 2), (3, 0), (0, 9), (8,), (9,),
    (1, 0, 0), (0, 2, 0), (1, 2), (0, 0, 3), (4, 0), (2, 1), (0, 0, 4),
    (0, 0, 5), (0, 0, 0, 0), (0, 1, 1), (2, 2), (0, 0, 6), (1, 0, 1),
    (0, 3, 0), (5, 0), (1, 3), (0, 0, 7), (0, 0, 8), (0, 0, 9), (6, 0),
    (0, 4, 0), (1, 1, 0), (7, 0), (0, 1, 2), (2, 0, 0), (3, 1), (2, 3),
    (8, 0), (0, 5, 0), (1, 4), (0, 0, 0, 1), (0, 2, 1), (9, 0), (0, 6, 0),
    (0, 0, 0, 2),
]


def medusa_63() -> TreeBuffers:
    return build_tree(MC_SIM_7B_63)


def default_tree(spec_mode: str, K: int = 4) -> TreeBuffers:
    """Paper default: sparse tree for attention archs, chain for SSM/hybrid."""
    if spec_mode == "chain":
        return chain_tree(K)
    return medusa_63()
