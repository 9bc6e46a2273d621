"""Static tree verification + zero-copy retrieval (paper §3.2) in PyTorch;
counterpart of ``repro.core.verify``.

Four acceptance rules share the ``Verdict`` contract: ``greedy_verify``
(lossless argmax match), ``typical_verify`` (Medusa's lossy typical
acceptance), and the lossless rejection-sampling pair
``sample_verify_tree`` (over a tree, for a deterministic top-k proposal)
and ``sample_verify_chain`` (over a chain a draft model sampled).  Greedy
and sampling are also fed by the fused kernel's statistics instead of the
[B, T, V] logits (``greedy_verify_stats``, ``sample_verify_tree_stats``,
``sample_verify_chain_stats``).

Everything here is fixed-shape tensor algebra on the device: the
acceptance outcome changes only values (indices fed to gathers), never
shapes, and nothing reads back to the host.  Randomness is an argument
(see ``core.sampling``): the sampled walks take the acceptance uniforms
``u`` (tree: [B, max(K, 1), Cmax]; chain: [B, K]) and the Gumbel noise
``g`` [B, V] of the final draw as tensors.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import sampling as S
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


def typical_verify(candidates, logits, dtree: DeviceTree, g,
                   temperature: float = 0.7, eps: float = 0.3,
                   delta: float = 0.09) -> Verdict:
    """Medusa's typical-acceptance criterion: accept candidate x at a node
    if p(x|parent) >= min(eps, delta * exp(-H(p))) under temperature
    sampling.

    candidates [B, T] int32, logits [B, T, V] f32/bf16, g [B, V] Gumbel
    noise for the bonus-token draw -> Verdict; ``next_token`` is drawn
    from the typical set at the last accepted node rather than argmax."""
    B, _, Vc = logits.shape
    f32 = logits.float() / max(temperature, 1e-4)
    logp = torch.log_softmax(f32, dim=-1)                      # [B, T, V]
    thresh = S.typical_threshold(logp, eps, delta)             # [B, T]

    cand_paths = candidates[:, dtree.retrieve]                 # [B, P, K+1]
    # p(child token | parent node), gathered without the reference's
    # [B, P, K, V] intermediate (the same values: exp is elementwise)
    rows = torch.arange(B, device=logits.device)[:, None, None]
    parent = dtree.retrieve[:, :-1][None]                      # [1, P, K]
    p_child = torch.exp(logp[rows, parent, cand_paths[:, :, 1:].long()])
    th = thresh[:, dtree.retrieve[:, :-1]]                     # [B, P, K]
    match = (p_child >= th) & dtree.retrieve_valid[None, :, 1:]
    acc_per_path = 1 + torch.sum(torch.cumprod(match.to(torch.int32),
                                               dim=-1), dim=-1)

    pred_paths = torch.argmax(logits, dim=-1).to(torch.int32)[
        :, dtree.retrieve]
    v = _select(acc_per_path, cand_paths, pred_paths, dtree)
    # draw the bonus token from the typical set at the last accepted node
    last_logp = logp[torch.arange(B, device=logits.device), v.last_slot]
    cut = torch.log(S.typical_threshold(last_logp, eps, delta))[:, None]
    trimmed = torch.where(last_logp >= cut, last_logp, float("-inf"))
    # degenerate trim (the threshold can exceed even max(logp) in f32 at
    # extreme temperatures, leaving an all -inf row): fall back to a point
    # mass on the argmax so the draw stays well-defined
    onehot = torch.nn.functional.one_hot(torch.argmax(last_logp, dim=-1),
                                         Vc).bool()
    argmax_only = torch.where(onehot, 0.0, float("-inf"))
    trimmed = torch.where(torch.all(torch.isinf(trimmed), dim=-1,
                                    keepdim=True), argmax_only, trimmed)
    return v._replace(next_token=S.categorical(g, trimmed))


def _node_q(mprob, dtree: DeviceTree, B: int, device):
    """[B, T] draft probability of every node (1 at the root) from the
    Medusa head probabilities mprob [B, K, max_topk]."""
    ones = torch.ones((B, 1), dtype=torch.float32, device=device)
    if dtree.T == 1:
        return ones
    qnode = mprob[:, dtree.node_head, dtree.node_choice]      # [B, T-1]
    return torch.cat([ones.to(qnode.dtype), qnode], dim=1)


def _sibling_order(cur, qnode, dtree: DeviceTree, rows):
    """[B, Cmax] children of node ``cur``, valid ones first in descending
    q (ties keep table order, as the reference's stable argsort does),
    -1 padded, as int64."""
    tab = dtree.children[cur].long()                           # [B, Cmax]
    qkids = torch.where(tab >= 0, qnode[rows[:, None], tab.clamp(min=0)],
                        -1.0)
    order = torch.sort(-qkids, dim=1, stable=True).indices
    return torch.gather(tab, 1, order)


def _remove_token(r, x):
    """r [B, V] with token x [B] zeroed and renormalised; rows left with
    ~no mass keep r (the reference's fallback)."""
    removed = r.scatter(1, x[:, None], 0.0)
    s = torch.sum(removed, dim=-1, keepdim=True)
    return torch.where(s > 1e-9, removed / torch.clamp(s, min=1e-38), r)


def _chain_verdict(candidates, accept, dtree: DeviceTree, p_last_fn, q,
                   g) -> Verdict:
    """The chain rule after the per-token tests ``accept`` [B, gamma]: the
    accepted prefix, then the next token drawn with ``g`` from the target
    distribution at the last accepted node (``p_last_fn(last)`` -> [B, V])
    on a full accept, else from the residual ``norm(max(p - q, 0))``."""
    B, T = candidates.shape
    gamma = T - 1
    rows = torch.arange(B, device=candidates.device)
    acc = 1 + torch.sum(torch.cumprod(accept.to(torch.int32), dim=-1),
                        dim=-1)
    last = (acc - 1).long()                                    # [B]
    p_last = p_last_fn(last)
    q_last = q[rows, torch.clamp(last, max=gamma - 1)]
    full = (acc == T)[:, None]
    next_dist = torch.where(full, p_last, S.residual_dist(p_last, q_last))
    path_slots = dtree.retrieve[0].repeat(B, 1)             # [B, K+1]
    return Verdict(acc.to(torch.int32), path_slots, candidates,
                   S.categorical_from_probs(g, next_dist), last)


def sample_verify_chain(candidates, logits, draft_logits, dtree: DeviceTree,
                        u, g, temperature=1.0, top_k: int = 0,
                        top_p=1.0) -> Verdict:
    """Lossless chain rejection-sampling verification (Leviathan/Chen) for
    the draft-model proposer.

    candidates [B, gamma+1] int32 (slot 0 the certain base token), logits
    [B, gamma+1, V] target logits (node i predicts token i+1),
    draft_logits [B, gamma, V] the draft distributions that sampled
    candidates[:, 1:], u [B, gamma] f32 uniforms, g [B, V] Gumbel noise for
    the final draw.  Draft token x_i is accepted with probability
    min(1, p_i(x_i)/q_i(x_i)), evaluated division-free as ``u*q < p``; the
    first rejection draws from the residual ``norm(max(p - q, 0))``, a
    full accept draws the bonus token from the target distribution at the
    last node.  p and q pass through the same warp, so the committed
    stream is distributed as warped-target autoregressive sampling.
    ``temperature``/``top_p`` may be per-row [B] tensors.
    """
    p = S.warp_probs(logits, temperature, top_k, top_p)       # [B, T, V]
    q = S.warp_probs(draft_logits, temperature, top_k, top_p)  # [B, g, V]
    x = candidates[:, 1:].long()[..., None]                    # [B, g, 1]
    px = torch.gather(p[:, :-1], -1, x)[..., 0]
    qx = torch.gather(q, -1, x)[..., 0]
    rows = torch.arange(candidates.shape[0], device=candidates.device)
    return _chain_verdict(candidates, u * qx < px, dtree,
                          lambda last: p[rows, last], q, g)


def sample_verify_tree(candidates, logits, mprob, dtree: DeviceTree, u, g,
                       temperature=1.0, top_k: int = 0,
                       top_p=1.0) -> Verdict:
    """Multi-round per-node rejection sampling over the static tree: the
    lossless stochastic mode of the Medusa engine.

    candidates [B, T] int32, logits [B, T, V], mprob [B, K, max_topk] f32
    the Medusa head probabilities that ranked the candidates (the draft
    distribution q), u [B, max(K, 1), Cmax] f32 uniforms (one per round
    and sibling), g [B, V] Gumbel noise for the final draw.  The walk
    starts at the root with the warped target distribution r = p; at each
    accepted node the sibling candidates are tested highest-q first,
    candidate x being accepted with the residual mass r(x) (the
    ``min(1, r/q)`` rule at a deterministic top-k proposal's point-mass
    limit), and each rejection removes x's mass: r <- norm(max(r -
    r(x)·delta_x, 0)).  A row whose node rejects every child draws its
    next token from the final residual; a row that walks the full depth
    draws the bonus from the target distribution at the leaf.
    ``temperature``/``top_p`` may be per-row [B] tensors.
    """
    B, T = candidates.shape
    dev = candidates.device
    P_all = S.warp_probs(logits, temperature, top_k, top_p)   # [B, T, V]
    rows = torch.arange(B, device=dev)
    qnode = _node_q(mprob, dtree, B, dev)
    cand = candidates.long()

    cur = torch.zeros((B,), dtype=torch.int64, device=dev)
    stopped = torch.zeros((B,), dtype=torch.bool, device=dev)
    r = P_all[:, 0]
    acc = torch.ones((B,), dtype=torch.int32, device=dev)
    slots, tokens = [cur], [candidates[:, 0]]
    for d in range(1, dtree.K + 1):
        tab = _sibling_order(cur, qnode, dtree, rows)
        accepted = torch.zeros((B,), dtype=torch.bool, device=dev)
        chosen = cur
        for j in range(dtree.Cmax):
            ch = tab[:, j]
            valid = (ch >= 0) & ~stopped & ~accepted
            x = cand[rows, ch.clamp(min=0)]
            take = valid & (u[:, d - 1, j] < r[rows, x])
            rejected = valid & ~take
            r = torch.where(rejected[:, None], _remove_token(r, x), r)
            chosen = torch.where(take, ch, chosen)
            accepted = accepted | take
        # accepted rows descend: their residual resets to the target
        # distribution at the new node for the next round
        r = torch.where(accepted[:, None], P_all[rows, chosen], r)
        acc = acc + accepted.to(torch.int32)
        slots.append(chosen)
        tokens.append(candidates[rows, chosen])
        stopped = stopped | ~accepted
        cur = chosen
    return Verdict(acc, torch.stack(slots, 1), torch.stack(tokens, 1),
                   S.categorical_from_probs(g, r), cur)


# ---------------------------------------------------------------------------
# fused-stats acceptance: the same rules, fed by the kernel epilogue's
# Verdict-sized statistics instead of the [B, T, V] logits tensor
# ---------------------------------------------------------------------------

class VerifyStats(NamedTuple):
    """Output of ``kernels.ops.verify_stats``: everything acceptance needs.

    ``exp(cand_w[b, t, j] - m[b, t]) / l[b, t]`` is the warped target
    probability of candidate token j under node t's row; ``argm`` is the
    per-row first-wins argmax (greedy match and the temperature-0 one-hot
    warp)."""
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


def _stats_node_probs(stats: VerifyStats, candidates, cur, t_zero):
    """Warped target probability of every candidate slot under node
    ``cur``'s row: [B, T] = exp(cand_w - m) / l, with the temperature-0
    rows overridden by the exact one-hot warp (candidate == argmax), as
    ``warp_logits`` does."""
    rows = torch.arange(candidates.shape[0], device=candidates.device)
    cw = stats.cand_w[rows, cur]                               # [B, T]
    p = torch.exp(cw - stats.m[rows, cur, None]) / stats.l[rows, cur, None]
    hard = (candidates == stats.argm[rows, cur, None]).to(p.dtype)
    return torch.where(t_zero[:, None], hard, p)


def _stats_row_dist(row_logits, m_sel, l_sel, tmax, t_zero, argm_sel):
    """The full warped target distribution of one node row from its raw
    logits plus the kernel's m/l statistics: elementwise the same ops as
    ``softmax(warp_logits(row))`` for an untruncated warp."""
    Vc = row_logits.shape[-1]
    wv = row_logits.float() / tmax[:, None]
    p = torch.exp(wv - m_sel[:, None]) / l_sel[:, None]
    hard = (torch.arange(Vc, device=row_logits.device)[None, :]
            == argm_sel[:, None]).to(p.dtype)
    return torch.where(t_zero[:, None], hard, p)


def sample_verify_tree_stats(candidates, stats: VerifyStats, mprob,
                             dtree: DeviceTree, u, g, row_logits_fn,
                             temperature=1.0) -> Verdict:
    """``sample_verify_tree`` fed by the fused kernel's statistics.

    The multi-round residual walk survives fusion because each round's
    residual is the node's warped target distribution with this round's
    rejected tokens removed: a state fully described by (node, rejected
    tokens, removed mass), which needs no [B, V] row until the final draw.
    Decisions use the scalar form r(x) = p(x)·[x not rejected] / (1 - sum
    of removed mass); the first sibling of every round divides by exactly
    1.0, so it is bit-identical to the unfused walk, and later siblings
    agree to ~1 ulp (the unfused walk renormalises the full row by its
    float sum).  The final residual is rebuilt from ONE row unembed
    (``row_logits_fn(cur)`` -> [B, V] raw logits at the stopping node) by
    replaying this round's rejections with the same zero-and-renormalise
    ops, then drawn with the same noise ``g``, so the draws match the
    unfused walk.  ``u``/``g`` as ``sample_verify_tree``.  Requires an
    untruncated warp (top_k 0, top_p 1.0; the engine refuses the rest).
    """
    B, T = candidates.shape
    dev = candidates.device
    rows = torch.arange(B, device=dev)
    t_arr = S.per_row(temperature, B, dev)
    t_zero = t_arr <= 0.0
    tmax = torch.clamp(t_arr, min=1e-6)
    qnode = _node_q(mprob, dtree, B, dev)
    col = torch.arange(dtree.Cmax, device=dev)

    cur = torch.zeros((B,), dtype=torch.int64, device=dev)
    stopped = torch.zeros((B,), dtype=torch.bool, device=dev)
    denom = torch.ones((B,), dtype=torch.float32, device=dev)  # p-units
    rej = torch.full((B, dtree.Cmax), -1, dtype=torch.int32,
                     device=dev)                     # this round's removals
    acc = torch.ones((B,), dtype=torch.int32, device=dev)
    slots, tokens = [cur], [candidates[:, 0]]
    for d in range(1, dtree.K + 1):
        tab = _sibling_order(cur, qnode, dtree, rows)
        pnode = _stats_node_probs(stats, candidates, cur, t_zero)  # [B, T]
        accepted = torch.zeros((B,), dtype=torch.bool, device=dev)
        chosen = cur
        for j in range(dtree.Cmax):
            ch = tab[:, j]
            valid = (ch >= 0) & ~stopped & ~accepted
            chc = ch.clamp(min=0)
            x = candidates[rows, chc]
            # a token zeroed earlier this round has no residual mass left
            already = torch.any(rej == x[:, None], dim=1)
            pm = torch.where(already, 0.0, pnode[rows, chc])
            take = valid & (u[:, d - 1, j] < pm / denom)
            rejected = valid & ~take
            # mirror the unfused fallback: if removing x leaves ~no mass,
            # keep the residual (and x's mass) unchanged
            do_remove = rejected & ((denom - pm) / denom > 1e-9)
            denom = torch.where(do_remove, denom - pm, denom)
            rej = torch.where((col == j)[None, :] & do_remove[:, None],
                              x[:, None], rej)
            chosen = torch.where(take, ch, chosen)
            accepted = accepted | take
        # accepted rows descend: the residual resets to the new node's
        # target distribution
        denom = torch.where(accepted, 1.0, denom)
        rej = torch.where(accepted[:, None], -1, rej)
        acc = acc + accepted.to(torch.int32)
        slots.append(chosen)
        tokens.append(candidates[rows, chosen])
        stopped = stopped | ~accepted
        cur = chosen

    # one [B, V] row rebuild + rejection replay, then the shared draw
    r = _stats_row_dist(row_logits_fn(cur), stats.m[rows, cur],
                        stats.l[rows, cur], tmax, t_zero,
                        stats.argm[rows, cur])
    for j in range(dtree.Cmax):
        x = rej[:, j].long()
        r = torch.where((x >= 0)[:, None], _remove_token(r, x.clamp(min=0)),
                        r)
    return Verdict(acc, torch.stack(slots, 1), torch.stack(tokens, 1),
                   S.categorical_from_probs(g, r), cur)


def sample_verify_chain_stats(candidates, stats: VerifyStats, draft_logits,
                              dtree: DeviceTree, u, g, row_logits_fn,
                              temperature=1.0, top_k: int = 0,
                              top_p=1.0) -> Verdict:
    """``sample_verify_chain`` fed by the fused kernel's statistics.

    The chain test u·q(x) < p(x) needs p only at the drafted tokens,
    ``exp(cand_w - m) / l`` along the diagonal band (the one-hot warp at
    temperature 0), and one full row (``row_logits_fn(last)`` -> [B, V] raw
    logits at the last accepted node) for the residual or bonus draw.  The
    draft side q is the draft's own logits, warped as in the unfused rule.
    ``u``/``g`` as ``sample_verify_chain``.  Requires an untruncated
    target warp (top_k 0, top_p 1.0; the engine refuses the rest)."""
    B, T = candidates.shape
    gamma = T - 1
    dev = candidates.device
    rows = torch.arange(B, device=dev)
    t_arr = S.per_row(temperature, B, dev)
    t_zero = t_arr <= 0.0
    tmax = torch.clamp(t_arr, min=1e-6)
    q = S.warp_probs(draft_logits, temperature, top_k, top_p)  # [B, g, V]
    x = candidates[:, 1:]                                      # [B, g]
    node = torch.arange(gamma, device=dev)
    cw = stats.cand_w[:, node, node + 1]                       # [B, g]
    px = torch.exp(cw - stats.m[:, :gamma]) / stats.l[:, :gamma]
    hard = (x == stats.argm[:, :gamma]).to(px.dtype)
    px = torch.where(t_zero[:, None], hard, px)
    qx = torch.gather(q, -1, x.long()[..., None])[..., 0]

    def p_last(last):
        return _stats_row_dist(row_logits_fn(last), stats.m[rows, last],
                               stats.l[rows, last], tmax, t_zero,
                               stats.argm[rows, last])

    return _chain_verdict(candidates, u * qx < px, dtree, p_last, q, g)
