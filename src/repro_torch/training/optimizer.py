"""AdamW, global-norm clipping and the warmup + cosine schedule in PyTorch
(counterpart of ``repro.training.optimizer``; no ``torch.optim``).

Parameters, gradients and moments are nested dicts of tensors with the
parameters' names.  The reference's functions are pure and return new
trees; these update the tensors they are given in place and return them
(``adamw_update``: the parameters and the moments; ``clip_by_global_norm``:
the gradients), so a step never holds two copies of the weights or of the
moments: at full width the Medusa heads are 2.5 B parameters, 10 GB in
float32 a copy.  For the same reason the update runs over each leaf in
pieces of ``PIECE`` elements.  The arithmetic is the reference's, op for
op, with its dtype promotions: the moments stay in the parameter's dtype,
and the step's bias corrections are float32.  ``compressed_psum`` is
the data-parallel int8 gradient all-reduce, over the ranks of a named
axis (``distributed.collectives``).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.distributed import collectives as C

PIECE = 1 << 24          # elements of a leaf updated at once


class AdamWState(NamedTuple):
    step: torch.Tensor   # () int32 on the parameters' device
    mu: dict             # first moments, the parameters' tree and dtypes
    nu: dict             # second moments


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts (``rest`` of the same
    nesting), keeping the nesting."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in tree for x in tree_leaves(tree[k])]
    return [tree]


def adamw_init(params) -> AdamWState:
    """Zero moments like ``params``.  ``zeros_like`` of a pitched lm head
    (a [d, V] view of a wider allocation, ``pitch_lm_head``) is a
    contiguous [d, V]: the moments need no pitch, since only the head
    itself reaches the verify kernel; ``adamw_update`` writes every leaf
    in place, so the head keeps its pitch across steps."""
    dev = tree_leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      mu=tree_map(torch.zeros_like, params),
                      nu=tree_map(torch.zeros_like, params))


def _pieces(*ts):
    """Matching views of the same-shaped tensors ``ts`` (any strides), each
    of at most ``PIECE`` elements: blocks of rows of the leading axis
    (writes land in the tensors)."""
    t0 = ts[0]
    if t0.numel() <= PIECE:
        yield ts
        return
    row = t0.numel() // t0.shape[0]
    if row > PIECE:
        for i in range(t0.shape[0]):
            yield from _pieces(*(t[i] for t in ts))
        return
    rows = PIECE // row
    for s in range(0, t0.shape[0], rows):
        yield tuple(t[s:s + rows] for t in ts)


@torch.no_grad()
def adamw_update(grads, state: AdamWState, params, *, lr, b1=0.9, b2=0.999,
                 eps=1e-8, weight_decay=0.0, decay_mask=None):
    """One AdamW step, in place.  Returns (params, AdamWState): the same
    parameter and moment tensors, updated, and the new step.  ``lr`` is a
    float or a schedule ``lr(step)``; ``decay_mask`` (the parameters' tree
    of bools) turns weight decay off where False."""
    step = state.step + 1
    lr_t = lr(step) if callable(lr) else lr
    # float32 bias corrections; the reference's 0-dim float32 promotes a
    # bf16 moment to float32 in the division, so the moments are read
    # as float32 below
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()
    mask = decay_mask if decay_mask is not None else tree_map(
        lambda _: True, params)

    def upd(p, g, m, v, wd_on):
        for pp, gg, mm, vv in _pieces(p, g, m, v):
            mm.copy_(b1 * mm + (1 - b1) * gg)
            vv.copy_(b2 * vv + (1 - b2) * torch.square(gg))
            u = (mm.float() / bc1) / (torch.sqrt(vv.float() / bc2) + eps)
            if weight_decay and wd_on:
                u = u + weight_decay * pp
            pp.copy_((pp - lr_t * u).to(pp.dtype))

    tree_map(upd, params, grads, state.mu, state.nu, mask)
    return params, AdamWState(step=step, mu=state.mu, nu=state.nu)


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    """Scale every gradient in place by min(1, max_norm / global norm).
    Returns (grads, the global norm before clipping, float32 0-dim)."""
    leaves = tree_leaves(grads)
    norms = torch.stack([torch.linalg.vector_norm(g, dtype=torch.float32)
                         for g in leaves])
    gn = torch.sqrt(torch.sum(torch.square(norms)))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    for g in leaves:
        g.mul_(scale)
    return grads, gn


def warmup_cosine(base_lr: float, warmup: int, total: int, floor: float = 0.1):
    """-> sched(step) (an int or a tensor) -> learning rate, float32: linear
    warmup to ``base_lr``, then a cosine to ``floor * base_lr`` at
    ``total``."""
    def sched(step):
        step = torch.as_tensor(step).float()
        warm = base_lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = base_lr * (floor + (1 - floor) * 0.5
                         * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup, warm, cos)
    return sched


# ---------------------------------------------------------------------------
# int8 gradient-compression all-reduce (on the ranks of a data axis)
# ---------------------------------------------------------------------------

def compressed_psum(grads, axis_name: str):
    """All-reduce ``grads`` over ``axis_name`` as int8 with one shared
    scale a leaf, the reference's arithmetic: scale = pmax(max |g|) / 127
    (at least 1e-12 / 127), values rounded half to even, clipped to ±127,
    summed in int32 and dequantized, in the leaf's dtype.  About 4x less
    traffic than the float32 sum; each rank's error is at most scale / 2.
    The leaves' maxima go in one all-reduce, each leaf's int32 payload in
    one of its own.  Returns a new tree."""
    leaves = tree_leaves(grads)
    if not leaves:
        return grads
    gmax = C.pmax(torch.stack([torch.amax(torch.abs(g.float()))
                               for g in leaves]), axis_name)
    # a 0-dim tensor divisor: true division (a Python scalar may become a
    # multiplication by its reciprocal)
    scales = iter(torch.clamp(gmax, min=1e-12) / torch.full(
        (), 127.0, dtype=torch.float32, device=gmax.device))

    def one(g):
        scale = next(scales)
        q = torch.clamp(torch.round(g.float() / scale), -127, 127)
        total = C.psum_(q.to(torch.int8).to(torch.int32), axis_name)
        return (total.float() * scale).to(g.dtype)
    return tree_map(one, grads)
