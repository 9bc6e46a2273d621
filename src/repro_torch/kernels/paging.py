"""Paged KV-cache primitives (the port's copy of ``repro.kernels.paging``).

All slots draw fixed-size blocks from one pool:

  * pool  ``k``/``v``  [n_blocks, page_size, Hkv, D]  (per layer, any dtype)
  * table              [B, max_blocks] int32          (shared by all layers)

``table[b, j]`` is the physical block that holds slot ``b``'s logical rows
``[j * page_size, (j + 1) * page_size)``.  One block id addresses the same
index in every layer's pool and in the int8 scale pools.

Block 0 is the reserved trash block: never allocated, mapped by every
empty table entry, and the target of any write past a slot's table.  Its
contents are never read for a committed position (the ``col < length``
masks exclude it), and several dead writes may land on one of its rows in
one launch, so its contents depend on their order.

The scatters write the pool in place (the reference returns a new pool),
as the port's dense ``_update_rows`` does.
"""
from __future__ import annotations

import torch

TRASH_BLOCK = 0  # physical block 0: reserved write sink, never allocated


def blocks_for(n_tokens: int, page_size: int) -> int:
    """Physical blocks needed to hold ``n_tokens`` logical rows."""
    return -(-int(n_tokens) // page_size)


def identity_table(batch: int, max_blocks: int, device="cpu"):
    """The allocator-free table: slot ``b`` owns the contiguous blocks
    ``[1 + b * max_blocks, 1 + (b + 1) * max_blocks)`` (block 0 skipped).
    [batch, max_blocks] int32 on ``device``."""
    base = 1 + torch.arange(batch, dtype=torch.int32,
                            device=device)[:, None] * max_blocks
    return base + torch.arange(max_blocks, dtype=torch.int32,
                               device=device)[None, :]


def phys_rows(table, starts, T: int, page_size: int):
    """Flattened physical row ids of logical rows [starts, starts + T).

    table [B, max_blocks] int, starts [B] int -> [B, T] int64 indices into
    the pool flattened to [n_blocks * page_size].  Rows past the table's
    reach resolve to the trash block (a tensor select, no host branch)."""
    mb = table.shape[1]
    pos = starts.long()[:, None] + torch.arange(T, device=table.device)
    lb = pos // page_size
    blk = torch.gather(table.long(), 1, torch.clamp(lb, max=mb - 1))
    blk = torch.where(lb < mb, blk, torch.full_like(blk, TRASH_BLOCK))
    return blk * page_size + pos % page_size


def gather_cache(pool, table):
    """Dense view of a paged cache: pool [n_blocks, page_size, ...] and
    table [B, max_blocks] -> [B, max_blocks * page_size, ...] (a copy)."""
    out = pool[table.long()]                      # [B, mb, ps, ...]
    return out.reshape((table.shape[0], table.shape[1] * pool.shape[1])
                       + tuple(pool.shape[2:]))


def scatter_rows(pool, table, rows, starts, page_size: int):
    """Paged row write, in place: rows [B, T, ...] land at logical
    [starts, starts + T) through the table (rows past it in block 0).
    pool [n_blocks, page_size, ...] contiguous, any dtype (rows are cast).
    Returns the pool."""
    T = rows.shape[1]
    return scatter_at(pool, phys_rows(table, starts, T, page_size).reshape(-1),
                      rows)


def scatter_at(pool, phys, rows):
    """``scatter_rows`` with the physical rows given: rows [B, T, ...] land
    at ``phys`` [B * T] (``phys_rows`` flattened), so a caller that writes
    many pools through one table and one set of starts computes them
    once.  In place; returns the pool."""
    flat = pool.view((pool.shape[0] * pool.shape[1],) + tuple(pool.shape[2:]))
    flat[phys] = rows.to(pool.dtype).reshape((phys.shape[0],)
                                             + tuple(rows.shape[2:]))
    return pool


def scatter_rows_stacked(pool, table, rows, starts, page_size: int):
    """``scatter_rows`` with the units axis kept: pool
    [nu, n_blocks, page_size, ...] contiguous, rows [nu, B, T, ...], one
    table shared by every unit.  In place; returns the pool."""
    nu = pool.shape[0]
    B, T = rows.shape[1:3]
    phys = phys_rows(table, starts, T, page_size).reshape(-1)
    flat = pool.view((nu, pool.shape[1] * page_size) + tuple(pool.shape[3:]))
    flat[:, phys] = rows.to(pool.dtype).reshape((nu, B * T)
                                                + tuple(rows.shape[3:]))
    return pool
