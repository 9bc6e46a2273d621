"""Host-side block allocator and prefix cache for the paged KV layout
(the port's copy of ``repro.serving.block_pool``; numpy only).

Ownership split: the **device** owns every per-token decision (reads and
writes through the block table inside the captured step), the **host**
owns the resource policy: which physical block belongs to which request,
refcounts, prefix registration, eviction.  Block tables are small
``[B, max_blocks]`` int32 arrays mirrored on the host and copied into the
device table only when they change.

``BlockPool``: free list and per-block refcounts over ``n_blocks``
physical blocks.  Block 0 is the reserved trash block
(``kernels/paging.py``): never allocated, permanently pinned.

``PrefixCache``: a hash-chain registry of *full* prompt blocks: the key
for block ``j`` of a prompt commits to the entire prefix
``prompt[: (j+1)*page_size]``, so a lookup chain can only follow exact
prefix matches.  Each registered block holds one registry refcount, which
lets a cached prefix outlive the request that prefilled it; eviction
(LRU, childless entries first, only blocks no slot maps) hands those
refcounts back when an allocation would otherwise defer.  The registry
also keeps each block's tokens, so admission can detect a *partial*
(sub-block) match at the divergence block and reuse it by copy-on-write.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.kernels.paging import TRASH_BLOCK


class BlockPool:
    """Refcounted free-list allocator over the physical block pool.

    All state is host-side numpy/python; the device only ever sees block
    ids through the tables the scheduler pushes.
    """

    def __init__(self, n_blocks: int):
        assert n_blocks >= 2, "pool needs the trash block plus >= 1 usable"
        self.n_blocks = n_blocks
        self.ref = np.zeros((n_blocks,), np.int32)
        self.ref[TRASH_BLOCK] = 1                       # permanently pinned
        # LIFO free list, low ids first out (test determinism)
        self._free: List[int] = list(range(n_blocks - 1, TRASH_BLOCK, -1))
        # overload telemetry: how often an alloc found the pool empty —
        # each one is a deferred admission or a preemption trigger
        self.exhaustions = 0

    @property
    def available(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return self.n_blocks - 1 - len(self._free)

    def alloc(self, n: int) -> Optional[List[int]]:
        """n fresh blocks at refcount 1, or None (caller defers admission —
        allocation is all-or-nothing so a half-admitted request never holds
        blocks)."""
        if n > len(self._free):
            self.exhaustions += 1
            return None
        out = [self._free.pop() for _ in range(n)]
        self.ref[out] = 1
        return out

    def share(self, blocks) -> None:
        """Add one reference to each block (a new table row or the prefix
        registry now maps it)."""
        for b in blocks:
            assert self.ref[b] > 0, f"share of unowned block {b}"
            self.ref[b] += 1

    def free(self, blocks) -> List[int]:
        """Drop one reference per block; blocks reaching refcount 0 return
        to the free list.  Returns the physically freed ids."""
        freed = []
        for b in blocks:
            if b == TRASH_BLOCK:
                continue
            assert self.ref[b] > 0, f"free of unowned block {b}"
            self.ref[b] -= 1
            if self.ref[b] == 0:
                self._free.append(int(b))
                freed.append(int(b))
        return freed


@dataclass
class _PrefixEntry:
    block: int                       # physical block holding these rows
    tokens: Tuple[int, ...]          # the page_size tokens stored in it
    key: bytes                       # hash-chain key (full prefix bytes)
    parent: bytes                    # parent entry's key (b"" at the root)
    tick: int = 0                    # LRU clock (bumped on match/register)


class PrefixCache:
    """Hash-chain prompt-prefix registry over a ``BlockPool``.

    ``match`` and ``register`` work in units of *full* blocks; the
    divergence block may additionally match partially (leading tokens
    only), which the scheduler consumes via copy-on-write.  The registry
    holds one pool refcount per registered block.
    """

    def __init__(self, page_size: int):
        self.page_size = page_size
        self._entries: Dict[bytes, _PrefixEntry] = {}
        # children index: parent key -> child entry keys, so the divergence
        # scan is O(children of one node), not O(registry)
        self._kids: Dict[bytes, set] = {}
        self._tick = 0
        self.stats = {"hits": 0, "hit_tokens": 0, "evicted": 0}

    def _key(self, prompt: np.ndarray, n_blocks: int) -> bytes:
        return prompt[: n_blocks * self.page_size].astype(np.int32).tobytes()

    def match(self, prompt: np.ndarray):
        """Longest cached prefix of ``prompt``.

        Returns (blocks, div_block, div_tokens): ``blocks`` — physical ids
        of fully matched blocks (in chain order); ``div_block`` — a cached
        block whose leading ``div_tokens`` (< page_size) tokens extend the
        match at the divergence point, or None.  The caller maps ``blocks``
        shared (refcount bump) and CoW-copies ``div_block`` before writing.
        Never matches the final prompt token — at least one token must
        re-run so admission still produces base/head proposals."""
        ps = self.page_size
        self._tick += 1
        blocks: List[int] = []
        k = 0
        # full blocks, stopping short of the last prompt token
        while (k + 1) * ps <= len(prompt) - 1:
            e = self._entries.get(self._key(prompt, k + 1))
            if e is None:
                break
            e.tick = self._tick
            blocks.append(e.block)
            k += 1
        # divergence block: any child entry sharing >= 1 leading token (the
        # exact-continuation entry included — the full-block loop above only
        # stops on a miss or on the last-token rule, and in the latter case
        # the continuation block is the best partial candidate)
        div_block, div_tokens = None, 0
        rest = prompt[k * ps: (k + 1) * ps]
        for ck in self._kids.get(self._key(prompt, k), ()):
            e = self._entries[ck]
            t = 0
            lim = min(len(rest), ps, len(prompt) - 1 - k * ps)
            while t < lim and e.tokens[t] == rest[t]:
                t += 1
            if t > div_tokens:
                div_block, div_tokens = e.block, t
                e.tick = self._tick
        if blocks or div_tokens:
            self.stats["hits"] += 1
            self.stats["hit_tokens"] += len(blocks) * ps + div_tokens
        return blocks, div_block, div_tokens

    def register(self, prompt: np.ndarray, table_row: np.ndarray,
                 pool: BlockPool) -> None:
        """Register every full block of ``prompt`` (mapped in ``table_row``)
        under its hash chain, taking one registry refcount per newly
        registered block.  Blocks already registered (an earlier donor) are
        left as-is — the chain keys guarantee they hold identical rows."""
        ps = self.page_size
        self._tick += 1
        parent = self._key(prompt, 0)
        for j in range(len(prompt) // ps):
            key = self._key(prompt, j + 1)
            e = self._entries.get(key)
            if e is None:
                blk = int(table_row[j])
                if blk == TRASH_BLOCK:
                    break
                pool.share([blk])
                e = _PrefixEntry(
                    block=blk,
                    tokens=tuple(int(t) for t in prompt[j * ps:(j + 1) * ps]),
                    key=key, parent=parent)
                self._entries[key] = e
                self._kids.setdefault(parent, set()).add(key)
            e.tick = self._tick
            parent = key

    def evict(self, pool: BlockPool, need: int) -> int:
        """Free exactly ``need`` blocks by dropping registry references —
        LRU order, childless entries first (a chain is consumed leaf-first,
        so a dangling middle entry could never be matched), and only blocks
        no slot currently maps (refcount 1 = registry-only).

        All-or-nothing, like ``BlockPool.alloc``: the cascade is planned on
        a shadow of the children index first, and a shortfall returns 0
        with the registry untouched — repeated deferral rounds under
        overload must not strip the prefix cache for allocations that will
        fail anyway.  Returns the number of blocks physically freed
        (``need`` or 0)."""
        kids = {k: len(v) for k, v in self._kids.items()}
        live = set(self._entries)
        plan: List[bytes] = []
        while len(plan) < need:
            victims = [self._entries[k] for k in live
                       if not kids.get(k) and pool.ref[self._entries[k].block] == 1]
            if not victims:
                return 0
            e = min(victims, key=lambda x: x.tick)
            plan.append(e.key)
            live.discard(e.key)
            if e.parent in kids:
                kids[e.parent] -= 1
        for key in plan:
            e = self._entries.pop(key)
            self._kids.get(e.parent, set()).discard(key)
            self._kids.pop(key, None)
            pool.free([e.block])
            self.stats["evicted"] += 1
        return len(plan)

    def __len__(self):
        return len(self._entries)
