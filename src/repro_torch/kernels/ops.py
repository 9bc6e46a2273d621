"""Wrappers around the port's kernels (counterpart of
``repro.kernels.ops``).

``tree_attention``: full tree-attention semantics = (cache sweep via the
``flash_decode`` kernel) ⊕ (tiny tree block) merged exactly through the
partial-softmax statistics, over either cache dtype (fp, or int8 with
per-head-per-row scales) and either layout (dense rows, or the paged pool
addressed through per-slot block tables).  The fold, the tree block and
the merge are the plain PyTorch ops the reference runs in ``jnp`` outside
its kernel.

``verify_stats``: the fused unembed + verification statistics of the
``unembed_verify_stats`` kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import quant as Q
from repro_torch.kernels.tree_attention import (flash_decode,
                                                unembed_verify_stats)
from repro_torch.models.layers import NEG_INF


def verify_stats(hidden, w, candidates, tmax):
    """Fused unembed + verify-statistics epilogue.

    hidden [B, T, d]; w [d, V] lm-head weight (cast to hidden's dtype like
    ``models.transformer.unembed``); candidates [B, T] int32; tmax [B] f32
    warp temperatures.  Returns (argm, m, l, cand_w): see
    ``kernels.tree_attention.unembed_verify_stats``."""
    return unembed_verify_stats(hidden, w, candidates, tmax)


def tree_attention(q, k, v, tree_mask, lengths, scale, *, k_scale=None,
                   v_scale=None, k_tree=None, v_tree=None,
                   block_tables=None):
    """Tree-decode attention over a committed cache plus T in-flight rows.

    q [B, T, Hq, D] f32/bf16; k/v [B, S, Hkv, D] with the tree rows
    already written at [lengths, lengths+T): fp, or int8 with
    ``k_scale``/``v_scale`` [B, S, Hkv, 1] f32.  tree_mask [T, T] bool;
    lengths [B] int32.  Pass ``k_tree``/``v_tree`` [B, T, Hkv, D] (the
    in-flight tree rows, fake-quantized by the caller under int8) to skip
    gathering them from the cache.  Paged cache: pass ``block_tables``
    [B, max_blocks] int32 with pool-form k/v [n_blocks, page_size, Hkv, D]
    (scales [n_blocks, page_size, Hkv, 1]); ``k_tree``/``v_tree`` are then
    required, as in the reference.  Returns [B, T, Hq, D] in q.dtype.
    """
    B, T, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    if block_tables is not None and k_tree is None:
        raise ValueError("paged tree_attention requires k_tree/v_tree")
    lengths = lengths.to(torch.int32)

    # fold q: [B,T,Hq,D] -> [B,Hkv,R,D], row r = g*T_pad + t (T padded so
    # R is a multiple of 8, as in the reference)
    T_pad = T
    while (G * T_pad) % 8:
        T_pad += 1
    qp = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, T_pad - T))
    qf = qp.reshape(B, T_pad, Hkv, G, D).permute(0, 2, 3, 1, 4)
    qf = qf.reshape(B, Hkv, G * T_pad, D) * torch.tensor(scale, dtype=q.dtype)

    acc1, m1, l1 = flash_decode(qf, k, v, lengths, k_scale=k_scale,
                                v_scale=v_scale,
                                block_tables=block_tables)  # [B,Hkv,R,D] f32

    # --- tree block (tiny) --------------------------------------------------
    if k_tree is None:
        idx = lengths[:, None].long() + torch.arange(T, device=q.device)
        rows = torch.arange(B, device=q.device)[:, None]
        k_tree, v_tree = k[rows, idx], v[rows, idx]         # [B,T,Hkv,D]
        if k_scale is not None:
            k_tree = Q.dequantize(k_tree, k_scale[rows, idx], q.dtype)
            v_tree = Q.dequantize(v_tree, v_scale[rows, idx], q.dtype)
    scores2 = torch.einsum("bhrd,bthd->bhrt", qf,
                           k_tree.to(qf.dtype)).float()
    # row r sees tree col t' iff tree_mask[r % T_pad, t'] (pad rows: none)
    row_mask = torch.zeros((T_pad, T), dtype=torch.bool, device=q.device)
    row_mask[:T] = tree_mask
    row_mask = row_mask.repeat(G, 1)                        # [R, T]
    neg = torch.tensor(NEG_INF, dtype=torch.float32, device=q.device)
    scores2 = torch.where(row_mask, scores2, neg)
    m2 = torch.clamp(torch.amax(scores2, dim=-1, keepdim=True), min=NEG_INF)
    p2 = torch.where(row_mask, torch.exp(scores2 - m2),
                     torch.zeros((), device=q.device))
    l2 = torch.sum(p2, dim=-1, keepdim=True)
    acc2 = torch.einsum("bhrt,bthd->bhrd", p2.to(qf.dtype),
                        v_tree.to(qf.dtype)).float()

    # --- exact merge --------------------------------------------------------
    m = torch.maximum(m1, m2)
    a1, a2 = torch.exp(m1 - m), torch.exp(m2 - m)
    out = (acc1 * a1 + acc2 * a2) / torch.clamp(l1 * a1 + l2 * a2, min=1e-30)

    out = out.reshape(B, Hkv, G, T_pad, D).permute(0, 3, 1, 2, 4)
    return out[:, :T].reshape(B, T, Hq, D).to(q.dtype)
