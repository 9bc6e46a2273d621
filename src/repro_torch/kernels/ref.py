"""Plain PyTorch oracle for the tree-attention decode step (counterpart of
``repro.kernels.ref``).

Semantics: query node t attends to (a) every committed cache slot
s < lengths[b] and (b) tree slots [lengths[b], lengths[b]+T) visible under
``tree_mask`` — exactly ``layers.decode_mask``.  The int8 and paged
oracles dequantize and gather the whole cache up front and reuse the fp
oracle; the kernels, which dequantize per tile and follow the table
inside the sweep, must agree with them.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import paging as P
from repro_torch.kernels import quant as Q
from repro_torch.models.layers import NEG_INF


def decode_mask_ref(tree_mask, lengths, S_max: int):
    """tree_mask [T, T] bool, lengths [B] int -> visibility [B, T, S_max]
    bool: committed past (s < length) plus the tree block under its mask."""
    T = tree_mask.shape[0]
    B = lengths.shape[0]
    s_idx = torch.arange(S_max, device=tree_mask.device)
    past = (s_idx[None, :] < lengths[:, None])[:, None, :].expand(B, T, S_max)
    tree_full = torch.zeros((B, T, S_max), dtype=torch.bool,
                            device=tree_mask.device)
    for b, length in enumerate(lengths.tolist()):
        # the reference's dynamic_update_slice clamps the start so the
        # [T, T] block stays inside the row
        start = min(max(length, 0), S_max - T)
        tree_full[b, :, start:start + T] = tree_mask
    return past | tree_full


def tree_attention_ref(q, k, v, tree_mask, lengths, scale):
    """q [B, T, Hq, D] f32/bf16; k/v [B, S, Hkv, D] fp with tree rows already
    written at [lengths, lengths+T); lengths [B] int.
    Returns [B, T, Hq, D] in q.dtype."""
    B, T, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    mask = decode_mask_ref(tree_mask, lengths, S)          # [B, T, S]
    qg = q.reshape(B, T, Hkv, G, D)
    scores = torch.einsum("bthgd,bshd->bhgts", qg,
                          k.to(q.dtype)).float() * scale
    scores = torch.where(mask[:, None, None], scores,
                         torch.tensor(NEG_INF, device=scores.device))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhgts,bshd->bthgd", probs, v.to(q.dtype))
    return out.reshape(B, T, Hq, D)


def tree_attention_ref_int8(q, k, v, k_scale, v_scale, tree_mask, lengths,
                            scale):
    """Int8-cache oracle: k/v [B, S, Hkv, D] int8 with k_scale/v_scale
    [B, S, Hkv, 1] f32; other arguments as ``tree_attention_ref``."""
    return tree_attention_ref(q, Q.dequantize(k, k_scale, q.dtype),
                              Q.dequantize(v, v_scale, q.dtype),
                              tree_mask, lengths, scale)


def tree_attention_ref_paged(q, k, v, block_tables, tree_mask, lengths,
                             scale, k_scale=None, v_scale=None):
    """Paged-cache oracle: pool-form k/v [n_blocks, page_size, Hkv, D]
    (int8 with k_scale/v_scale pools [n_blocks, page_size, Hkv, 1] f32)
    and ``block_tables`` [B, max_blocks] int32.  Gathers the dense view
    and reuses the dense oracles."""
    kd, vd = P.gather_cache(k, block_tables), P.gather_cache(v, block_tables)
    if k_scale is not None:
        return tree_attention_ref_int8(
            q, kd, vd, P.gather_cache(k_scale, block_tables),
            P.gather_cache(v_scale, block_tables), tree_mask, lengths, scale)
    return tree_attention_ref(q, kd, vd, tree_mask, lengths, scale)


def verify_stats_ref(hidden, w, candidates, tmax):
    """Oracle for the fused verify epilogue (counterpart of
    ``repro.kernels.ref.verify_stats_ref``).

    Materialises the warped logits [B, T, V] (exactly what the kernel
    avoids) and reduces them to the kernel's statistics: argm [B, T] int32
    first-wins argmax, m/l [B, T] f32 softmax statistics of the warped row,
    cand_w [B, T, T] f32 warped logits at the candidate tokens."""
    logits = torch.matmul(hidden, w.to(hidden.dtype)).float()
    wv = logits / tmax[:, None, None]
    argm = torch.argmax(wv, dim=-1).to(torch.int32)
    m = torch.amax(wv, dim=-1)
    l = torch.sum(torch.exp(wv - m[..., None]), dim=-1)
    T = candidates.shape[1]
    idx = candidates.long()[:, None, :].expand(-1, T, -1)
    cand_w = torch.gather(wv, 2, idx)
    return argm, m, l, cand_w
