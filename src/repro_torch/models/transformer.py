"""Decoder-only stack in PyTorch, dense family: init, prefill, the static
speculative decode step and the zero-copy commit.

Counterpart of ``repro.models.transformer``.  Parameters keep the
reference tree: ``params["units"]["pos0"]`` holds every layer's weights
stacked on a leading ``n_units`` axis, and the cache is
``{"pos0": {"k", "v": [n_units, B, S, Hkv, D]}}``, with the reference's
two other layouts: int8 values plus ``k_scale``/``v_scale``
[n_units, B, S, Hkv, 1] f32 (``cfg.cache_dtype == "int8"``), and the
paged pool [n_units, n_blocks, page_size, Hkv, D] with the block table
under ``cache["_pages"]["table"]`` (``cfg.cache_layout == "paged"``).
Where the reference scans over units, this module runs a host loop over
them.

Unlike the reference's pure functions, ``prefill``, ``decode`` and
``commit`` write the cache tensors in place (indexed writes of the rows
that change), so one step never copies the cache.  The caller's cache
dict is therefore updated by these calls, and the dict they return holds
the same tensors.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import paging as P
from repro_torch.kernels import quant as Q
from repro_torch.kernels.cache_update import (commit_rows_paged_stacked,
                                              commit_rows_stacked,
                                              fused_qkv_rope_commit)
# the decode step's in-place tree-row write (the reference's _update_rows)
from repro_torch.kernels.cache_update import commit_rows_plain as _update_rows
from repro_torch.kernels.ops import tree_attention
from repro_torch.models import layers as L
from repro_torch.runtime import resolve_device, torch_dtype

# cache-dict key holding the paged layout's block table; it is not a layer
# entry (no leading n_units axis), so every walk over the layers splits it
# off first
PAGES_KEY = "_pages"


def split_pages(cache):
    """(layer_entries, pages_or_None).  ``pages`` is ``{"table":
    [B, max_blocks] int32}`` under the paged layout, None under dense."""
    if PAGES_KEY in cache:
        return {k: v for k, v in cache.items() if k != PAGES_KEY}, \
            cache[PAGES_KEY]
    return cache, None


# ---------------------------------------------------------------------------
# structure
# ---------------------------------------------------------------------------

def unit_structure(cfg: ModelConfig):
    """[(mixer_kind, ffn_kind)] for each position inside the repeating
    unit: one attention layer with a dense MLP for the dense family."""
    check_supported(cfg)
    return [("attn", "dense")]


def n_units(cfg: ModelConfig) -> int:
    return cfg.num_layers // len(unit_structure(cfg))


def check_supported(cfg: ModelConfig):
    """Raise NotImplementedError, naming the later slice, for every branch
    of the reference that the port does not carry yet."""
    later = []
    if cfg.family != "dense":
        later.append(f"family {cfg.family!r} (ROADMAP queue 1 item 14)")
    if cfg.tp_axis:
        later.append("tensor parallelism (ROADMAP queue 1 item 16)")
    if cfg.frontend or cfg.num_experts or cfg.tie_embeddings:
        later.append("frontends, MoE and tied embeddings (ROADMAP queue 1 "
                     "item 14)")
    if later:
        raise NotImplementedError(f"{cfg.name}: " + "; ".join(later))


def unit_params(params, u: int):
    """Views of unit ``u``'s weights from the stacked ``params["units"]``."""
    def pick(tree):
        return {k: pick(v) if isinstance(v, dict) else v[u]
                for k, v in tree.items()}
    return pick(params["units"])


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_params(gen: torch.Generator, cfg: ModelConfig, dtype=None):
    """Full model params on ``gen.device``, drawn from ``gen``.  Shapes and
    init scales follow the reference; the random bits do not (tests carry
    the reference's weights across with ``bridge.to_torch`` instead)."""
    if dtype is not None:
        cfg = dataclasses.replace(cfg, param_dtype=dtype)
    nu = n_units(cfg)
    dt = torch_dtype(cfg.param_dtype)
    dev = gen.device
    params = {
        "embed": L.dense_init(gen, (cfg.vocab_size, cfg.d_model), dt,
                              scale=0.02),
        "units": {"pos0": {"norm1": L.init_norm(cfg, dev, stack=nu),
                           "attn": L.init_attention(gen, cfg, stack=nu),
                           "norm2": L.init_norm(cfg, dev, stack=nu),
                           "ffn": L.init_mlp(gen, cfg, stack=nu)}},
        "final_norm": L.init_norm(cfg, dev),
        "lm_head": L.dense_init(gen, (cfg.d_model, cfg.vocab_size), dt),
    }
    return params


# ---------------------------------------------------------------------------
# embedding / unembedding
# ---------------------------------------------------------------------------

def embed_tokens(params, cfg: ModelConfig, tokens):
    return params["embed"][tokens].to(torch_dtype(cfg.dtype))


def unembed_local(params, cfg: ModelConfig, hidden):
    """Logits [..., V] (without tensor parallelism the local vocab slice is
    the whole vocabulary)."""
    return torch.matmul(hidden, params["lm_head"].to(hidden.dtype))


def unembed(params, cfg: ModelConfig, hidden):
    return unembed_local(params, cfg, hidden)


# ---------------------------------------------------------------------------
# cache
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, device="cuda",
               n_blocks=None):
    """Zeroed decode cache on ``device`` (the card unless the caller asks
    for ``"cpu"``), in ``cfg.resolved_cache_dtype``.

    Dense: ``{"pos0": {"k", "v": [nu, B, S, Hkv, D]}}``.  int8 adds
    ``k_scale``/``v_scale`` [nu, B, S, Hkv, 1] f32.  Paged
    (``cfg.cache_layout == "paged"``): the leaves become pools
    [nu, n_blocks, page_size, Hkv, D] (scales [nu, n_blocks, page_size,
    Hkv, 1]) and ``"_pages": {"table": [B, max_blocks] int32}`` holds the
    one table of every layer, max_blocks = ceil(max_len / page_size).
    With ``n_blocks=None`` the pool is sized for the identity table (one
    contiguous run of blocks per slot after trash block 0); an explicit
    ``n_blocks`` starts with all-zero tables for an allocator to fill.
    """
    device = resolve_device(device)
    dt = torch_dtype(cfg.resolved_cache_dtype)
    nu, hkv, hd = n_units(cfg), cfg.num_kv_heads, cfg.resolved_head_dim
    cache = {}
    if cfg.paged:
        ps = cfg.page_size
        mb = P.blocks_for(max_len, ps)
        nb = (1 + batch * mb) if n_blocks is None else int(n_blocks)
        lead = (nu, nb, ps)
        if n_blocks is None:
            table = P.identity_table(batch, mb, device=device)
        else:
            table = torch.zeros((batch, mb), dtype=torch.int32, device=device)
        cache[PAGES_KEY] = {"table": table}
    else:
        lead = (nu, batch, max_len)
    entry = {"k": torch.zeros(lead + (hkv, hd), dtype=dt, device=device),
             "v": torch.zeros(lead + (hkv, hd), dtype=dt, device=device)}
    if Q.is_quantized(dt):
        for name in ("k_scale", "v_scale"):
            entry[name] = torch.zeros(lead + (hkv, 1), dtype=torch.float32,
                                      device=device)
    cache["pos0"] = entry
    return cache


def cache_max_len(cache, table=None) -> int:
    """Per-slot capacity in rows.  Dense: the S axis.  Paged: the table's
    reach, max_blocks * page_size (found under ``_pages`` when not
    given)."""
    if table is None and PAGES_KEY in cache:
        table = cache[PAGES_KEY]["table"]
    per_block_or_s = cache["pos0"]["k"].shape[-3]
    if table is not None:
        return table.shape[1] * per_block_or_s
    return per_block_or_s


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------

def prefill(params, cfg: ModelConfig, tokens, lengths, cache):
    """Process right-padded prompts, fill the cache, return the last hidden
    state of each row.

    tokens [B, S_p], lengths [B] true lengths.  Writes cache rows [0, S_p)
    of every unit in place (through the block table under the paged
    layout, quantized under int8).  Returns (hidden_last [B, d], cache).
    """
    layers, pages = split_pages(cache)
    table = None if pages is None else pages["table"]
    B, S_p = tokens.shape
    if S_p > cache_max_len(cache):
        raise ValueError(f"prompt window {S_p} exceeds the cache's "
                         f"{cache_max_len(cache)} rows")
    x = embed_tokens(params, cfg, tokens)
    entry = layers["pos0"]
    phys = None
    if table is not None:
        zero = torch.zeros((B,), dtype=torch.int32, device=x.device)
        phys = P.phys_rows(table, zero, S_p, cfg.page_size).reshape(-1)
    for u in range(n_units(cfg)):
        p = unit_params(params, u)["pos0"]
        hh = L.apply_norm(p["norm1"], x, cfg)
        y, (k, v) = L.attention_full(p["attn"], hh, cfg, return_kv=True)
        _write_prefix({n: t[u] for n, t in entry.items()}, k, v, phys=phys)
        x = x + y
        hh = L.apply_norm(p["norm2"], x, cfg)
        x = x + L.mlp(p["ffn"], hh, cfg)
    x = L.apply_norm(params["final_norm"], x, cfg)
    rows = torch.arange(B, device=x.device)
    last = x[rows, lengths.long() - 1]
    return last, cache


def _write_prefix(entry, k, v, phys=None):
    """Prefill-time write of rows [0, S_p) into one layer's entry (views of
    one unit), in place.  k/v [B, S_p, Hkv, D] fp; quantized on the way in
    for the int8 layout (the cache never holds fp rows); scattered to the
    pools' physical rows ``phys`` [B * S_p] under the paged layout."""
    if "k_scale" in entry:
        kq, ks = Q.quantize_rows(k)
        vq, vs = Q.quantize_rows(v)
        rows = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    else:
        rows = {"k": k, "v": v}
    for name, r in rows.items():
        if phys is not None:
            P.scatter_at(entry[name], phys, r)
        else:
            entry[name][:, :r.shape[1]] = r.to(entry[name].dtype)


def _read_cache(entry, dtype, table=None):
    """fp view of one layer's cached k/v -> ([B, S, Hkv, D], [B, S, Hkv, D])
    in ``dtype`` for the plain attention path: dequantized under int8,
    gathered from the pool first under the paged layout (S = max_blocks *
    page_size).  The kernel path never materialises it."""
    if table is not None:
        entry = {n: P.gather_cache(entry[n], table)
                 for n in ("k", "v", "k_scale", "v_scale") if n in entry}
    if "k_scale" in entry:
        return (Q.dequantize(entry["k"], entry["k_scale"], dtype),
                Q.dequantize(entry["v"], entry["v_scale"], dtype))
    return entry["k"].to(dtype), entry["v"].to(dtype)


# ---------------------------------------------------------------------------
# speculative decode step (tree / chain) + commit
# ---------------------------------------------------------------------------

def decode(params, cfg: ModelConfig, cache, tokens, lengths, tree_mask, depths,
           use_kernel: bool = False):
    """One static speculative step over T tree/chain tokens.

    tokens [B, T]; lengths [B]; tree_mask [T, T] bool; depths [T] int.
    Writes the T tree rows into the cache at [lengths, lengths+T) in place.
    Returns (hidden [B, T, d], spec_cache), where spec_cache holds the
    cache tensors (and ``_pages``) plus the in-flight rows
    ``k_new``/``v_new`` [nu, B, T, Hkv, D] that ``commit`` gathers from.
    """
    layers, pages = split_pages(cache)
    table = None if pages is None else pages["table"]
    B, T = tokens.shape
    x = embed_tokens(params, cfg, tokens)
    S_max = cache_max_len(cache)
    masks = phys = None
    if not use_kernel:
        masks = L.decode_mask(tree_mask, lengths, T, S_max)       # [B, T, S]
    entry = layers["pos0"]
    if table is not None and not _fused_write(cfg, entry, use_kernel):
        phys = P.phys_rows(table, lengths, T, cfg.page_size).reshape(-1)
    k_new, v_new = [], []
    for u in range(n_units(cfg)):
        p = unit_params(params, u)["pos0"]
        hh = L.apply_norm(p["norm1"], x, cfg)
        y, rows = attention_decode_batched(
            p["attn"], hh, cfg, {n: t[u] for n, t in entry.items()}, lengths,
            masks, tree_mask, depths, use_kernel, table=table, phys=phys)
        k_new.append(rows["k_new"])
        v_new.append(rows["v_new"])
        x = x + y
        hh = L.apply_norm(p["norm2"], x, cfg)
        x = x + L.mlp(p["ffn"], hh, cfg)
    x = L.apply_norm(params["final_norm"], x, cfg)
    spec_cache = {"pos0": dict(entry, k_new=torch.stack(k_new),
                               v_new=torch.stack(v_new))}
    if pages is not None:
        spec_cache[PAGES_KEY] = pages
    return x, spec_cache


def _fused_write(cfg, entry, use_kernel) -> bool:
    """Whether the decode step's write side is one ``fused_qkv_rope_commit``
    launch: on the kernel path with verify fusion, on an fp cache (K3 is
    fp-only; the int8 cache keeps the unfused write side)."""
    return use_kernel and cfg.verify_fusion and "k_scale" not in entry


def attention_decode_batched(p, x, cfg, entry, lengths, masks, tree_mask,
                             depths, use_kernel=False, table=None, phys=None):
    """Tree-decode attention of one layer with per-row lengths.

    ``entry`` holds that layer's cache k/v [B, S, Hkv, D] (plus
    k_scale/v_scale [B, S, Hkv, 1] under int8), or pools
    [n_blocks, page_size, Hkv, D] with ``table`` [B, max_blocks] under the
    paged layout; the T tree rows are written into it in place (to the
    pools' physical rows ``phys`` [B * T], which ``decode`` computes once
    for every layer).  With
    ``use_kernel`` the attention runs through ``kernels.ops.tree_attention``
    (the ``flash_decode`` kernel on the card); otherwise through the masked
    plain attention with ``masks`` [B, T, S].  With ``use_kernel`` and
    ``cfg.verify_fusion`` on an fp cache the write side (q/k/v projection,
    RoPE and the tree-row write) is one ``fused_qkv_rope_commit`` launch,
    as in the reference; the int8 cache keeps the unfused write side.
    Under int8 the in-flight rows are fake-quantized (quantize, then
    dequantize), so verification attends over exactly the values every
    later sweep reads back from the cache.  Returns (y [B, T, d],
    {"k_new", "v_new": [B, T, Hkv, D]}), the in-flight tree rows.
    """
    hd = cfg.resolved_head_dim
    scale = 1.0 / math.sqrt(hd)
    cos = sin = None
    if cfg.use_rope:
        positions = lengths[:, None] + depths[None, :]
        cos, sin = L.rope_cos_sin(positions, hd, cfg.rope_theta)
    if _fused_write(cfg, entry, use_kernel):
        q, k, v = fused_qkv_rope_commit(x, p, lengths, entry["k"], entry["v"],
                                        cos=cos, sin=sin, table=table)
    else:
        q, k, v = L._project_qkv(p, x, cfg)
        if cfg.use_rope:
            q = L.apply_rope(q, cos[:, :, None, :], sin[:, :, None, :])
            k = L.apply_rope(k, cos[:, :, None, :], sin[:, :, None, :])
        rows = {"k": k, "v": v}
        if "k_scale" in entry:
            kq, ks = Q.quantize_rows(k)
            vq, vs = Q.quantize_rows(v)
            k, v = Q.dequantize(kq, ks, k.dtype), Q.dequantize(vq, vs, v.dtype)
            rows = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
        for name, r in rows.items():
            if table is not None:
                P.scatter_at(entry[name], phys, r)
            else:
                _update_rows(entry[name], r, lengths)
    if use_kernel:
        out = tree_attention(q, entry["k"], entry["v"], tree_mask, lengths,
                             scale, k_scale=entry.get("k_scale"),
                             v_scale=entry.get("v_scale"), k_tree=k,
                             v_tree=v, block_tables=table)
    else:
        ck, cv = _read_cache(entry, q.dtype, table=table)
        out = L._gqa_scores_to_out(q, ck, cv, masks, scale)
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype))
    return y, {"k_new": k, "v_new": v}


def _commit_attn_entry(entry, lengths, path_slots, table=None):
    """Commit one attention layer: gather the best path's rows from the
    small in-flight tensors and write them at [len, len+K1) of every unit,
    in place, with one ``commit_rows_stacked`` (dense) or
    ``commit_rows_paged_stacked`` (paged, through ``table``) launch per
    cache leaf on the card (their plain versions on the CPU).  Under int8
    the gathered rows are re-quantized: quantization is deterministic and
    idempotent on fake-quantized values, so the committed bytes are the
    values verification attended over.  entry: k/v [nu, B, S, Hkv, D] (or
    pools) + k_new/v_new [nu, B, T, Hkv, D] (+ scales); path_slots
    [B, K1]."""
    B = path_slots.shape[0]
    rows = torch.arange(B, device=path_slots.device)[:, None]
    out = {}
    for name in ("k", "v"):
        picked = entry[name + "_new"][:, rows, path_slots.long()]  # [nu,B,K1,H,D]
        leaves = {name: picked}
        if name + "_scale" in entry:
            qrows, srows = Q.quantize_rows(picked)
            leaves = {name: qrows, name + "_scale": srows}
        for leaf, r in leaves.items():
            if table is not None:
                commit_rows_paged_stacked(entry[leaf], table, r, lengths)
            else:
                commit_rows_stacked(entry[leaf], r, lengths)
            out[leaf] = entry[leaf]
    return out


def commit(cfg: ModelConfig, spec_cache, lengths, path_slots, acc):
    """Zero-copy compaction: keep exactly the accepted prefix.

    path_slots [B, K+1]: tree-node slots of the best path (0..T-1); acc [B]
    in [1, K+1].  Writes the best path's KV rows at [len, len+K+1) in place
    (rows past ``acc`` are dead and are overwritten later).  Returns
    (cache, lengths + acc); the cache keeps ``_pages``.
    """
    layers, pages = split_pages(spec_cache)
    table = None if pages is None else pages["table"]
    cache = {"pos0": _commit_attn_entry(layers["pos0"], lengths, path_slots,
                                        table=table)}
    if pages is not None:
        cache[PAGES_KEY] = pages
    return cache, lengths + acc
