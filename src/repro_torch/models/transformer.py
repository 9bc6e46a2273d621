"""Decoder-only stack in PyTorch, dense family: init, prefill, the static
speculative decode step and the zero-copy commit.

Counterpart of ``repro.models.transformer``.  Parameters keep the
reference tree: ``params["units"]["pos0"]`` holds every layer's weights
stacked on a leading ``n_units`` axis, and the cache is
``{"pos0": {"k", "v": [n_units, B, S, Hkv, D]}}``.  Where the reference
scans over units, this module runs a host loop over them.

Unlike the reference's pure functions, ``prefill``, ``decode`` and
``commit`` write the cache tensors in place (advanced-index writes of the
rows that change), so one step never copies the cache.  The caller's cache
dict is therefore updated by these calls, and the dict they return holds
the same tensors.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.cache_update import fused_qkv_rope_commit
from repro_torch.kernels.ops import tree_attention
from repro_torch.models import layers as L
from repro_torch.runtime import resolve_device, torch_dtype


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
    if cfg.resolved_cache_dtype == "int8":
        later.append("the int8 KV cache (ROADMAP queue 1 item 9)")
    if cfg.paged:
        later.append("the paged KV cache (ROADMAP queue 1 item 10)")
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

def init_cache(cfg: ModelConfig, batch: int, max_len: int, device="cuda"):
    """Dense fp decode cache: ``{"pos0": {"k", "v": [nu, B, S, Hkv, D]}}``
    of zeros in ``cfg.resolved_cache_dtype`` on ``device`` (the card unless
    the caller asks for ``"cpu"``)."""
    device = resolve_device(device)
    dt = torch_dtype(cfg.resolved_cache_dtype)
    shape = (n_units(cfg), batch, max_len, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    return {"pos0": {"k": torch.zeros(shape, dtype=dt, device=device),
                     "v": torch.zeros(shape, dtype=dt, device=device)}}


def cache_max_len(cache) -> int:
    """Per-slot capacity in rows: the S axis of the dense cache."""
    return cache["pos0"]["k"].shape[-3]


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------

def prefill(params, cfg: ModelConfig, tokens, lengths, cache):
    """Process right-padded prompts, fill the cache, return the last hidden
    state of each row.

    tokens [B, S_p], lengths [B] true lengths.  Writes cache rows [0, S_p)
    of every unit in place.  Returns (hidden_last [B, d], cache).
    """
    B, S_p = tokens.shape
    if S_p > cache_max_len(cache):
        raise ValueError(f"prompt window {S_p} exceeds the cache's "
                         f"{cache_max_len(cache)} rows")
    x = embed_tokens(params, cfg, tokens)
    entry = cache["pos0"]
    for u in range(n_units(cfg)):
        p = unit_params(params, u)["pos0"]
        hh = L.apply_norm(p["norm1"], x, cfg)
        y, (k, v) = L.attention_full(p["attn"], hh, cfg, return_kv=True)
        _write_prefix(entry, u, k, v)
        x = x + y
        hh = L.apply_norm(p["norm2"], x, cfg)
        x = x + L.mlp(p["ffn"], hh, cfg)
    x = L.apply_norm(params["final_norm"], x, cfg)
    rows = torch.arange(B, device=x.device)
    last = x[rows, lengths.long() - 1]
    return last, cache


def _write_prefix(entry, u: int, k, v):
    """Prefill-time write of rows [0, S_p) into unit ``u`` of one layer's
    entry, in place.  k/v [B, S_p, Hkv, D]."""
    S_p = k.shape[1]
    entry["k"][u, :, :S_p] = k.to(entry["k"].dtype)
    entry["v"][u, :, :S_p] = v.to(entry["v"].dtype)


# ---------------------------------------------------------------------------
# speculative decode step (tree / chain) + commit
# ---------------------------------------------------------------------------

def _update_rows(cache_arr, rows, starts):
    """Per-row write, in place: cache [..., B, S, H, D] gets rows
    [..., B, T, H, D] at [starts[b], starts[b] + T).

    Rows that land at or past S are dropped, never wrapped or raised on
    (the reference's rule).  Dropping them needs no host sync: each such
    row is sent to slot ``pos - T``, which lies before ``starts[b]`` and so
    is not written by any kept row, and it writes back that slot's own
    current value.  That needs S >= T, which is checked.
    """
    B, S = cache_arr.shape[-4], cache_arr.shape[-3]
    T = rows.shape[-3]
    if S < T:
        raise ValueError(f"cache of {S} rows cannot take {T} rows per step")
    dev = cache_arr.device
    pos = starts.long()[:, None] + torch.arange(T, device=dev)   # [B, T]
    keep = pos < S
    idx = torch.where(keep, pos, pos - T)
    bidx = torch.arange(B, device=dev)[:, None].expand(B, T)
    old = cache_arr[..., bidx, idx, :, :]
    vals = torch.where(keep[:, :, None, None], rows.to(cache_arr.dtype), old)
    cache_arr[..., bidx, idx, :, :] = vals


def decode(params, cfg: ModelConfig, cache, tokens, lengths, tree_mask, depths,
           use_kernel: bool = False):
    """One static speculative step over T tree/chain tokens.

    tokens [B, T]; lengths [B]; tree_mask [T, T] bool; depths [T] int.
    Writes the T tree rows into the cache at [lengths, lengths+T) in place.
    Returns (hidden [B, T, d], spec_cache), where spec_cache holds the
    cache tensors plus the in-flight rows ``k_new``/``v_new``
    [nu, B, T, Hkv, D] that ``commit`` gathers from.
    """
    B, T = tokens.shape
    x = embed_tokens(params, cfg, tokens)
    S_max = cache_max_len(cache)
    masks = None
    if not use_kernel:
        masks = L.decode_mask(tree_mask, lengths, T, S_max)       # [B, T, S]
    entry = cache["pos0"]
    k_new, v_new = [], []
    for u in range(n_units(cfg)):
        p = unit_params(params, u)["pos0"]
        hh = L.apply_norm(p["norm1"], x, cfg)
        unit_entry = {"k": entry["k"][u], "v": entry["v"][u]}
        y, rows = attention_decode_batched(
            p["attn"], hh, cfg, unit_entry, lengths, masks, tree_mask,
            depths, use_kernel)
        k_new.append(rows["k_new"])
        v_new.append(rows["v_new"])
        x = x + y
        hh = L.apply_norm(p["norm2"], x, cfg)
        x = x + L.mlp(p["ffn"], hh, cfg)
    x = L.apply_norm(params["final_norm"], x, cfg)
    spec_cache = {"pos0": {"k": entry["k"], "v": entry["v"],
                           "k_new": torch.stack(k_new),
                           "v_new": torch.stack(v_new)}}
    return x, spec_cache


def attention_decode_batched(p, x, cfg, entry, lengths, masks, tree_mask,
                             depths, use_kernel=False):
    """Tree-decode attention of one layer with per-row lengths.

    ``entry`` holds that layer's cache k/v [B, S, Hkv, D]; the T tree rows
    are written into it in place.  With ``use_kernel`` the attention runs
    through ``kernels.ops.tree_attention`` (the ``flash_decode`` kernel on
    the card); otherwise through the masked plain attention with
    ``masks`` [B, T, S].  With ``use_kernel`` and ``cfg.verify_fusion``
    the write side (q/k/v projection, RoPE and the tree-row write) is one
    ``fused_qkv_rope_commit`` launch, as in the reference.  Returns
    (y [B, T, d], {"k_new", "v_new": [B, T, Hkv, D]}), the in-flight tree
    rows.
    """
    hd = cfg.resolved_head_dim
    scale = 1.0 / math.sqrt(hd)
    cos = sin = None
    if cfg.use_rope:
        positions = lengths[:, None] + depths[None, :]
        cos, sin = L.rope_cos_sin(positions, hd, cfg.rope_theta)
    if use_kernel and cfg.verify_fusion:
        q, k, v = fused_qkv_rope_commit(x, p, lengths, entry["k"], entry["v"],
                                        cos=cos, sin=sin)
    else:
        q, k, v = L._project_qkv(p, x, cfg)
        if cfg.use_rope:
            q = L.apply_rope(q, cos[:, :, None, :], sin[:, :, None, :])
            k = L.apply_rope(k, cos[:, :, None, :], sin[:, :, None, :])
        _update_rows(entry["k"], k, lengths)
        _update_rows(entry["v"], v, lengths)
    if use_kernel:
        out = tree_attention(q, entry["k"], entry["v"], tree_mask, lengths,
                             scale, k_tree=k, v_tree=v)
    else:
        out = L._gqa_scores_to_out(q, entry["k"].to(q.dtype),
                                   entry["v"].to(q.dtype), masks, scale)
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype))
    return y, {"k_new": k, "v_new": v}


def _commit_attn_entry(entry, lengths, path_slots):
    """Commit one attention layer: gather the best path's rows from the
    small in-flight tensors and write them at [len, len+K1) of every unit,
    in place.  entry: k/v [nu, B, S, Hkv, D] + k_new/v_new
    [nu, B, T, Hkv, D]; path_slots [B, K1]."""
    B = path_slots.shape[0]
    rows = torch.arange(B, device=path_slots.device)[:, None]
    out = {}
    for name in ("k", "v"):
        picked = entry[name + "_new"][:, rows, path_slots.long()]  # [nu,B,K1,H,D]
        _update_rows(entry[name], picked, lengths)
        out[name] = entry[name]
    return out


def commit(cfg: ModelConfig, spec_cache, lengths, path_slots, acc):
    """Zero-copy compaction: keep exactly the accepted prefix.

    path_slots [B, K+1]: tree-node slots of the best path (0..T-1); acc [B]
    in [1, K+1].  Writes the best path's KV rows at [len, len+K+1) in place
    (rows past ``acc`` are dead and are overwritten later).  Returns
    (cache, lengths + acc).
    """
    cache = {"pos0": _commit_attn_entry(spec_cache["pos0"], lengths,
                                        path_slots)}
    return cache, lengths + acc
