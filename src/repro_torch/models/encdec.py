"""Whisper-style encoder-decoder in PyTorch (counterpart of
``repro.models.encdec``).

The audio frontend is a stub: ``extra_embeds`` [B, frontend_len,
frontend_dim] are precomputed frame embeddings, which ``encode`` projects
(``frontend_proj``), offsets by learned positions (``pos_enc``) and runs
through ``encoder_layers`` non-causal units.  The decoder keeps the
decoder-only stack's static tree-decode and zero-copy commit contract:
learned positions (``pos_dec``) in place of RoPE, and after each unit's
self-attention a cross-attention over a fixed per-slot encoder k/v.

Parameters keep the reference tree: ``enc_units`` and ``dec_units`` hold
every unit's weights stacked on a leading axis.  The cache is
``{"self", "cross"}``: ``self`` is the decoder's self-attention entry in
``cfg.resolved_cache_dtype`` and layout (dense [nu, B, S, Hkv, D], int8
with f32 scales, or the paged pool with the block table under
``"_pages"``), exactly an attention entry of ``models.transformer``;
``cross`` is per slot and dense, [nu, B, frontend_len, Hkv, D] in
``cfg.dtype`` under every layout: written once by ``prefill`` (the
encoder pass), read by every decode step, never a pool.

As in ``models.transformer``, ``prefill``, ``decode`` and ``commit``
write the cache tensors in place.  ``decode`` writes the tree rows, then
attends (the reference ignores ``deferred`` here, and so does the port),
through ``kernels.ops.tree_attention`` under ``use_kernel``; it never
takes the fused write side (``fused_qkv_rope_commit``), with or without
verify fusion, as the reference's encdec ``decode`` never does.
``commit`` writes the ``self`` entry through ``commit_path_stacked`` (one
launch a step: K4 dense, K5 paged) and leaves ``cross`` as it is.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import paging as P
from repro_torch.kernels import quant as Q
from repro_torch.kernels.tree_attention import pitch_lm_head
from repro_torch.models import layers as L
from repro_torch.models.transformer import (CROSS_KEY, PAGES_KEY,
                                            _commit_attn_entry, _write_prefix,
                                            attention_decode_batched,
                                            cache_max_len, split_pages,
                                            unbound_units)
from repro_torch.runtime import resolve_device, torch_dtype

# the cache entries: the decoder's self-attention rows (pooled under the
# paged layout) and the per-slot encoder k/v
SELF, CROSS = "self", CROSS_KEY


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_enc_units(gen: torch.Generator, cfg: ModelConfig, nu: int):
    dev = gen.device
    return {"norm1": L.init_norm(cfg, dev, stack=nu),
            "attn": L.init_attention(gen, cfg, stack=nu),
            "norm2": L.init_norm(cfg, dev, stack=nu),
            "mlp": L.init_mlp(gen, cfg, stack=nu)}


def _init_dec_units(gen: torch.Generator, cfg: ModelConfig, nu: int):
    dev = gen.device
    return {"norm1": L.init_norm(cfg, dev, stack=nu),
            "self_attn": L.init_attention(gen, cfg, stack=nu),
            "norm_x": L.init_norm(cfg, dev, stack=nu),
            "cross_attn": L.init_attention(gen, cfg, stack=nu),
            "norm2": L.init_norm(cfg, dev, stack=nu),
            "mlp": L.init_mlp(gen, cfg, stack=nu)}


def init_params(gen: torch.Generator, cfg: ModelConfig, dtype=None):
    """Full model params on ``gen.device``, drawn from ``gen``, with the
    reference's tree, shapes and init scales (not its random bits): the
    token table ``embed`` [V, d], ``pos_enc`` [frontend_len, d],
    ``pos_dec`` [max_position, d], ``frontend_proj`` [frontend_dim, d],
    the stacked ``enc_units`` / ``dec_units``, ``enc_final``,
    ``final_norm`` and the untied ``lm_head`` [d, V] (at a 16-byte row
    pitch, ``pitch_lm_head``: whisper-tiny's V 51865 is odd)."""
    if dtype is not None:
        cfg = dataclasses.replace(cfg, param_dtype=dtype)
    dt = torch_dtype(cfg.param_dtype)
    d = cfg.d_model
    fd = cfg.frontend_dim or d
    dev = gen.device
    return {
        "embed": L.dense_init(gen, (cfg.vocab_size, d), dt, scale=0.02),
        "pos_enc": L.dense_init(gen, (cfg.frontend_len, d), dt, scale=0.02),
        "pos_dec": L.dense_init(gen, (cfg.max_position, d), dt, scale=0.02),
        "frontend_proj": L.dense_init(gen, (fd, d), dt),
        "enc_units": _init_enc_units(gen, cfg, cfg.encoder_layers),
        "enc_final": L.init_norm(cfg, dev),
        "dec_units": _init_dec_units(gen, cfg, cfg.num_layers),
        "final_norm": L.init_norm(cfg, dev),
        "lm_head": pitch_lm_head(L.dense_init(gen, (d, cfg.vocab_size), dt)),
    }


# ---------------------------------------------------------------------------
# embedding / unembedding
# ---------------------------------------------------------------------------

def embed_tokens(params, cfg: ModelConfig, tokens):
    return params["embed"][tokens].to(torch_dtype(cfg.dtype))


def _dec_embed(params, cfg: ModelConfig, tokens, positions):
    """Token embeddings plus the learned decoder positions, in
    ``cfg.dtype``.  ``positions`` must lie below ``cfg.max_position``
    (``jnp.take`` fills a position past the table, indexing here would
    fault): prefill and training reject a longer window, and decode
    clamps the rows past a cache the table covers."""
    dt = torch_dtype(cfg.dtype)
    return embed_tokens(params, cfg, tokens) + params["pos_dec"][
        positions].to(dt)


def _check_positions(cfg: ModelConfig, rows: int):
    if rows > cfg.max_position:
        raise ValueError(
            f"{cfg.name}: {rows} decoder rows reach past the learned "
            f"position table's {cfg.max_position}")


def unembed_weight(params):
    """(w, layout): the untied ``lm_head`` [d, V], V contiguous ("dv",
    pitched)."""
    return params["lm_head"], "dv"


def unembed(params, cfg: ModelConfig, hidden):
    return torch.matmul(hidden, params["lm_head"].to(hidden.dtype))


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------

def _frames(cfg: ModelConfig, extra_embeds):
    if extra_embeds is None:
        raise ValueError(f"{cfg.name}: the encoder-decoder needs the frame "
                         f"embeddings (extra_embeds [B, {cfg.frontend_len}, "
                         f"{cfg.frontend_dim or cfg.d_model}])")
    return extra_embeds


def encode(params, cfg: ModelConfig, frames):
    """frames [B, F, frontend_dim] (the stub's output) -> enc_out
    [B, F, d] in ``cfg.dtype``: projected, offset by ``pos_enc``, through
    the non-causal encoder units and ``enc_final``."""
    dt = torch_dtype(cfg.dtype)
    x = torch.einsum("bfe,ed->bfd", frames.to(dt),
                     params["frontend_proj"].to(dt))
    x = x + params["pos_enc"].to(dt)[None]
    for p in unbound_units(params["enc_units"], cfg.encoder_layers):
        x = x + L.attention_full(p["attn"], L.apply_norm(p["norm1"], x, cfg),
                                 cfg, causal=False)
        x = x + L.mlp(p["mlp"], L.apply_norm(p["norm2"], x, cfg), cfg)
    return L.apply_norm(params["enc_final"], x, cfg)


# ---------------------------------------------------------------------------
# training forward
# ---------------------------------------------------------------------------

def _dec_unit_full(p, x, enc_out, cfg: ModelConfig):
    """One decoder unit over the full sequence (teacher forcing)."""
    x = x + L.attention_full(p["self_attn"], L.apply_norm(p["norm1"], x, cfg),
                             cfg)
    kv = L.cross_kv(p["cross_attn"], enc_out, cfg)
    x = x + L.attention_cross(p["cross_attn"],
                              L.apply_norm(p["norm_x"], x, cfg), kv, cfg)
    return x + L.mlp(p["mlp"], L.apply_norm(p["norm2"], x, cfg), cfg)


def forward_hidden(params, cfg: ModelConfig, tokens, extra_embeds=None,
                   remat: bool = False, collect_router: bool = False):
    """Token ids [B, S] and frames ``extra_embeds`` -> (final hidden
    states [B, S, d], aux loss 0).  Differentiable; ``remat`` recomputes
    each decoder unit in the backward pass (the reference's
    ``jax.checkpoint`` of its scan body).  ``collect_router`` is
    accepted for the decoder-only signature (no experts here)."""
    enc_out = encode(params, cfg, _frames(cfg, extra_embeds))
    S = tokens.shape[1]
    _check_positions(cfg, S)
    x = _dec_embed(params, cfg, tokens,
                   torch.arange(S, device=tokens.device)[None, :])
    for p in unbound_units(params["dec_units"], cfg.num_layers):
        if remat:
            x = torch.utils.checkpoint.checkpoint(
                _dec_unit_full, p, x, enc_out, cfg, use_reentrant=False)
        else:
            x = _dec_unit_full(p, x, enc_out, cfg)
    x = L.apply_norm(params["final_norm"], x, cfg)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def forward_train(params, cfg: ModelConfig, tokens, extra_embeds=None,
                  remat: bool = True):
    """-> (logits [B, S, V] in ``cfg.dtype``, aux loss 0)."""
    hidden, aux = forward_hidden(params, cfg, tokens, extra_embeds,
                                 remat=remat)
    return unembed(params, cfg, hidden), aux


# ---------------------------------------------------------------------------
# cache
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, device="cuda",
               n_blocks=None):
    """Zeroed decode cache on ``device`` (the card unless the caller asks
    for ``"cpu"``).  ``self`` follows ``cfg.resolved_cache_dtype`` and
    layout as ``transformer.init_cache``'s attention entry does (int8
    adds ``k_scale``/``v_scale``; paged: pools of ``n_blocks`` blocks and
    ``"_pages": {"table"}``, the identity table when ``n_blocks`` is
    None, all-zero tables otherwise).  ``cross`` is per slot and dense,
    ``k``/``v`` [nu, B, frontend_len, Hkv, D] in ``cfg.dtype``: it is
    written once a request and O(frontend_len), so neither quantizing nor
    pooling it would buy anything."""
    device = resolve_device(device)
    dt = torch_dtype(cfg.resolved_cache_dtype)
    nu, hkv, hd = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim
    cache = {}
    if cfg.paged:
        ps = cfg.page_size
        mb = P.blocks_for(max_len, ps)
        nb = (1 + batch * mb) if n_blocks is None else int(n_blocks)
        lead = (nu, nb, ps)
        table = (P.identity_table(batch, mb, device=device)
                 if n_blocks is None else
                 torch.zeros((batch, mb), dtype=torch.int32, device=device))
        cache[PAGES_KEY] = {"table": table}
    else:
        lead = (nu, batch, max_len)
    entry = {n: torch.zeros(lead + (hkv, hd), dtype=dt, device=device)
             for n in ("k", "v")}
    if Q.is_quantized(dt):
        for name in ("k_scale", "v_scale"):
            entry[name] = torch.zeros(lead + (hkv, 1), dtype=torch.float32,
                                      device=device)
    cache[SELF] = entry
    xdt = torch_dtype(cfg.dtype)
    cache[CROSS] = {n: torch.zeros((nu, batch, cfg.frontend_len, hkv, hd),
                                   dtype=xdt, device=device)
                    for n in ("k", "v")}
    return cache


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------

def prefill(params, cfg: ModelConfig, tokens, lengths, cache,
            extra_embeds=None):
    """Encode the frames once, then process the right-padded prompts.

    tokens [B, S_p], lengths [B] the prompts' true lengths (the frames
    take no decoder row), ``extra_embeds`` [B, F, fd] the frames.  Writes
    the self rows [0, S_p) of every unit in place (through the table
    under the paged layout, quantized under int8) and every unit's cross
    k/v.  Returns (hidden_last [B, d], cache)."""
    layers, pages = split_pages(cache)
    table = None if pages is None else pages["table"]
    B, Sp = tokens.shape
    cap = cache_max_len(cache)
    if Sp > cap:
        raise ValueError(f"prompt window {Sp} exceeds the cache's {cap} "
                         f"rows")
    _check_positions(cfg, Sp)
    enc_out = encode(params, cfg, _frames(cfg, extra_embeds))
    x = _dec_embed(params, cfg, tokens,
                   torch.arange(Sp, device=tokens.device)[None, :])
    phys = None
    if table is not None:
        zero = torch.zeros((B,), dtype=torch.int32, device=x.device)
        phys = P.phys_rows(table, zero, Sp, cfg.page_size).reshape(-1)
    self_e, cross_e = layers[SELF], layers[CROSS]
    for u, p in enumerate(unbound_units(params["dec_units"], cfg.num_layers)):
        y, (k, v) = L.attention_full(p["self_attn"],
                                     L.apply_norm(p["norm1"], x, cfg), cfg,
                                     return_kv=True)
        _write_prefix({n: t[u] for n, t in self_e.items()}, k, v, phys=phys)
        x = x + y
        xk, xv = L.cross_kv(p["cross_attn"], enc_out, cfg)
        cross_e["k"][u].copy_(xk)
        cross_e["v"][u].copy_(xv)
        x = x + L.attention_cross(p["cross_attn"],
                                  L.apply_norm(p["norm_x"], x, cfg),
                                  (xk, xv), cfg)
        x = x + L.mlp(p["mlp"], L.apply_norm(p["norm2"], x, cfg), cfg)
    x = L.apply_norm(params["final_norm"], x, cfg)
    rows = torch.arange(B, device=x.device)
    return x[rows, lengths.long() - 1], cache


# ---------------------------------------------------------------------------
# speculative decode step + commit
# ---------------------------------------------------------------------------

def decode(params, cfg: ModelConfig, cache, tokens, lengths, tree_mask, depths,
           use_kernel: bool = False, deferred: bool = False, ssm_keep=None):
    """One static speculative step over T tree/chain tokens: the
    write-then-attend path.

    tokens [B, T]; lengths [B]; tree_mask [T, T] bool; depths [T] int.
    The T tree rows land in ``self`` at [lengths, lengths+T) in place
    (fake-quantized under int8), then self-attention runs over the cache
    (``kernels.ops.tree_attention`` under ``use_kernel``, else the masked
    plain attention), then cross-attention over ``cross``.  ``deferred``
    and ``ssm_keep`` are accepted for the decoder-only signature and
    ignored, as the reference ignores ``deferred``; the fused write side
    is never taken.  Returns (hidden [B, T, d], spec_cache): the cache's
    tensors and ``_pages``, with ``self`` also holding the in-flight rows
    ``k_new``/``v_new``, tuples of nu [B, T, Hkv, D] tensors, which
    ``commit`` reads."""
    del deferred, ssm_keep
    layers, pages = split_pages(cache)
    table = None if pages is None else pages["table"]
    B, T = tokens.shape
    S_max = cache_max_len(cache)
    _check_positions(cfg, S_max)
    # a row at or past max_position >= S_max lies past the cache: its
    # write is dropped (or sunk into trash block 0) and its tokens are
    # dead, as the reference's filled lookup leaves them; the clamp keeps
    # the lookup in the table (the reference relies on the same for
    # ``decode_mask``)
    positions = torch.clamp(lengths[:, None] + depths[None, :],
                            max=cfg.max_position - 1)
    x = _dec_embed(params, cfg, tokens, positions)
    masks = phys = None
    if not use_kernel:
        masks = L.decode_mask(tree_mask, lengths, T, S_max)       # [B, T, S]
    if table is not None:
        phys = P.phys_rows(table, lengths, T, cfg.page_size).reshape(-1)
    # the reference's encdec decode keeps the unfused write side whatever
    # the fusion knob (verify fusion still fuses the unembedding)
    wcfg = dataclasses.replace(cfg, verify_fusion=False) \
        if cfg.verify_fusion else cfg
    self_e, cross_e = layers[SELF], layers[CROSS]
    k_new, v_new = [], []
    for u, p in enumerate(unbound_units(params["dec_units"], cfg.num_layers)):
        view = {n: t[u] for n, t in self_e.items()}
        y, rows = attention_decode_batched(
            p["self_attn"], L.apply_norm(p["norm1"], x, cfg), wcfg, view,
            lengths, masks, tree_mask, depths, use_kernel, table=table,
            phys=phys)
        k_new.append(rows["k_new"])
        v_new.append(rows["v_new"])
        x = x + y
        x = x + L.attention_cross(
            p["cross_attn"], L.apply_norm(p["norm_x"], x, cfg),
            (cross_e["k"][u].to(x.dtype), cross_e["v"][u].to(x.dtype)), cfg)
        x = x + L.mlp(p["mlp"], L.apply_norm(p["norm2"], x, cfg), cfg)
    x = L.apply_norm(params["final_norm"], x, cfg)
    spec_cache = {SELF: dict(self_e, k_new=tuple(k_new), v_new=tuple(v_new)),
                  CROSS: cross_e}
    if pages is not None:
        spec_cache[PAGES_KEY] = pages
    return x, spec_cache


def commit(cfg: ModelConfig, spec_cache, lengths, path_slots, acc,
           active=None):
    """Zero-copy compaction of the ``self`` entry: the best path's rows
    land at [len, len+K+1) of every unit, in place, through one
    ``commit_path_stacked`` launch (K4 dense, K5 paged); ``cross`` is
    left as it is.  ``active`` [B] bool (optional): the scheduler's
    masked commit, inactive slots keep their lengths.  Returns (cache,
    lengths + where(active, acc, 0)); the cache keeps ``_pages``."""
    layers, pages = split_pages(spec_cache)
    table = None if pages is None else pages["table"]
    cache = {SELF: _commit_attn_entry(layers[SELF], lengths, path_slots,
                                      table=table),
             CROSS: layers[CROSS]}
    if pages is not None:
        cache[PAGES_KEY] = pages
    adv = acc if active is None else torch.where(active, acc,
                                                 torch.zeros_like(acc))
    return cache, lengths + adv
