"""Decoder-only stack in PyTorch, dense, MoE, VLM, SSM and hybrid
families: init, prefill, the static speculative decode step and the
zero-copy commit.

Counterpart of ``repro.models.transformer``.  The stack is a repeating
unit of positions (``unit_structure``): one attention position for the
dense, MoE and VLM families, one Mamba2 position without an FFN for the
SSM family, and ``hybrid_period`` positions for the hybrid (attention at
``attn_index``, Mamba2 elsewhere, the MoE FFN where ``pos % moe_every ==
moe_offset``).  Parameters keep the reference tree:
``params["units"]["pos<i>"]`` holds every unit's weights of position i
stacked on a leading ``n_units`` axis.  An attention position's cache
entry is ``{"k", "v": [n_units, B, S, Hkv, D]}``, with the reference's
two other layouts: int8 values plus ``k_scale``/``v_scale``
[n_units, B, S, Hkv, 1] f32 (``cfg.cache_dtype == "int8"``), and the
paged pool [n_units, n_blocks, page_size, Hkv, D] with the block table
under ``cache["_pages"]["table"]`` (``cfg.cache_layout == "paged"``).
An SSM position's entry is its recurrent state per slot under every
layout: ``conv_x`` [n_units, B, d_inner, W-1], ``conv_bc`` [n_units, B,
2N, W-1] (the activation dtype) and ``ssm`` [n_units, B, H, P, N] f32.
Where the reference scans over units, this module runs a host loop over
them.  A MoE position carries ``layers.moe`` in place of the dense MLP
(``ffn`` holds the f32 router and the stacked experts); a VLM config
adds ``params["frontend_proj"]``, which projects the stub frontend's
prefix embeddings (``extra_embeds``) into the stream ahead of the token
embeddings.

Unlike the reference's pure functions, ``prefill``, ``decode`` and
``commit`` write the cache tensors in place (indexed writes of the rows
that change), so one step never copies the cache.  The caller's cache
dict is therefore updated by these calls, and the dict they return holds
the same tensors.  An SSM position's state is the speculation root
until ``commit``: ``decode`` leaves it untouched and returns the state
after each chain token beside it, and ``commit`` copies the selected one
in (the root itself, bit for bit, on a masked row), which is the
reference's checkpointed rollback without its checkpoint leaves.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import collectives as C
from repro_torch.kernels import paging as P
from repro_torch.kernels import quant as Q
from repro_torch.kernels.cache_update import (commit_path_stacked,
                                              fused_qkv_rope_commit)
# the decode step's in-place tree-row write (the reference's _update_rows)
from repro_torch.kernels.cache_update import commit_rows_plain as _update_rows
from repro_torch.kernels.ops import tree_attention
from repro_torch.kernels.tree_attention import pitch_lm_head
from repro_torch.models import layers as L
from repro_torch.models import ssm as SSM
from repro_torch.runtime import resolve_device, torch_dtype

# cache-dict key holding the paged layout's block table; it is not a layer
# entry (no leading n_units axis), so every walk over the layers splits it
# off first
PAGES_KEY = "_pages"
# the encoder-decoder's cache entry of per-slot encoder k/v
# (``models.encdec``): attention-shaped, but never the paged pool
CROSS_KEY = "cross"


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
    unit (the reference's rule): ("ssm", "none") for the SSM family; for
    the hybrid ``hybrid_period`` positions, attention at ``attn_index``
    and Mamba2 elsewhere, each with the MoE FFN where ``pos % moe_every
    == moe_offset`` and the dense MLP otherwise; else one attention
    position, with the MoE FFN for a config with experts."""
    check_supported(cfg)
    if cfg.family == "ssm":
        return [("ssm", "none")]
    if cfg.family == "hybrid" and cfg.hybrid_period:
        return [("attn" if pos == cfg.attn_index else "ssm",
                 "moe" if (cfg.num_experts
                           and pos % cfg.moe_every == cfg.moe_offset)
                 else "dense")
                for pos in range(cfg.hybrid_period)]
    return [("attn", "moe" if cfg.num_experts else "dense")]


def n_units(cfg: ModelConfig) -> int:
    u = len(unit_structure(cfg))
    if cfg.num_layers % u:
        raise ValueError(f"{cfg.name}: {cfg.num_layers} layers are not a "
                         f"whole number of {u}-position units")
    return cfg.num_layers // u


def check_supported(cfg: ModelConfig):
    """Raise ValueError for an unknown family, and for a ``tp_axis`` on a
    family other than the dense one: tensor parallelism shards the dense
    decoder only (the reference's ``distributed/tp.py`` refuses the rest,
    whose mixers are not head-sharded)."""
    if cfg.family not in ("dense", "moe", "vlm", "ssm", "hybrid", "encdec"):
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}")
    if cfg.tp_axis and cfg.family != "dense":
        raise ValueError(
            f"{cfg.name}: tensor-parallel decode supports the dense family "
            f"only; {cfg.family!r} has non-TP mixers")


def unit_params(params, u: int):
    """Views of unit ``u``'s weights from the stacked ``params["units"]``."""
    def pick(tree):
        return {k: pick(v) if isinstance(v, dict) else v[u]
                for k, v in tree.items()}
    return pick(params["units"])


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_position(gen: torch.Generator, cfg: ModelConfig, mix: str,
                   ffn: str, nu: int):
    """One position's weights, stacked over the ``nu`` units: the
    ``mix`` mixer (attention or Mamba2) and, unless ``ffn`` is "none",
    the second norm and the ``ffn`` kind's FFN."""
    dev = gen.device
    p = {"norm1": L.init_norm(cfg, dev, stack=nu)}
    if mix == "attn":
        p["attn"] = L.init_attention(gen, cfg, stack=nu)
    else:
        p["ssm"] = SSM.init_mamba2(gen, cfg, stack=nu)
    if ffn != "none":
        p["norm2"] = L.init_norm(cfg, dev, stack=nu)
        p["ffn"] = (L.init_moe(gen, cfg, stack=nu) if ffn == "moe"
                    else L.init_mlp(gen, cfg, stack=nu))
    return p


def init_params(gen: torch.Generator, cfg: ModelConfig, dtype=None):
    """Full model params on ``gen.device``, drawn from ``gen``.  Shapes and
    init scales follow the reference; the random bits do not (tests carry
    the reference's weights across with ``bridge.to_torch`` instead).  A
    config with a frontend adds ``frontend_proj`` [frontend_dim, d].  An
    untied ``lm_head`` whose V is not a multiple of 8 is laid out at a
    16-byte row pitch (``pitch_lm_head``: same shape and values, rows
    ceil8(V) apart) so that the verify kernel's TMA route can read it."""
    if dtype is not None:
        cfg = dataclasses.replace(cfg, param_dtype=dtype)
    nu = n_units(cfg)
    dt = torch_dtype(cfg.param_dtype)
    params = {
        "embed": L.dense_init(gen, (cfg.vocab_size, cfg.d_model), dt,
                              scale=0.02),
        "units": {f"pos{i}": _init_position(gen, cfg, mix, ffn, nu)
                  for i, (mix, ffn) in enumerate(unit_structure(cfg))},
        "final_norm": L.init_norm(cfg, gen.device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = pitch_lm_head(L.dense_init(
            gen, (cfg.d_model, cfg.vocab_size), dt))
    if cfg.frontend:
        fd = cfg.frontend_dim or cfg.d_model
        params["frontend_proj"] = L.dense_init(gen, (fd, cfg.d_model), dt)
    return params


# ---------------------------------------------------------------------------
# embedding / unembedding
# ---------------------------------------------------------------------------

def embed_scale(cfg: ModelConfig, dtype) -> float:
    """gemma's embedding scale sqrt(d_model), rounded to the activation
    dtype as the reference's ``jnp.asarray(d ** 0.5, dtype)`` rounds it
    (45.25 in bf16 at d 2048), as a Python scalar, which stream capture
    takes (a tensor made on the card would be a copy from the host).
    The tensor is a CPU constant built from the config, never a value of
    the step, so reading it syncs nothing."""
    scale = torch.tensor(cfg.d_model ** 0.5, dtype=dtype)
    return scale.item()  # speclint: disable=trace-safety


def embed_tokens(params, cfg: ModelConfig, tokens):
    x = params["embed"][tokens].to(torch_dtype(cfg.dtype))
    if cfg.tie_embeddings:
        x = x * embed_scale(cfg, x.dtype)      # gemma's convention
    return x


def unembed_weight(params):
    """(w, layout): the unembedding weight as a [d, V] tensor and how its
    storage lies.  ``"dv"``: the untied ``lm_head`` [d, V], V contiguous
    (its rows at a 16-byte pitch past V where V is not a multiple of 8).
    ``"vd"``: a tied model's ``embed.T``, a view of the [V, d] table with
    d contiguous (no copy is made: the verify kernel reads the table in
    place).  Every reader of the unembedding weight takes it from here."""
    w = params.get("lm_head")
    if w is None:
        return params["embed"].T, "vd"
    return w, "dv"


def unembed_local(params, cfg: ModelConfig, hidden):
    """Logits over the vocabulary slice this rank's lm head holds: [..., V]
    on one device, [..., V / tp] on a rank of a tensor-parallel group (the
    TP verify epilogue reads them as they are)."""
    w, _ = unembed_weight(params)
    return torch.matmul(hidden, w.to(hidden.dtype))


def unembed(params, cfg: ModelConfig, hidden):
    """Logits [..., V].  Under tensor parallelism the ranks' vocabulary
    slices are all-gathered, in rank order, so every full-row reader (the
    prefill's base token, a row resample, the unfused verify) sees the row
    one device would."""
    logits = unembed_local(params, cfg, hidden)
    if cfg.tp_axis and logits.shape[-1] != cfg.vocab_size:
        logits = C.all_gather(logits, cfg.tp_axis, dim=-1, tiled=True)
    return logits


def frontend_prefix(params, cfg: ModelConfig, extra_embeds):
    """Project stub modality embeddings [B, F, fd] into the model stream
    [B, F, d], in the activation dtype."""
    dt = torch_dtype(cfg.dtype)
    return torch.einsum("bfe,ed->bfd", extra_embeds.to(dt),
                        params["frontend_proj"].to(dt))


def _embed_input(params, cfg: ModelConfig, tokens, extra_embeds):
    """The stream's input rows: the token embeddings, after the projected
    frontend prefix when the config has a frontend and ``extra_embeds``
    is given ([B, F + S, d]; a config without one ignores it, as the
    reference does)."""
    x = embed_tokens(params, cfg, tokens)
    if cfg.frontend and extra_embeds is not None:
        x = torch.cat([frontend_prefix(params, cfg, extra_embeds), x], dim=1)
    return x


def _ffn(p, kind: str, x, cfg: ModelConfig):
    """The position's FFN on the normed stream ``x``: (y, router logits
    [G, s, E] f32 for the MoE, None for the dense MLP)."""
    if kind == "moe":
        return L.moe(p["ffn"], x, cfg)
    return L.mlp(p["ffn"], x, cfg), None


def _ffn_residual(p, kind: str, x, cfg: ModelConfig):
    """``x`` plus the position's FFN on its second norm (``x`` itself for
    an SSM position without one)."""
    if kind == "none":
        return x
    return x + _ffn(p, kind, L.apply_norm(p["norm2"], x, cfg), cfg)[0]


# ---------------------------------------------------------------------------
# full-sequence forward (training)
# ---------------------------------------------------------------------------

def _unit_full(unit_p, x, cfg: ModelConfig, collect_router: bool = False):
    """One unit over the full sequence: each position's mixer (causal
    attention or the chunked SSD), then its FFN.  Returns (x, aux): the
    sum of ``moe_aux_loss`` over the unit's MoE positions when
    ``collect_router``, else 0."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, (mix, ffn) in enumerate(unit_structure(cfg)):
        p = unit_p[f"pos{i}"]
        h = L.apply_norm(p["norm1"], x, cfg)
        x = x + (L.attention_full(p["attn"], h, cfg) if mix == "attn"
                 else SSM.mamba2_full(p["ssm"], h, cfg))
        if ffn == "none":
            continue
        y, router_logits = _ffn(p, ffn, L.apply_norm(p["norm2"], x, cfg),
                                cfg)
        if collect_router and router_logits is not None:
            aux = aux + L.moe_aux_loss(router_logits)
        x = x + y
    return x, aux


def unbound_units(stacked, n: int) -> list:
    """Each of the ``n`` units' weights, as views of the ``stacked`` tree
    (every leaf on a leading unit axis) made with one ``unbind`` per leaf:
    its backward stacks the units' gradients once, where indexing each
    unit (``unit_params``) would add a zero-filled gradient of the whole
    stack per unit."""
    def split(tree):
        return {k: split(v) if isinstance(v, dict) else v.unbind(0)
                for k, v in tree.items()}

    def pick(tree, u):
        return {k: pick(v, u) if isinstance(v, dict) else v[u]
                for k, v in tree.items()}

    parts = split(stacked)
    return [pick(parts, u) for u in range(n)]


def forward_hidden(params, cfg: ModelConfig, tokens, extra_embeds=None,
                   remat: bool = False, collect_router: bool = False):
    """Token ids [B, S] -> (final hidden states [B, F + S, d], aux loss).

    Differentiable (plain PyTorch, autograd).  ``extra_embeds`` [B, F, fd]
    (a config with a frontend) prepends the projected prefix.  ``remat``
    recomputes each unit's activations in the backward pass
    (``torch.utils.checkpoint``, the reference's ``jax.checkpoint`` of its
    scan body).  With ``collect_router`` the aux loss is the sum of every
    MoE layer's ``moe_aux_loss``; otherwise (and for a model without
    experts) it is 0."""
    x = _embed_input(params, cfg, tokens, extra_embeds)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for unit_p in unbound_units(params["units"], n_units(cfg)):
        if remat:
            x, a = torch.utils.checkpoint.checkpoint(
                _unit_full, unit_p, x, cfg, collect_router,
                use_reentrant=False)
        else:
            x, a = _unit_full(unit_p, x, cfg, collect_router)
        aux = aux + a
    x = L.apply_norm(params["final_norm"], x, cfg)
    return x, aux


def forward_train(params, cfg: ModelConfig, tokens, extra_embeds=None,
                  remat: bool = True):
    """-> (logits [B, S, V] in ``cfg.dtype``, aux loss scalar)."""
    hidden, aux = forward_hidden(params, cfg, tokens, extra_embeds,
                                 remat=remat,
                                 collect_router=cfg.num_experts > 0)
    return unembed(params, cfg, hidden), aux


# ---------------------------------------------------------------------------
# cache
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, device="cuda",
               n_blocks=None):
    """Zeroed decode cache on ``device`` (the card unless the caller asks
    for ``"cpu"``): one entry per position of the unit.

    Attention positions, in ``cfg.resolved_cache_dtype``: dense
    ``{"k", "v": [nu, B, S, Hkv, D]}``; int8 adds ``k_scale``/``v_scale``
    [nu, B, S, Hkv, 1] f32.  Paged (``cfg.cache_layout == "paged"``): the
    leaves become pools [nu, n_blocks, page_size, Hkv, D] (scales
    [nu, n_blocks, page_size, Hkv, 1]) and ``"_pages": {"table":
    [B, max_blocks] int32}`` holds the one table of every layer,
    max_blocks = ceil(max_len / page_size).  With ``n_blocks=None`` the
    pool is sized for the identity table (one contiguous run of blocks
    per slot after trash block 0); an explicit ``n_blocks`` starts with
    all-zero tables for an allocator to fill.

    SSM positions stay per slot under every layout: ``conv_x``
    [nu, B, d_inner, W-1] and ``conv_bc`` [nu, B, 2N, W-1] in the
    activation dtype ``cfg.dtype`` (the reference allocates them in the
    cache dtype, an int8 placeholder that its prefill replaces with
    activation-dtype tensors; the port writes in place), and ``ssm``
    [nu, B, H, P, N] f32.
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
    act = torch_dtype(cfg.dtype)
    W = cfg.ssm_conv
    for i, (mix, _) in enumerate(unit_structure(cfg)):
        if mix == "attn":
            entry = {n: torch.zeros(lead + (hkv, hd), dtype=dt, device=device)
                     for n in ("k", "v")}
            if Q.is_quantized(dt):
                for name in ("k_scale", "v_scale"):
                    entry[name] = torch.zeros(lead + (hkv, 1),
                                              dtype=torch.float32,
                                              device=device)
        else:
            entry = {
                "conv_x": torch.zeros((nu, batch, cfg.d_inner, W - 1),
                                      dtype=act, device=device),
                "conv_bc": torch.zeros((nu, batch, 2 * cfg.ssm_state, W - 1),
                                       dtype=act, device=device),
                "ssm": torch.zeros((nu, batch, cfg.ssm_heads,
                                    cfg.ssm_head_dim, cfg.ssm_state),
                                   dtype=torch.float32, device=device)}
        cache[f"pos{i}"] = entry
    return cache


def is_attn_entry(entry) -> bool:
    """Whether a cache entry is attention-shaped (k/v rows: an attention
    position's, or the encoder-decoder's cross k/v) rather than an SSM
    position's per-slot state."""
    return "k" in entry


def is_cache_rows(pos, entry) -> bool:
    """Whether cache entry ``pos`` holds the decode rows of an attention
    position: dense [n_units, B, S, ...] rows or, under the paged layout,
    the shared pool that block ids index.  False for the block table, an
    SSM position's per-slot state and the encoder-decoder's per-slot
    cross k/v (``CROSS_KEY``), as the reference excludes them by name."""
    return pos not in (PAGES_KEY, CROSS_KEY) and is_attn_entry(entry)


def cache_max_len(cache, table=None) -> int:
    """Per-slot capacity in rows.  Dense: the S axis.  Paged: the table's
    reach, max_blocks * page_size (found under ``_pages`` when not
    given).  0 for a cache without an attention position (a pure SSM
    stack holds no rows), the reference's rule.  The encoder-decoder's
    cross k/v (frontend_len rows a slot) is not decode capacity."""
    if table is None and PAGES_KEY in cache:
        table = cache[PAGES_KEY]["table"]
    for pos, entry in cache.items():
        if is_cache_rows(pos, entry):
            per_block_or_s = entry["k"].shape[-3]
            if table is not None:
                return table.shape[1] * per_block_or_s
            return per_block_or_s
    return 0


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------

def prefill(params, cfg: ModelConfig, tokens, lengths, cache,
            extra_embeds=None):
    """Process right-padded prompts, fill the cache, return the last hidden
    state of each row.

    tokens [B, S_p], lengths [B] true lengths, the frontend prefix
    included when ``extra_embeds`` [B, F, fd] is given (the prefix takes
    rows 0..F-1, the tokens F..).  Writes cache rows [0, F + S_p) of
    every attention position in place (through the block table under the
    paged layout, quantized under int8), and every SSM position's state
    at each row's true length (the recurrence frozen on the padding).
    Returns (hidden_last [B, d], cache).
    """
    layers, pages = split_pages(cache)
    table = None if pages is None else pages["table"]
    B = tokens.shape[0]
    x = _embed_input(params, cfg, tokens, extra_embeds)
    S_tot = x.shape[1]
    cap = cache_max_len(cache)
    if cap and S_tot > cap:
        raise ValueError(f"prompt window {S_tot} exceeds the cache's "
                         f"{cap} rows")
    struct = unit_structure(cfg)
    phys = valid = None
    if table is not None and cap:
        zero = torch.zeros((B,), dtype=torch.int32, device=x.device)
        phys = P.phys_rows(table, zero, S_tot, cfg.page_size).reshape(-1)
    if any(mix == "ssm" for mix, _ in struct):
        valid = (torch.arange(S_tot, device=x.device)[None, :]
                 < lengths[:, None])
    for u in range(n_units(cfg)):
        up = unit_params(params, u)
        for i, (mix, ffn) in enumerate(struct):
            p, entry = up[f"pos{i}"], layers[f"pos{i}"]
            hh = L.apply_norm(p["norm1"], x, cfg)
            if mix == "attn":
                y, (k, v) = L.attention_full(p["attn"], hh, cfg,
                                             return_kv=True)
                _write_prefix({n: t[u] for n, t in entry.items()}, k, v,
                              phys=phys)
            else:
                y, states = SSM.mamba2_full(p["ssm"], hh, cfg,
                                            return_state=True, valid=valid,
                                            lengths=lengths)
                for name, st in zip(SSM.STATE_LEAVES, states):
                    entry[name][u].copy_(st)
            x = _ffn_residual(p, ffn, x + y, cfg)
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
           use_kernel: bool = False, deferred: bool = False, ssm_keep=None):
    """One static speculative step over T tree/chain tokens.

    tokens [B, T]; lengths [B]; tree_mask [T, T] bool; depths [T] int.
    Writes the T tree rows into every attention position's cache at
    [lengths, lengths+T) in place, unless ``deferred``: then no row is
    written this step, attention runs as the sweep of the committed cache
    merged with the in-flight block, and commit's write is the only one.
    SSM positions run the chain through the linear recurrence from their
    cached state, which stays the speculation root: it is left as it is
    and the state after each token is returned for ``commit`` to select.
    ``ssm_keep`` [B] int (optional) is each row's count of tokens to
    commit when it is known before the step (a suffix prefill's valid
    rows, 0 on a masked row): the SSM positions then keep only the state
    after that many tokens inside their loop and write it in place, and
    the spec cache carries no per-token state for them.
    Returns (hidden [B, T, d], spec_cache), where spec_cache holds the
    cache tensors (and ``_pages``) plus, per attention position, the
    in-flight rows ``k_new``/``v_new``, tuples of nu [B, T, Hkv, D]
    tensors, one per unit where its layer left them (never stacked), and
    per SSM position (without ``ssm_keep``) ``conv_x_new`` /
    ``conv_bc_new`` / ``ssm_new``, tuples of nu per-token states
    [B, T, ...], all of which ``commit`` reads.
    """
    layers, pages = split_pages(cache)
    table = None if pages is None else pages["table"]
    B, T = tokens.shape
    x = embed_tokens(params, cfg, tokens)
    S_max = cache_max_len(cache)
    struct = unit_structure(cfg)
    masks = phys = None
    if S_max and not (use_kernel or deferred):
        masks = L.decode_mask(tree_mask, lengths, T, S_max)       # [B, T, S]
    attn = [layers[f"pos{i}"] for i, (mix, _) in enumerate(struct)
            if mix == "attn"]
    if table is not None and attn and not (
            deferred or _fused_write(cfg, attn[0], use_kernel)):
        phys = P.phys_rows(table, lengths, T, cfg.page_size).reshape(-1)
    inflight = {f"pos{i}": {n + "_new": [] for n in (
        ("k", "v") if mix == "attn" else
        () if ssm_keep is not None else SSM.STATE_LEAVES)}
        for i, (mix, _) in enumerate(struct)}
    for u in range(n_units(cfg)):
        up = unit_params(params, u)
        for i, (mix, ffn) in enumerate(struct):
            p, entry = up[f"pos{i}"], layers[f"pos{i}"]
            new = inflight[f"pos{i}"]
            view = {n: t[u] for n, t in entry.items()}
            hh = L.apply_norm(p["norm1"], x, cfg)
            if mix == "attn":
                y, rows = attention_decode_batched(
                    p["attn"], hh, cfg, view, lengths, masks, tree_mask,
                    depths, use_kernel, deferred, table=table, phys=phys)
                new["k_new"].append(rows["k_new"])
                new["v_new"].append(rows["v_new"])
            else:
                y, states = SSM.mamba2_decode(
                    p["ssm"], hh, cfg, *(view[n] for n in SSM.STATE_LEAVES),
                    keep=ssm_keep)
                for name, st in zip(SSM.STATE_LEAVES, states):
                    if ssm_keep is None:
                        new[name + "_new"].append(st)
                    else:
                        view[name].copy_(st)
            x = _ffn_residual(p, ffn, x + y, cfg)
    x = L.apply_norm(params["final_norm"], x, cfg)
    spec_cache = {pos: dict(layers[pos], **{n: tuple(ts) for n, ts in
                                            inflight[pos].items()})
                  for pos in inflight}
    if pages is not None:
        spec_cache[PAGES_KEY] = pages
    return x, spec_cache


def _fused_write(cfg, entry, use_kernel, deferred=False) -> bool:
    """Whether the decode step's write side is one ``fused_qkv_rope_commit``
    launch: on the kernel path with verify fusion, on an fp cache (K3 is
    fp-only; the int8 cache keeps the unfused write side), and not under
    ``deferred``, which writes no tree row, so there is nothing to fuse
    (the reference's rule)."""
    return (use_kernel and cfg.verify_fusion and not deferred
            and "k_scale" not in entry)


def attention_decode_batched(p, x, cfg, entry, lengths, masks, tree_mask,
                             depths, use_kernel=False, deferred=False,
                             table=None, phys=None):
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
    later sweep reads back from the cache.  ``deferred`` writes no row
    (and never takes the fused write side): the kernel path sweeps only
    the cache's columns below ``lengths`` and merges the in-flight block
    in, and the plain path does the same through ``layers.gqa_two_part``
    (``masks`` unused).  Returns (y [B, T, d],
    {"k_new", "v_new": [B, T, Hkv, D]}), the in-flight tree rows.
    """
    hd = cfg.resolved_head_dim
    scale = 1.0 / math.sqrt(hd)
    cos = sin = None
    if cfg.use_rope:
        positions = lengths[:, None] + depths[None, :]
        cos, sin = L.rope_cos_sin(positions, hd, cfg.rope_theta)
    if _fused_write(cfg, entry, use_kernel, deferred):
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
        for name, r in ({} if deferred else rows).items():
            if table is not None:
                P.scatter_at(entry[name], phys, r)
            else:
                _update_rows(entry[name], r, lengths)
    if deferred and not use_kernel:
        ck, cv = _read_cache(entry, q.dtype, table=table)
        out = L.gqa_two_part(q, ck, cv, k, v, lengths, tree_mask, scale)
    elif use_kernel:
        out = tree_attention(q, entry["k"], entry["v"], tree_mask, lengths,
                             scale, k_scale=entry.get("k_scale"),
                             v_scale=entry.get("v_scale"), k_tree=k,
                             v_tree=v, block_tables=table)
    else:
        ck, cv = _read_cache(entry, q.dtype, table=table)
        out = L._gqa_scores_to_out(q, ck, cv, masks, scale)
    # both write sides (fused and unfused) end here: the reference's two
    # tp_reduce sites of attention_decode_batched
    y = L.tp_reduce(torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype)),
                    cfg)
    return y, {"k_new": k, "v_new": v}


def _commit_attn_entry(entry, lengths, path_slots, table=None):
    """Commit one attention layer: the best path's rows, read from the
    in-flight rows, land at [len, len+K1) of every unit, in place, through
    one ``commit_path_stacked`` launch for every unit and cache leaf on the
    card (dense: K4, paged through ``table``: K5; its plain version on the
    CPU).  Under int8 the rows are re-quantized on the way: quantization is
    deterministic and idempotent on fake-quantized values, so the committed
    bytes are the values verification attended over.  entry: k/v
    [nu, B, S, Hkv, D] (or pools) (+ scales) and k_new/v_new, decode's
    tuples of nu [B, T, Hkv, D] (or a stacked [nu, B, T, Hkv, D]);
    path_slots [B, K1]."""
    leaves = {n: entry[n] for n in ("k", "v", "k_scale", "v_scale")
              if n in entry}
    return commit_path_stacked(
        leaves, {"k": entry["k_new"], "v": entry["v_new"]}, path_slots,
        lengths, table=table)


def prefix_index(eff):
    """(rows, index into the per-token states, rows kept at the root) of
    a select of the state after ``eff`` [B] tokens, made once for every
    leaf a commit selects."""
    rows = torch.arange(eff.shape[0], device=eff.device)
    return rows, torch.clamp(eff - 1, min=0).long(), eff == 0


def select_prefix(root, states, index):
    """The state after ``eff`` tokens of the chain (``index`` =
    ``prefix_index(eff)``): ``root`` [B, ...] (the state before it) where
    ``eff`` is 0, else ``states`` [B, T, ...] at eff - 1; the reference's
    select over the root prepended to the per-token states, as a copy of
    the values it picks."""
    rows, idx, at_root = index
    at_root = at_root.reshape((-1,) + (1,) * (root.dim() - 1))
    return torch.where(at_root, root, states[rows, idx].to(root.dtype))


def _commit_ssm_entry(entry, eff):
    """Commit one SSM position: each unit's state becomes the state after
    ``eff`` [B] tokens of the chain (the speculation root, bit for bit,
    where ``eff`` is 0), copied in place.  An entry whose decode kept its
    state already (``decode(ssm_keep=)``) has nothing to select."""
    index = prefix_index(eff)
    for name in SSM.STATE_LEAVES:
        for u, states in enumerate(entry.get(name + "_new", ())):
            root = entry[name][u]
            root.copy_(select_prefix(root, states, index))
    return {n: entry[n] for n in SSM.STATE_LEAVES}


def commit(cfg: ModelConfig, spec_cache, lengths, path_slots, acc,
           active=None):
    """Zero-copy compaction: keep exactly the accepted prefix.

    path_slots [B, K+1]: tree-node slots of the best path (0..T-1); acc [B]
    in [1, K+1].  Attention positions: the best path's KV rows land at
    [len, len+K+1) in place (rows past ``acc`` are dead and are
    overwritten later).  SSM positions: the state after ``acc`` tokens of
    the chain is copied over the speculation root.  ``active`` [B] bool
    (optional) is the serving scheduler's masked commit: rows of inactive
    slots do not advance their lengths.  Their attention rows are still
    written by the same launch (the reference's dead-write rule): a dense
    slot's rows are replaced whole at its next admission, and a paged
    slot that is inactive has a zeroed table row, so its rows land in
    trash block 0.  An SSM state has no such sink, so an inactive row
    keeps its root state (effective acc 0), bit for bit.  Returns (cache,
    lengths + where(active, acc, 0)); the cache keeps ``_pages``.
    """
    layers, pages = split_pages(spec_cache)
    table = None if pages is None else pages["table"]
    adv = acc if active is None else torch.where(active, acc,
                                                 torch.zeros_like(acc))
    cache = {}
    for pos, entry in layers.items():
        if is_attn_entry(entry):
            cache[pos] = _commit_attn_entry(entry, lengths, path_slots,
                                            table=table)
        else:
            cache[pos] = _commit_ssm_entry(entry, adv)
    if pages is not None:
        cache[PAGES_KEY] = pages
    return cache, lengths + adv
