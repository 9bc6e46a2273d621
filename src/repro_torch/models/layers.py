"""Core transformer layers in PyTorch: norms (RMSNorm, LayerNorm), RoPE,
GQA attention (prefill, the encoder's full attention, cross-attention
and the cached tree-decode mask), the gated and plain MLPs and the top-k
MoE.

Counterpart of ``repro.models.layers``.  Functions keep the reference's
names, argument order and tensor layouts (``wq [d, Hq, hd]``, activations
``[B, S, H, D]``) and repeat its dtype casts in the same places, so a
float32 run agrees with the reference to rounding.
Parameters are plain dicts of tensors.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import collectives as C
from repro_torch.runtime import torch_dtype

NEG_INF = -1e30


def tp_reduce(y, cfg: ModelConfig):
    """Finish a row-parallel contraction under tensor parallelism.

    A config with a ``tp_axis`` (the local config ``distributed/tp.py``
    builds for each rank) holds this rank's slice of the heads or ff
    dimension just contracted, so the partial [B, S, d] output is summed
    over the axis, in place, before the residual add.  With an empty
    ``tp_axis`` no collective is issued and ``y`` is returned as it is."""
    if cfg.tp_axis:
        return C.psum_(y, cfg.tp_axis)
    return y


# ---------------------------------------------------------------------------
# init helpers (shapes and scales of the reference, not its random bits)
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, shape, dtype, scale=None, stack: int = 0):
    """Normal(0, 1) * scale; ``scale`` defaults to 1/sqrt(shape[0]), the
    fan-in of the contraction for a two-dimensional leaf and for the
    attention's ``wq`` / ``wk`` / ``wv`` [d, H, hd] (``wo`` [Hq, hd, d]
    at 1/sqrt(Hq)).  The reference takes shape[1] as the fan-in of every
    three-dimensional leaf, which is right for its stacked experts (the
    port passes their scale explicitly) and draws the attention's
    projections 11-23x larger at openPangu-7B's widths: a random model
    whose bf16 logits a half-ulp perturbation moves by whole units, on
    which no bf16 comparison can hold (ROADMAP.md §3, "Reference
    caveats").  ``stack`` > 0 prepends a layer axis of that size (the
    stacked ``params["units"]`` leaves)."""
    fan_in = shape[0] if len(shape) >= 2 else max(shape[0], 1)
    scale = (1.0 / math.sqrt(fan_in)) if scale is None else scale
    full = ((stack,) if stack else ()) + tuple(shape)
    w = torch.randn(full, generator=gen, dtype=dtype, device=gen.device)
    return w.mul_(torch.tensor(scale, dtype=dtype))


def init_norm(cfg: ModelConfig, device, stack: int = 0):
    """RMSNorm's ``w`` = 1, and for LayerNorm also ``b`` = 0, in f32."""
    shape = ((stack,) if stack else ()) + (cfg.d_model,)
    p = {"w": torch.ones(shape, dtype=torch.float32, device=device)}
    if cfg.norm == "layernorm":
        p["b"] = torch.zeros(shape, dtype=torch.float32, device=device)
    elif cfg.norm != "rmsnorm":
        raise ValueError(f"unknown norm {cfg.norm!r}")
    return p


def init_attention(gen: torch.Generator, cfg: ModelConfig, stack: int = 0):
    d, hq, hkv, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                      cfg.resolved_head_dim)
    dt = torch_dtype(cfg.param_dtype)
    p = {
        "wq": dense_init(gen, (d, hq, hd), dt, stack=stack),
        "wk": dense_init(gen, (d, hkv, hd), dt, stack=stack),
        "wv": dense_init(gen, (d, hkv, hd), dt, stack=stack),
        "wo": dense_init(gen, (hq, hd, d), dt, stack=stack),
    }
    if cfg.qkv_bias:
        lead = (stack,) if stack else ()
        for name, h in (("bq", hq), ("bk", hkv), ("bv", hkv)):
            p[name] = torch.zeros(lead + (h, hd), dtype=dt, device=gen.device)
    return p


def init_mlp(gen: torch.Generator, cfg: ModelConfig, stack: int = 0):
    d, f = cfg.d_model, cfg.d_ff
    dt = torch_dtype(cfg.param_dtype)
    p = {"wi": dense_init(gen, (d, f), dt, stack=stack),
         "wo": dense_init(gen, (f, d), dt, stack=stack)}
    if cfg.gated_mlp:
        p["wg"] = dense_init(gen, (d, f), dt, stack=stack)
    return p


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rms_norm(x, w, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(torch.square(x), dim=-1, keepdim=True) + eps)
    return (x * w.float()).to(dt)


def layer_norm(x, w, b, eps: float = 1e-5):
    """LayerNorm in float32 (the reference's op order), cast back to
    ``x``'s dtype."""
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * w.float() + b.float()).to(dt)


def apply_norm(params, x, cfg: ModelConfig):
    if "b" in params:
        return layer_norm(x, params["w"], params["b"])
    return rms_norm(x, params["w"])


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_cos_sin(positions, head_dim: int, theta: float):
    """positions [...] int -> cos/sin [..., head_dim//2] float32."""
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32,
                        device=positions.device) / half
    freqs = 1.0 / (torch.tensor(theta, dtype=torch.float32) ** exps)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x [..., S, H, D]; cos/sin broadcastable [..., S, 1, D/2]
    (half-rotation, the reference's float32 op order)."""
    d = x.shape[-1]
    dt = x.dtype
    x1, x2 = x[..., : d // 2].float(), x[..., d // 2:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(dt)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _project_qkv(p, x, cfg: ModelConfig):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(x.dtype))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(x.dtype))
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    return q, k, v


def _gqa_scores_to_out(q, k, v, mask, scale):
    """q [B,T,Hq,D], k/v [B,S,Hkv,D], mask [B?,T,S] bool or None (full)."""
    B, T, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, T, Hkv, G, D)
    scores = torch.einsum("bthgd,bshd->bhgts", qg, k).float() * scale
    if mask is not None:
        if mask.dim() == 2:
            mask = mask[None]
        # a Python scalar: a tensor made on the device would be a copy
        # from host memory, which stream capture refuses
        scores = torch.where(mask[:, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhgts,bshd->bthgd", probs, v)
    return out.reshape(B, T, Hq, D)


def _blockwise_causal(q, k, v, scale, block: int):
    """Memory-lean causal attention, one query block at a time: scores
    take [B, H, block, S] instead of [B, H, S, S]."""
    B, S, Hq, D = q.shape
    s_idx = torch.arange(S, device=q.device)
    outs = []
    for start in range(0, S, block):
        t_idx = start + torch.arange(block, device=q.device)
        mask = s_idx[None, :] <= t_idx[:, None]            # [block, S]
        outs.append(_gqa_scores_to_out(q[:, start:start + block], k, v,
                                       mask[None], scale))
    return torch.cat(outs, dim=1)


def attention_full(p, x, cfg: ModelConfig, positions=None, causal=True,
                   return_kv=False):
    """Full-sequence attention (train, prefill, and without ``causal`` the
    encoder's); causal sequences longer than 8192 that split into
    1024-row blocks go through ``_blockwise_causal``.  ``positions``
    [B or 1, S] are the RoPE positions (default 0..S-1)."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    q, k, v = _project_qkv(p, x, cfg)
    if cfg.use_rope:
        if positions is None:
            positions = torch.arange(S, device=x.device)[None, :]
        cos, sin = rope_cos_sin(positions, hd, cfg.rope_theta)
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    scale = 1.0 / math.sqrt(hd)
    if causal and S > 8192 and S % 1024 == 0:
        out = _blockwise_causal(q, k, v, scale, block=1024)
    else:
        mask = None
        if causal:
            idx = torch.arange(S, device=x.device)
            mask = (idx[None, :] <= idx[:, None])[None]
        out = _gqa_scores_to_out(q, k, v, mask, scale)
    y = tp_reduce(torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype)),
                  cfg)
    if return_kv:
        return y, (k, v)
    return y


def attention_cross(p, x, enc_kv, cfg: ModelConfig):
    """Cross-attention of ``x`` [B, S, d] against the encoder's k/v
    ``enc_kv`` ([B, F, Hkv, D] each), unmasked."""
    k, v = enc_kv
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype))
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)
    scale = 1.0 / math.sqrt(cfg.resolved_head_dim)
    out = _gqa_scores_to_out(q, k, v, None, scale)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype))


def cross_kv(p, enc_out, cfg: ModelConfig):
    """The cross-attention's k/v [B, F, Hkv, D] from the encoder's output
    [B, F, d], with the k/v biases."""
    k = torch.einsum("bsd,dhk->bshk", enc_out, p["wk"].to(enc_out.dtype))
    v = torch.einsum("bsd,dhk->bshk", enc_out, p["wv"].to(enc_out.dtype))
    if "bk" in p:
        k = k + p["bk"].to(enc_out.dtype)
        v = v + p["bv"].to(enc_out.dtype)
    return k, v


def decode_mask(tree_mask, length, T: int, S_max: int):
    """Static visibility mask for a tree-decode step.

    tree_mask [T, T] bool; ``length`` a scalar tensor or a [B] tensor of
    per-row lengths.  Key slot s is visible if s < length (committed past)
    or, for length <= s < length+T, per the tree topology.  Returns
    [T, S_max] bool for a scalar length, [B, T, S_max] for [B] lengths.
    """
    length = torch.as_tensor(length, device=tree_mask.device)[..., None]
    s_idx = torch.arange(S_max, device=tree_mask.device)
    past = s_idx < length                                  # [..., S]
    rel = s_idx - length
    within = (rel >= 0) & (rel < T)
    relc = torch.clamp(rel, 0, T - 1)                      # [..., S]
    tree_vals = tree_mask[:, relc]                         # [T, ..., S]
    tree_vals = torch.movedim(tree_vals, 0, -2)            # [..., T, S]
    return past[..., None, :] | (within[..., None, :] & tree_vals)


def attention_decode(p, x, cfg: ModelConfig, cache_k, cache_v, length,
                     tree_mask, depths, use_kernel: bool = False):
    """Cached tree-decode attention step with one length for every row
    (the scalar-length form of the reference, which has no caller there).

    x [B, T, d]; cache_k/v [B, S_max, Hkv, D]; ``length`` an int or a
    0-dim tensor.  The T tree rows are written in place at
    [length, length+T), the start clamped to S_max - T as the reference's
    ``dynamic_update_slice`` clamps it.  Returns (y, cache_k, cache_v)."""
    B, T, _ = x.shape
    S_max = cache_k.shape[1]
    hd = cfg.resolved_head_dim
    length = torch.as_tensor(length, device=x.device)
    q, k, v = _project_qkv(p, x, cfg)
    if cfg.use_rope:
        positions = (length + depths)[None, :]               # [1, T]
        cos, sin = rope_cos_sin(positions, hd, cfg.rope_theta)
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    rows = torch.clamp(length, max=S_max - T) + torch.arange(T,
                                                             device=x.device)
    cache_k.index_copy_(1, rows, k.to(cache_k.dtype))
    cache_v.index_copy_(1, rows, v.to(cache_v.dtype))
    scale = 1.0 / math.sqrt(hd)
    if use_kernel:
        from repro_torch.kernels.ops import tree_attention
        lengths = length.to(torch.int32).reshape(1).repeat(B)
        out = tree_attention(q, cache_k, cache_v, tree_mask, lengths, scale)
    else:
        mask = decode_mask(tree_mask, length, T, S_max)[None]
        out = _gqa_scores_to_out(q, cache_k.to(q.dtype), cache_v.to(q.dtype),
                                 mask, scale)
    y = tp_reduce(torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype)),
                  cfg)
    return y, cache_k, cache_v


def gqa_two_part(q, cache_k, cache_v, k_new, v_new, lengths, tree_mask,
                 scale):
    """Deferred-write tree attention: the committed cache swept with a
    col < length mask (its rows at and past ``lengths`` are stale, since
    this step writes none) merged exactly with the in-flight tree block
    ``k_new``/``v_new`` [B, T, Hkv, D] through the two parts'
    online-softmax statistics.  The only cache write left is commit's.

    q [B, T, Hq, D]; cache_k/v [B, S, Hkv, D] in q's dtype; lengths [B];
    tree_mask [T, T] bool.  Returns [B, T, Hq, D] in q.dtype.  The plain
    path of the deferred step; on the card the step runs
    ``kernels.ops.tree_attention`` with ``k_tree``/``v_tree`` instead."""
    B, T, Hq, D = q.shape
    S, Hkv = cache_k.shape[1], cache_k.shape[2]
    G = Hq // Hkv
    # a 0-dim CPU tensor multiplies as a scalar (no copy to the device)
    qg = q.reshape(B, T, Hkv, G, D) * torch.tensor(scale, dtype=q.dtype)
    # part 1: the committed past
    s1 = torch.einsum("bthgd,bshd->bhgts", qg, cache_k.to(q.dtype)).float()
    past = (torch.arange(S, device=q.device)[None, :]
            < lengths[:, None])[:, None, None, None]       # [B, 1, 1, 1, S]
    s1 = torch.where(past, s1, NEG_INF)
    m1 = torch.amax(s1, dim=-1, keepdim=True)
    p1 = torch.where(past, torch.exp(s1 - m1), 0.0)
    l1 = torch.sum(p1, dim=-1, keepdim=True)
    a1 = torch.einsum("bhgts,bshd->bhgtd", p1.to(q.dtype), cache_v.to(q.dtype))
    # part 2: the in-flight tree rows
    s2 = torch.einsum("bthgd,bshd->bhgts", qg, k_new.to(q.dtype)).float()
    s2 = torch.where(tree_mask, s2, NEG_INF)
    m2 = torch.amax(s2, dim=-1, keepdim=True)
    p2 = torch.where(tree_mask, torch.exp(s2 - m2), 0.0)
    l2 = torch.sum(p2, dim=-1, keepdim=True)
    a2 = torch.einsum("bhgts,bshd->bhgtd", p2.to(q.dtype), v_new.to(q.dtype))
    # the exact merge
    m = torch.maximum(m1, m2)
    w1, w2 = torch.exp(m1 - m), torch.exp(m2 - m)
    out = a1.float() * w1 + a2.float() * w2
    out = (out / torch.clamp(l1 * w1 + l2 * w2, min=1e-30)).to(q.dtype)
    return out.permute(0, 3, 1, 2, 4).reshape(B, T, Hq, D)


# ---------------------------------------------------------------------------
# MLP (dense)
# ---------------------------------------------------------------------------

def _act(x, kind: str):
    return F.gelu(x, approximate="tanh") if kind == "gelu" else F.silu(x)


def mlp(p, x, cfg: ModelConfig):
    h = torch.einsum("bsd,df->bsf", x, p["wi"].to(x.dtype))
    if "wg" in p:
        g = torch.einsum("bsd,df->bsf", x, p["wg"].to(x.dtype))
        h = h * _act(g, cfg.act)
    else:
        h = _act(h, cfg.act)
    return tp_reduce(torch.einsum("bsf,fd->bsd", h, p["wo"].to(x.dtype)),
                     cfg)


# ---------------------------------------------------------------------------
# MoE (static top-k dispatch with a fixed expert capacity)
# ---------------------------------------------------------------------------

def init_moe(gen: torch.Generator, cfg: ModelConfig, stack: int = 0):
    """Router [d, E] in float32 (the reference keeps it f32 whatever the
    parameter dtype), experts ``wi``/``wg`` [E, d, f] and ``wo`` [E, f, d]
    in ``cfg.param_dtype``, scaled by the reference's fan-in rule for
    stacked experts (the middle axis)."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    dt = torch_dtype(cfg.param_dtype)
    return {
        "router": dense_init(gen, (d, e), torch.float32, stack=stack),
        "wi": dense_init(gen, (e, d, f), dt, 1.0 / math.sqrt(d), stack),
        "wg": dense_init(gen, (e, d, f), dt, 1.0 / math.sqrt(d), stack),
        "wo": dense_init(gen, (e, f, d), dt, 1.0 / math.sqrt(f), stack),
    }


def _capacity(group_size: int, k: int, e: int, cf: float) -> int:
    c = int(math.ceil(group_size * k / e * cf))
    return max(8, -(-c // 8) * 8)  # round up to 8, floor 8


def top_k_first(x, k: int):
    """(values, indices) of the ``k`` largest entries along the last axis,
    largest first, a tie going to the lower index (``jax.lax.top_k``'s
    order).  ``torch.topk`` promises no order among equal values on the
    card; a stable descending sort keeps equal values in index order.  A
    hidden row of zeros (padding, an idle slot) routes with uniform
    probabilities: every expert ties, and this picks experts 0..k-1."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe(p, x, cfg: ModelConfig, group_size: int = 512):
    """Static-shape top-k MoE with one-hot dispatch and combine einsums,
    the reference's semantics: tokens in row-major [B, S] order form
    groups of min(group_size, B * S), the last zero-padded; the router
    runs in float32; each group queues its (token, slot) assignments per
    expert, token by token and slot by slot within a token, and an
    assignment whose queue position reaches the capacity C is dropped.
    The dispatch and combine tensors [G, s, E, C] are built in the
    activation dtype (so under bf16 the gates are rounded to bf16 before
    the combine).  Their shapes never depend on the routing, and nothing
    here reads a value back to the host, so the step stays capturable.
    The four stages are functions of their own (``moe_route``,
    ``moe_dispatch``, ``moe_experts``, ``moe_combine``), which
    ``launch/trace.py`` times apart.  Returns (y [B, S, d],
    router_logits [G, s, E] f32)."""
    B, S, d = x.shape
    n_tok = B * S
    g_sz = min(group_size, n_tok)
    pad = (-n_tok) % g_sz
    xf = x.reshape(n_tok, d)
    if pad:
        xf = torch.cat([xf, xf.new_zeros((pad, d))], dim=0)
    xg = xf.reshape(-1, g_sz, d)
    dispatch, combine, router_logits = moe_route(p, xg, cfg)
    eo = moe_experts(p, moe_dispatch(dispatch, xg), cfg)
    yf = moe_combine(combine, eo).reshape(-1, d)
    if pad:
        yf = yf[:n_tok]
    return yf.reshape(B, S, d), router_logits


def moe_route(p, xg, cfg: ModelConfig):
    """The router over the token groups xg [G, s, d]: (dispatch,
    combine [G, s, E, C] in xg's dtype, router_logits [G, s, E] f32)."""
    G, g_sz, _ = xg.shape
    E, K = cfg.num_experts, cfg.experts_per_tok
    router_logits = torch.einsum("gsd,de->gse", xg.float(),
                                 p["router"].float())
    probs = torch.softmax(router_logits, dim=-1)
    gate_vals, eids = top_k_first(probs, K)                   # [G, s, K]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)

    C = _capacity(g_sz, K, E, cfg.capacity_factor)
    experts = torch.arange(E, device=xg.device)
    slots = torch.arange(C, device=xg.device)
    oh = (eids[..., None] == experts).to(torch.int32)         # [G, s, K, E]
    # each expert's queue position: the exclusive count of its earlier
    # (token, slot) assignments, token by token, slot by slot; the scan
    # runs along the innermost axis of an [G, E, s * K] copy (a scan along
    # an outer axis is one slow serial kernel on the card)
    ohf = oh.reshape(G, g_sz * K, E).transpose(1, 2).contiguous()
    pos = (torch.cumsum(ohf, dim=-1, dtype=torch.int32) - ohf)
    pos = pos.transpose(1, 2).reshape(G, g_sz, K, E)

    dt = xg.dtype
    dispatch = xg.new_zeros((G, g_sz, E, C))
    combine = xg.new_zeros((G, g_sz, E, C))
    for slot in range(K):                                     # K is small
        slot_pos = torch.sum(pos[:, :, slot] * oh[:, :, slot], dim=-1)
        in_cap = slot_pos < C                                 # [G, s]
        # a position at or past C matches no slot: the drop
        d_slot = ((eids[:, :, slot, None] == experts).to(dt)[..., None]
                  * (slot_pos[..., None] == slots).to(dt)[:, :, None]
                  * in_cap[..., None, None].to(dt))
        # piecewise constant: no gradient flows through the mask
        d_slot = d_slot.detach()
        dispatch = dispatch + d_slot
        combine = combine + d_slot * gate_vals[:, :, slot, None,
                                               None].to(dt)
    return dispatch, combine, router_logits


def moe_dispatch(dispatch, xg):
    """Each expert's capacity rows [E, G, C, d] from the groups' tokens."""
    return torch.einsum("gsec,gsd->egcd", dispatch, xg)


def moe_experts(p, expert_in, cfg: ModelConfig):
    """The experts' gated MLPs on their rows: (x wi) * act(x wg) wo."""
    wi, wg, wo = (p[n].to(expert_in.dtype) for n in ("wi", "wg", "wo"))
    h = torch.einsum("egcd,edf->egcf", expert_in, wi)
    h = h * _act(torch.einsum("egcd,edf->egcf", expert_in, wg), cfg.act)
    return torch.einsum("egcf,efd->egcd", h, wo)


def moe_combine(combine, eo):
    """The tokens' outputs [G, s, d]: each expert row back to its token,
    weighted by its renormalised gate."""
    return torch.einsum("gsec,egcd->gsd", combine, eo)


def moe_aux_loss(router_logits, eids_unused=None):
    """Load-balance auxiliary loss (Switch-style): E * sum(f_e * p_e),
    f_e the fraction of tokens whose top-1 expert is e, p_e the mean
    router probability of e (padded rows included, as in the
    reference)."""
    probs = torch.softmax(router_logits, dim=-1)
    E = probs.shape[-1]
    top1 = torch.argmax(probs, dim=-1)
    f = torch.mean((top1[..., None] == torch.arange(E, device=probs.device))
                   .float(), dim=(0, 1))
    pbar = torch.mean(probs, dim=(0, 1))
    return E * torch.sum(f * pbar)
