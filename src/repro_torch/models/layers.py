"""Core transformer layers in PyTorch: norms, RoPE, GQA attention (prefill
and the cached tree-decode mask) and the gated MLP.

Counterpart of ``repro.models.layers``, dense subset.  Functions keep the
reference's names, argument order and tensor layouts (``wq [d, Hq, hd]``,
activations ``[B, S, H, D]``) and repeat its dtype casts in the same
places, so a float32 run agrees with the reference to rounding.
Parameters are plain dicts of tensors.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.runtime import torch_dtype

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# init helpers (shapes and scales of the reference, not its random bits)
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, shape, dtype, scale=None, stack: int = 0):
    """Normal(0, 1) * scale, with the reference's fan-in rule: scale
    defaults to 1/sqrt(shape[0]).  ``stack`` > 0 prepends a layer axis of
    that size (the stacked ``params["units"]`` leaves)."""
    fan_in = shape[0] if len(shape) >= 2 else max(shape[0], 1)
    scale = (1.0 / math.sqrt(fan_in)) if scale is None else scale
    full = ((stack,) if stack else ()) + tuple(shape)
    w = torch.randn(full, generator=gen, dtype=dtype, device=gen.device)
    return w.mul_(torch.tensor(scale, dtype=dtype))


def init_norm(cfg: ModelConfig, device, stack: int = 0):
    if cfg.norm != "rmsnorm":
        raise NotImplementedError(
            f"norm {cfg.norm!r}: the port's first slice carries RMSNorm only "
            f"(other families are ROADMAP queue 1 item 14)")
    shape = ((stack,) if stack else ()) + (cfg.d_model,)
    return {"w": torch.ones(shape, dtype=torch.float32, device=device)}


def init_attention(gen: torch.Generator, cfg: ModelConfig, stack: int = 0):
    d, hq, hkv, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                      cfg.resolved_head_dim)
    dt = torch_dtype(cfg.param_dtype)
    if cfg.qkv_bias:
        raise NotImplementedError(
            "qkv_bias: the port's first slice carries openPangu-7B, which "
            "has none (other architectures are ROADMAP queue 1 item 14)")
    return {
        "wq": dense_init(gen, (d, hq, hd), dt, stack=stack),
        "wk": dense_init(gen, (d, hkv, hd), dt, stack=stack),
        "wv": dense_init(gen, (d, hkv, hd), dt, stack=stack),
        "wo": dense_init(gen, (hq, hd, d), dt, stack=stack),
    }


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


def apply_norm(params, x, cfg: ModelConfig):
    if "b" in params:
        raise NotImplementedError(
            "LayerNorm: the port's first slice carries RMSNorm only (other "
            "families are ROADMAP queue 1 item 14)")
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
        scores = torch.where(mask[:, None, None], scores,
                             torch.tensor(NEG_INF, dtype=scores.dtype,
                                          device=scores.device))
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


def attention_full(p, x, cfg: ModelConfig, return_kv=False):
    """Full-sequence causal attention (prefill); sequences longer than 8192
    that split into 1024-row blocks go through ``_blockwise_causal``."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    q, k, v = _project_qkv(p, x, cfg)
    if cfg.use_rope:
        positions = torch.arange(S, device=x.device)[None, :]
        cos, sin = rope_cos_sin(positions, hd, cfg.rope_theta)
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    scale = 1.0 / math.sqrt(hd)
    if S > 8192 and S % 1024 == 0:
        out = _blockwise_causal(q, k, v, scale, block=1024)
    else:
        idx = torch.arange(S, device=x.device)
        mask = (idx[None, :] <= idx[:, None])[None]
        out = _gqa_scores_to_out(q, k, v, mask, scale)
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype))
    if return_kv:
        return y, (k, v)
    return y


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
    return torch.einsum("bsf,fd->bsd", h, p["wo"].to(x.dtype))
