"""The dense decoder's plain forward (openPangu-7B), from the
configuration's file: token embedding; per layer x += Wo attn(RoPE(Wq h),
RoPE(Wk h), Wv h) with h = RMSNorm(x), causal, each kv head shared by
Hq / Hkv consecutive query heads; x += W_down (silu(W_gate h) * W_up h)
with h = RMSNorm(x); logits = lm_head RMSNorm(x).  RoPE rotates the two
halves of each head: (x1 cos - x2 sin, x2 cos + x1 sin) at the angle
pos * theta^(-j / (hd / 2)).  Everything in float32, a layer's weights
cast from the benchmark's tensors when the layer runs."""
from __future__ import annotations

import math

import torch

from perfbench.reference.common import (full_f32, matmul, read_logits,
                                        rms_norm, silu)


def _rope_tables(S: int, hd: int, theta: float, device):
    half = hd // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float64) / half)
    ang = torch.arange(S, dtype=torch.float64)[:, None] * inv[None, :]
    return (torch.cos(ang).float().to(device),
            torch.sin(ang).float().to(device))


def _rope(x, cos, sin):
    """x [n, S, H, hd]; cos / sin [S, hd / 2]."""
    h = x.shape[-1] // 2
    x1, x2 = x[..., :h], x[..., h:]
    c, s = cos[None, :, None, :], sin[None, :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def _causal_attention(q, k, v, block: int = 512):
    """One sequence: q [S, Hq, hd], k / v [S, Hkv, hd] -> [S, Hq, hd],
    a block of queries at a time."""
    S, hq, hd = q.shape
    G = hq // k.shape[1]
    k = k.repeat_interleave(G, dim=1).transpose(0, 1)       # [Hq, S, hd]
    v = v.repeat_interleave(G, dim=1).transpose(0, 1)
    out = torch.empty_like(q)
    keys = torch.arange(S, device=q.device)
    for t0 in range(0, S, block):
        t1 = min(S, t0 + block)
        qb = q[t0:t1].transpose(0, 1)                         # [Hq, b, hd]
        s = (qb @ k[:, :t1].transpose(1, 2)) / math.sqrt(hd)  # [Hq, b, t1]
        rows = torch.arange(t0, t1, device=q.device)
        s = s.masked_fill(keys[None, :t1] > rows[:, None], float("-inf"))
        out[t0:t1] = (torch.softmax(s, dim=-1) @ v[:, :t1]).transpose(0, 1)
    return out


def logits(w: dict, cfg: dict, seqs, reads, precision: str = "f32"):
    """Logits of each sequence in ``seqs`` (lists of token ids) at the
    positions ``reads`` gives it, (first, count): [count, V] f32 rows,
    row j the logits after token first + j.  ``precision`` "f32", or
    "fp8" for the control."""
    full_f32()
    L, d = cfg["num_layers"], cfg["d_model"]
    hq, hkv, hd = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
    eps = cfg["norm_eps"]
    dev = w["embed"].device
    n, S = len(seqs), max(len(s) for s in seqs)
    tok = torch.zeros((n, S), dtype=torch.long)
    for i, s in enumerate(seqs):
        tok[i, :len(s)] = torch.as_tensor(s, dtype=torch.long)
    x = w["embed"][tok.to(dev)].float()
    cos, sin = _rope_tables(S, hd, cfg["rope_theta"], dev)
    for layer in range(L):
        h = rms_norm(x, w["attn_norm"][layer], eps)
        q = _rope(matmul(h, w["wq"][layer], precision).view(n, S, hq, hd),
                  cos, sin)
        k = _rope(matmul(h, w["wk"][layer], precision).view(n, S, hkv, hd),
                  cos, sin)
        v = matmul(h, w["wv"][layer], precision).view(n, S, hkv, hd)
        att = torch.zeros_like(q)
        for i, s in enumerate(seqs):
            m = len(s)
            att[i, :m] = _causal_attention(q[i, :m], k[i, :m], v[i, :m])
        del q, k, v, h
        x = x + matmul(att.view(n, S, hq * hd), w["wo"][layer], precision)
        del att
        h = rms_norm(x, w["mlp_norm"][layer], eps)
        a = silu(matmul(h, w["w_gate"][layer], precision))
        a = a * matmul(h, w["w_up"][layer], precision)
        del h
        x = x + matmul(a, w["w_down"][layer], precision)
        del a
    x = rms_norm(x, w["final_norm"], eps).view(n * S, d)
    rows = torch.cat([i * S + first + torch.arange(count)
                      for i, (first, count) in enumerate(reads)]).to(dev)
    out = read_logits(x, w["lm_head"], rows, precision)
    return list(torch.split(out, [c for _, c in reads]))
