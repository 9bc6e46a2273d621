"""Mamba-2's plain forward (mamba2-2.7b), from the configuration's file:
token embedding; per layer, with h = RMSNorm(x): z = W_z h, x' =
silu(conv_x(W_x h)), [B | C] = silu(conv_bc([W_B h | W_C h])) (depthwise
causal convolutions of width W, bias added), dt = softplus(W_dt h +
dt_bias), A = -exp(A_log); the recurrence, one state [P, N] a head (P
channels of x' each, B and C shared by every head),
    s_t = exp(dt_t A) s_{t-1} + dt_t x'_t B_t^T,   y_t = s_t C_t + D x'_t,
then x += W_out RMSNorm_gate(y * silu(z)); logits = lm_head RMSNorm(x).
The recurrence is evaluated a chunk of tokens at a time, exactly: within
a chunk as the sum over earlier tokens of the decays between them,
across chunks through the state.  Everything in float32."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from perfbench.reference.common import (full_f32, matmul, read_logits,
                                        rms_norm, silu)

CHUNK = 64


def softplus(x):
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))


def _conv(x, w, b):
    """Depthwise causal convolution: x [n, S, C], w [C, W], b [C];
    out[t] = b + sum_j w[:, j] x[t - (W - 1) + j]."""
    W = w.shape[1]
    xt = F.pad(x.transpose(1, 2), (W - 1, 0))
    y = F.conv1d(xt, w.float()[:, None, :], b.float(), groups=w.shape[0])
    return y.transpose(1, 2)


def _scan(x, dt, A, Bm, Cm):
    """x [n, S, H, P], dt [n, S, H], A [H], Bm / Cm [n, S, N] -> y
    [n, S, H, P] (without the D skip)."""
    n, S, H, P = x.shape
    N = Bm.shape[-1]
    s = x.new_zeros((n, H, P, N))
    ys = []
    for c0 in range(0, S, CHUNK):
        xs, dts = x[:, c0:c0 + CHUNK], dt[:, c0:c0 + CHUNK]
        Bs, Cs = Bm[:, c0:c0 + CHUNK], Cm[:, c0:c0 + CHUNK]
        Q = xs.shape[1]
        cum = torch.cumsum(dts * A, dim=1)                      # [n, Q, H]
        diff = cum[:, :, None, :] - cum[:, None, :, :]          # [n, t, u, H]
        past = torch.ones((Q, Q), dtype=torch.bool,
                          device=x.device).tril()[None, :, :, None]
        decay = torch.exp(torch.where(past, diff, float("-inf")))
        cb = torch.einsum("ntk,nuk->ntu", Cs, Bs)
        y = torch.einsum("ntuh,nuh,nuhp->nthp", cb[..., None] * decay, dts,
                         xs)
        y = y + torch.exp(cum)[..., None] * torch.einsum("ntk,nhpk->nthp",
                                                         Cs, s)
        to_end = torch.exp(cum[:, -1:] - cum) * dts             # [n, Q, H]
        s = (torch.exp(cum[:, -1])[:, :, None, None] * s
             + torch.einsum("nuh,nuk,nuhp->nhpk", to_end, Bs, xs))
        ys.append(y)
    return torch.cat(ys, dim=1)


def logits(w: dict, cfg: dict, seqs, reads, precision: str = "f32"):
    """As ``reference.dense.logits``, for the Mamba-2 stack."""
    full_f32()
    L, d = cfg["num_layers"], cfg["d_model"]
    N, P = cfg["ssm_state"], cfg["ssm_head_dim"]
    d_in = cfg["ssm_expand"] * d
    H = d_in // P
    eps = cfg["norm_eps"]
    dev = w["embed"].device
    n, S = len(seqs), max(len(s) for s in seqs)
    tok = torch.zeros((n, S), dtype=torch.long)
    for i, s in enumerate(seqs):
        tok[i, :len(s)] = torch.as_tensor(s, dtype=torch.long)
    x = w["embed"][tok.to(dev)].float()
    for layer in range(L):
        h = rms_norm(x, w["norm"][layer], eps)
        z = matmul(h, w["w_z"][layer], precision)
        xc = silu(_conv(matmul(h, w["w_x"][layer], precision),
                        w["conv_x"][layer], w["conv_x_b"][layer]))
        bc = torch.cat([matmul(h, w["w_B"][layer], precision),
                        matmul(h, w["w_C"][layer], precision)], dim=-1)
        bc = silu(_conv(bc, w["conv_bc"][layer], w["conv_bc_b"][layer]))
        dt = softplus(matmul(h, w["w_dt"][layer], precision)
                      + w["dt_bias"][layer].float())
        A = -torch.exp(w["A_log"][layer].float())
        xs = xc.view(n, S, H, P)
        y = _scan(xs, dt, A, bc[..., :N], bc[..., N:])
        y = y + w["D"][layer].float()[None, None, :, None] * xs
        y = rms_norm(y.reshape(n, S, d_in) * silu(z), w["gate_norm"][layer],
                     eps)
        x = x + matmul(y, w["w_out"][layer], precision)
    x = rms_norm(x, w["final_norm"], eps).view(n * S, d)
    rows = torch.cat([i * S + first + torch.arange(count)
                      for i, (first, count) in enumerate(reads)]).to(dev)
    out = read_logits(x, w["lm_head"], rows, precision)
    return list(torch.split(out, [c for _, c in reads]))
