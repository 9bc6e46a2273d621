"""Mamba2 (SSD, state-space duality) mixer in plain PyTorch, counterpart of
``repro.models.ssm``.

The reference computes the mixer in plain ``jnp`` (no Pallas kernel
touches it), so this module is its port as it stands.  Prefill and
training run the chunked SSD algorithm (the quadratic intra-chunk dual
plus the inter-chunk state recurrence, a Python loop over chunks where
the reference scans); decode runs the linear recurrence over the T chain
tokens of a speculative step, a Python loop over tokens, and returns the
state after every token, so commit can keep exactly the accepted number
without running the backbone again.  ``mamba2_decode(keep=)`` keeps,
inside that loop, only the state after a number of tokens known before
the call (a suffix prefill's), never the [B, T, ...] per-token states.

Leaf names and layouts are the reference's, so ``bridge.to_torch``
carries its trees across: ``wz``/``wx`` [d, d_inner], ``wB``/``wC``
[d, N], ``wdt`` [d, H], ``conv_x`` [d_inner, W], ``conv_bc`` [2N, W]
(+ their biases), the f32 ``A_log``, ``dt_bias``, ``D`` [H] and
``norm_w`` [d_inner], and ``out_proj`` [d_inner, d].
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import dense_init, rms_norm
from repro_torch.runtime import torch_dtype

# the per-slot recurrent state of one SSM position: the raw conv windows'
# last W-1 inputs (activation dtype) and the SSD state (f32)
STATE_LEAVES = ("conv_x", "conv_bc", "ssm")


def init_mamba2(gen: torch.Generator, cfg: ModelConfig, stack: int = 0):
    """One mixer's weights on ``gen.device`` (stacked over ``stack`` units
    when > 0), with the reference's shapes, dtypes and init rules: dt's
    bias the inverse softplus of dt drawn log-uniform in [1e-3, 1e-1],
    ``A_log`` the log of a draw in [1, 16), ``D`` and ``norm_w`` ones."""
    d, d_in = cfg.d_model, cfg.d_inner
    N, H, W = cfg.ssm_state, cfg.ssm_heads, cfg.ssm_conv
    dt = torch_dtype(cfg.param_dtype)
    dev = gen.device
    lead = (stack,) if stack else ()
    f32 = dict(dtype=torch.float32, device=dev)
    u = torch.rand(lead + (H,), generator=gen, **f32)
    dt_init = torch.exp(math.log(1e-3) + u * (math.log(1e-1) - math.log(1e-3)))
    dt_bias = dt_init + torch.log(-torch.expm1(-dt_init))
    a = 1.0 + 15.0 * torch.rand(lead + (H,), generator=gen, **f32)
    return {
        "wz": dense_init(gen, (d, d_in), dt, stack=stack),
        "wx": dense_init(gen, (d, d_in), dt, stack=stack),
        "wB": dense_init(gen, (d, N), dt, stack=stack),
        "wC": dense_init(gen, (d, N), dt, stack=stack),
        "wdt": dense_init(gen, (d, H), dt, stack=stack),
        "conv_x": dense_init(gen, (d_in, W), dt, scale=1.0 / math.sqrt(W),
                             stack=stack),
        "conv_x_b": torch.zeros(lead + (d_in,), dtype=dt, device=dev),
        "conv_bc": dense_init(gen, (2 * N, W), dt, scale=1.0 / math.sqrt(W),
                              stack=stack),
        "conv_bc_b": torch.zeros(lead + (2 * N,), dtype=dt, device=dev),
        "A_log": torch.log(a),
        "dt_bias": dt_bias,
        "D": torch.ones(lead + (H,), **f32),
        "norm_w": torch.ones(lead + (d_in,), **f32),
        "out_proj": dense_init(gen, (d_in, d), dt, stack=stack),
    }


def softplus(x):
    """``jax.nn.softplus`` (``logaddexp(x, 0)``): max(x, 0) +
    log1p(exp(-|x|)) at every x, where ``F.softplus`` turns into the
    identity above its threshold."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-torch.abs(x)))


def _causal_conv(x, w, b, W: int):
    """Depthwise causal conv via W static shifts. x [B, S, C], w [C, W]."""
    pads = F.pad(x, (0, 0, W - 1, 0))
    S = x.shape[1]
    y = torch.zeros_like(x)
    for i in range(W):
        y = y + pads[:, i: i + S, :] * w[:, i]
    return F.silu(y + b)


def _project(p, x):
    """x [B, S, d] -> (z, x_raw, bc_raw, dt_raw)."""
    z = torch.einsum("bsd,di->bsi", x, p["wz"].to(x.dtype))
    xr = torch.einsum("bsd,di->bsi", x, p["wx"].to(x.dtype))
    bc = torch.einsum("bsd,dn->bsn", x,
                      torch.cat([p["wB"], p["wC"]], dim=1).to(x.dtype))
    dtr = torch.einsum("bsd,dh->bsh", x, p["wdt"].to(x.dtype))
    return z, xr, bc, dtr


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int, initial_state=None):
    """Chunked SSD.  x [B, S, H, P], dt [B, S, H] (after softplus), A [H]
    (negative), Bm/Cm [B, S, N].  Returns (y [B, S, H, P] in x's dtype,
    final_state [B, H, P, N] f32).  S is padded up to a multiple of the
    chunk with dt = 0 (decay 1, no update: the state passes through)."""
    B_, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    pad = (-S) % Q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    nc = (S + pad) // Q
    f32 = torch.float32
    xc = x.reshape(B_, nc, Q, H, P)
    dtc = dt.reshape(B_, nc, Q, H).to(f32)
    Bc = Bm.reshape(B_, nc, Q, N).to(f32)
    Cc = Cm.reshape(B_, nc, Q, N).to(f32)

    dA = dtc * A                                           # [B,nc,Q,H]
    cs = torch.cumsum(dA, dim=2)
    seg = cs[:, :, :, None, :] - cs[:, :, None, :, :]      # [B,nc,Q,Q,H]
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    L = torch.exp(torch.where(causal[None, None, :, :, None], seg,
                              torch.tensor(-math.inf, device=x.device)))
    scores = torch.einsum("bcqn,bctn->bcqt", Cc, Bc)
    M = scores[..., None] * L                              # [B,nc,Q,Q,H]
    xdt = xc.to(f32) * dtc[..., None]                      # [B,nc,Q,H,P]
    y_diag = torch.einsum("bcqth,bcthp->bcqhp", M, xdt)

    decay_to_end = torch.exp(cs[:, :, -1:, :] - cs)        # [B,nc,Q,H]
    states = torch.einsum("bctn,bcth,bcthp->bchpn", Bc, decay_to_end * dtc,
                          xc.to(f32))
    chunk_decay = torch.exp(cs[:, :, -1, :])               # [B,nc,H]

    s = (torch.zeros((B_, H, P, N), dtype=f32, device=x.device)
         if initial_state is None else initial_state.to(f32))
    prev = []
    for c in range(nc):                     # the reference's lax.scan
        prev.append(s)
        s = s * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                 # [B,nc,H,P,N]
    y_off = torch.einsum("bcqn,bchpn->bcqhp", Cc,
                         prev_states) * torch.exp(cs)[..., None]
    y = (y_diag + y_off).reshape(B_, nc * Q, H, P)[:, :S]
    return y.to(x.dtype), s


def _gate_out(p, y, z, x_dtype):
    """The gated RMSNorm and the output projection: y [B, S, d_in]."""
    y = rms_norm(y * F.silu(z.float()).to(y.dtype), p["norm_w"])
    return torch.einsum("bsi,id->bsd", y, p["out_proj"].to(x_dtype))


def mamba2_full(p, x, cfg: ModelConfig, return_state: bool = False,
                valid=None, lengths=None):
    """Train / prefill forward.  x [B, S, d] -> y [B, S, d] (+ states).

    ``valid`` [B, S] bool freezes the recurrence at padded positions (dt
    masked to 0: decay 1, no update), so the final state is the state at
    each row's true length; ``lengths`` [B] picks each row's last W-1 raw
    conv inputs below its length as the decode conv state.  With
    ``return_state``: (y, (conv_x [B, d_in, W-1], conv_bc [B, 2N, W-1],
    ssm [B, H, P, N] f32))."""
    B, S, _ = x.shape
    d_in, N, H, P, W = (cfg.d_inner, cfg.ssm_state, cfg.ssm_heads,
                        cfg.ssm_head_dim, cfg.ssm_conv)
    z, x_raw, bc_raw, dt_raw = _project(p, x)
    xc = _causal_conv(x_raw, p["conv_x"].to(x.dtype),
                      p["conv_x_b"].to(x.dtype), W)
    bcc = _causal_conv(bc_raw, p["conv_bc"].to(x.dtype),
                       p["conv_bc_b"].to(x.dtype), W)
    xs = xc.reshape(B, S, H, P)
    Bm, Cm = bcc[..., :N], bcc[..., N:]
    dt = softplus(dt_raw.float() + p["dt_bias"])
    if valid is not None:
        dt = dt * valid[..., None].float()
    A = -torch.exp(p["A_log"])
    y, final = ssd_chunked(xs, dt, A, Bm, Cm, cfg.ssm_chunk)
    y = y + p["D"].to(x.dtype)[None, None, :, None] * xs
    out = _gate_out(p, y.reshape(B, S, d_in), z, x.dtype)
    if not return_state:
        return out
    if lengths is None:
        lengths = torch.full((B,), S, dtype=torch.int32, device=x.device)
    idx = (lengths.long()[:, None]
           + torch.arange(W - 1, device=x.device)[None, :])  # [B, W-1]

    def tail(r):
        padded = F.pad(r, (0, 0, W - 1, 0))
        rows = torch.arange(B, device=x.device)[:, None]
        return padded[rows, idx].transpose(1, 2)             # [B, C, W-1]
    return out, (tail(x_raw), tail(bc_raw), final)


def mamba2_decode(p, x, cfg: ModelConfig, conv_x_st, conv_bc_st, ssm_state,
                  keep=None):
    """Chain-decode T tokens with the linear recurrence, a loop over them.

    x [B, T, d]; conv_x_st [B, d_in, W-1]; conv_bc_st [B, 2N, W-1];
    ssm_state [B, H, P, N] f32: the state before the chain.  Returns
    (y [B, T, d], states).  Without ``keep`` the states are the
    per-prefix states (conv_x [B, T, d_in, W-1], conv_bc [B, T, 2N, W-1],
    ssm [B, T, H, P, N]), index t holding the state *after* token t.
    With ``keep`` [B] int (0..T) they are each row's state after
    ``keep`` tokens (0: the state given), selected inside the loop, so
    the T axis is never held: the values equal the per-prefix states'
    select bit for bit."""
    B, T, _ = x.shape
    N, H, P = cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    z, x_raw, bc_raw, dt_raw = _project(p, x)
    A = -torch.exp(p["A_log"])
    cw_x, cb_x = p["conv_x"].to(x.dtype), p["conv_x_b"].to(x.dtype)
    cw_bc, cb_bc = p["conv_bc"].to(x.dtype), p["conv_bc_b"].to(x.dtype)
    # elementwise in the token, so computing every token's at once gives
    # the values the reference's scan body computes one token at a time
    dts = softplus(dt_raw.float() + p["dt_bias"])            # [B, T, H]
    decays = torch.exp(dts * A)
    cx, cbc, sst = conv_x_st, conv_bc_st, ssm_state.float()
    kept = (cx, cbc, sst)
    ys, per_token = [], []
    for t in range(T):
        win_x = torch.cat([cx, x_raw[:, t, :, None]], dim=-1)   # [B,d_in,W]
        win_bc = torch.cat([cbc, bc_raw[:, t, :, None]], dim=-1)
        xt = F.silu(torch.sum(win_x * cw_x, dim=-1) + cb_x).reshape(B, H, P)
        bct = F.silu(torch.sum(win_bc * cw_bc, dim=-1) + cb_bc)
        Bt, Ct = bct[:, :N].float(), bct[:, N:].float()
        dt = dts[:, t]
        xf = xt.float()
        upd = (dt[:, :, None, None] * xf[:, :, :, None]) * Bt[:, None, None, :]
        sst = sst * decays[:, t, :, None, None] + upd
        y_t = torch.einsum("bn,bhpn->bhp", Ct, sst)
        y_t = y_t + p["D"][None, :, None] * xf
        ys.append(y_t.to(x.dtype))
        cx, cbc = win_x[:, :, 1:], win_bc[:, :, 1:]
        if keep is None:
            per_token.append((cx, cbc, sst))
        else:
            at = keep == t + 1
            kept = tuple(torch.where(at.reshape((B,) + (1,) * (n.dim() - 1)),
                                     n, k)
                         for n, k in zip((cx, cbc, sst), kept))
    y = torch.stack(ys, dim=1).reshape(B, T, cfg.d_inner)
    out = _gate_out(p, y, z, x.dtype)
    if keep is not None:
        return out, kept
    return out, tuple(torch.stack(s, dim=1) for s in zip(*per_token))
