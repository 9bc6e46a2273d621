"""Token-level sampling (counterpart of ``repro.core.sampling``).

Fixed-shape tensor algebra that runs inside the engine's captured step.
The same warp (temperature / top-k / top-p) is applied to every
distribution that enters a rejection-sampling identity, so acceptance
preserves the warped target distribution exactly.  ``temperature <= 0``
gives a one-hot at the argmax, which makes greedy the temperature-0 limit
of every path rather than a separate branch.

Randomness is an argument.  Where the reference takes a PRNG key, each
function here takes its noise as a tensor: Gumbel noise ``g`` (shaped like
the logits) for a categorical draw, which is ``argmax(logits + g)``, the
form ``jax.random.categorical`` computes.  The caller draws the noise from
an explicit ``torch.Generator`` (``gumbel``, ``uniform``), so a test can
feed the reference's own draws in and compare the outcomes exactly.
"""
from __future__ import annotations

import numpy as np
import torch

_F32_TINY = torch.finfo(torch.float32).tiny


def uniform(shape, generator: torch.Generator) -> torch.Tensor:
    """f32 uniforms in [0, 1) on the generator's device."""
    return torch.rand(shape, generator=generator, device=generator.device)


def gumbel(shape, generator: torch.Generator) -> torch.Tensor:
    """Standard Gumbel noise ``-log(-log(u))``, u uniform in [tiny, 1), as
    ``jax.random.gumbel`` makes it, on the generator's device."""
    u = torch.clamp(uniform(shape, generator), min=_F32_TINY)
    return -torch.log(-torch.log(u))


def categorical(g, logits):
    """One draw per row from ``softmax(logits)``: argmax(logits + g), the
    first index winning a tie.  -inf logits stay unsampleable."""
    return torch.argmax(logits + g, dim=-1).to(torch.int32)


def greedy(logits):
    return torch.argmax(logits, dim=-1).to(torch.int32)


def temperature_sample(g, logits, temperature: float = 1.0):
    if temperature <= 0.0:
        return greedy(logits)
    return categorical(g, logits.float() / temperature)


def typical_threshold(logp, eps: float = 0.3, delta: float = 0.09):
    """Medusa typical-acceptance threshold: min(eps, delta * exp(-H))."""
    H = -torch.sum(torch.exp(logp) * logp, dim=-1)
    return torch.clamp(delta * torch.exp(-H), max=eps)


def _per_row(x, logits):
    """Broadcast a scalar-or-[B] control against ``logits [..., V]``: a
    Python number becomes a 0-dim f32 tensor made on the logits' device (a
    fill, which stream capture takes), a [B] tensor gains trailing axes."""
    if not isinstance(x, torch.Tensor):
        x = torch.full((), float(x), dtype=torch.float32,
                       device=logits.device)
    x = x.to(torch.float32)
    return x.reshape(tuple(x.shape) + (1,) * (logits.dim() - x.dim()))


def per_row(x, B: int, device) -> torch.Tensor:
    """A scalar-or-[B] control as a [B] f32 tensor on ``device``."""
    if not isinstance(x, torch.Tensor):
        return torch.full((B,), float(x), dtype=torch.float32, device=device)
    return torch.broadcast_to(x.to(torch.float32), (B,))


def warp_logits(logits, temperature=1.0, top_k: int = 0, top_p=1.0):
    """Temperature / top-k / top-p logit warping -> f32 logits.

    ``temperature`` and ``top_p`` may be Python numbers or per-row [B]
    tensors (broadcast against the leading axes); ``top_k`` is static.
    Masked tokens become -inf; the top-1 token always survives, so the
    warped row is never empty.  ``temperature <= 0`` returns an exact
    one-hot row at ``argmax(logits)`` (first max wins), which is what
    makes sampled decoding collapse to greedy at temperature 0.
    """
    x = logits.float()
    t = _per_row(temperature, logits)
    warped = x / torch.clamp(t, min=1e-6)
    if top_k and top_k < x.shape[-1]:
        kth = torch.topk(x, top_k, dim=-1).values[..., -1:]
        warped = torch.where(x < kth, float("-inf"), warped)
    # nucleus: keep the smallest descending-probability prefix with mass
    # >= top_p (the exclusive cumulative keeps the top-1 unconditionally)
    p = _per_row(top_p, logits)
    sorted_w = torch.sort(warped, dim=-1, descending=True).values
    probs = torch.softmax(sorted_w, dim=-1)
    keep = (torch.cumsum(probs, dim=-1) - probs) < p
    n_keep = torch.clamp(torch.sum(keep, dim=-1, keepdim=True), min=1)
    cutoff = torch.gather(sorted_w, -1, n_keep - 1)
    warped = torch.where(warped < cutoff, float("-inf"), warped)
    # temperature <= 0: exact greedy, one-hot at the pre-warp argmax
    onehot = torch.nn.functional.one_hot(torch.argmax(x, dim=-1),
                                         x.shape[-1]).bool()
    return torch.where(t <= 0, torch.where(onehot, 0.0, float("-inf")),
                       warped)


def warp_probs(logits, temperature=1.0, top_k: int = 0, top_p=1.0):
    """Warped probabilities (rows sum to 1; masked tokens are exactly 0)."""
    return torch.softmax(warp_logits(logits, temperature, top_k, top_p),
                         dim=-1)


def sample(g, logits, temperature=1.0, top_k: int = 0, top_p=1.0):
    """One token per row from the warped distribution.  Deterministic argmax
    at ``temperature <= 0`` (the only finite warped logit is the argmax)."""
    return categorical(g, warp_logits(logits, temperature, top_k, top_p))


def residual_dist(p, q):
    """The rejection-sampling residual ``norm(max(p - q, 0))``.

    ``p``/``q`` [..., V] probability rows -> a probability row.  When the
    residual carries no mass (p == q, reachable only through round-off) it
    falls back to ``p`` so the draw after it stays well-defined."""
    r = torch.clamp(p - q, min=0.0)
    s = torch.sum(r, dim=-1, keepdim=True)
    return torch.where(s > 1e-9, r / torch.clamp(s, min=1e-38), p)


def categorical_from_probs(g, probs):
    """Draw from probability rows (zeros stay strictly unsampleable)."""
    logp = torch.where(probs > 0, torch.log(torch.clamp(probs, min=1e-38)),
                       float("-inf"))
    return categorical(g, logp)


def max_marginal_tvd(a, b, vocab: int) -> float:
    """Max over positions of the total-variation distance between the
    empirical token marginals of two [N, L] integer sample matrices (numpy
    or CPU tensors): the distribution-equality metric of the reference's
    sampling tests and benchmark, kept here as the port's own copy."""
    a, b = np.asarray(a), np.asarray(b)
    tvds = []
    for j in range(a.shape[1]):
        pa = np.bincount(a[:, j], minlength=vocab) / a.shape[0]
        pb = np.bincount(b[:, j], minlength=vocab) / b.shape[0]
        tvds.append(0.5 * np.abs(pa - pb).sum())
    return float(max(tvds))
