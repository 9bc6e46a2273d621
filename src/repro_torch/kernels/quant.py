"""Symmetric int8 KV-cache quantization (the port's copy of
``repro.kernels.quant``).

Layout, as in the cache dict of ``models/transformer.py``:

  * values  ``k``/``v``             [..., S, Hkv, D] int8
  * scales  ``k_scale``/``v_scale``  [..., S, Hkv, 1] float32

Quantization is deterministic (round half to even, a true division by the
scale, no stochastic rounding): greedy speculative decoding stays
token-identical to AR only if quant(x) is a pure function of x, and the
port's rows must be bit-identical to the reference's.
"""
from __future__ import annotations

import torch

from repro_torch.runtime import torch_dtype

INT8_MAX = 127.0
_EPS = 1e-8  # all-zero rows: avoid 0/0, quantize to zeros with scale eps/127


_DIVISORS = {}  # CUDA device -> 127 as a 0-dim f32 tensor there


def _int8_max(device):
    """The divisor of the scale on ``device``: the Python float on the CPU;
    on the card a 0-dim tensor holding 127.  PyTorch's CUDA division by a
    Python scalar multiplies by the scalar's reciprocal, which differs
    from the true quotient in the last bit for ~4 % of scales; a tensor
    divisor is divided truly.  The tensor is made once per device
    (a fill, which a graph capture takes), outside a capture: a capture
    only records the fill, so a tensor made inside one holds 127 only at
    its replays and is not kept."""
    if device.type != "cuda":
        return INT8_MAX
    t = _DIVISORS.get(device)
    if t is None:
        t = torch.full((), INT8_MAX, device=device)
        if not torch.cuda.is_current_stream_capturing():
            _DIVISORS[device] = t
    return t


def quantize_rows(x):
    """Per-head-per-row int8 quantization over the D axis.

    x [..., Hkv, D] float -> (q [..., Hkv, D] int8, scale [..., Hkv, 1]
    f32) with scale = max(amax(|x|), eps) / 127 and q = round(x / scale)
    clipped to [-127, 127].  ``torch.round`` rounds half to even, as
    ``jnp.round`` does, and both divisions are true divisions (not a
    product with the reciprocal; see ``_int8_max``) on every device, so
    the result is bitwise the reference's."""
    xf = x.float()
    amax = torch.amax(torch.abs(xf), dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=_EPS) / _int8_max(amax.device)
    q = torch.clamp(torch.round(xf / scale), -INT8_MAX, INT8_MAX)
    return q.to(torch.int8), scale


def dequantize(q, scale, dtype=torch.float32):
    """q [..., Hkv, D] int8, scale [..., Hkv, 1] f32 -> values in ``dtype``
    (one f32 product, then the cast)."""
    return (q.float() * scale).to(dtype)


def is_quantized(dtype) -> bool:
    """True if ``dtype`` (a config string or a torch dtype) selects the
    int8 cache layout."""
    return dtype in ("int8", torch.int8)


def cache_bytes_per_token(num_kv_heads: int, head_dim: int,
                          cache_dtype) -> int:
    """KV-cache bytes per token per layer for one k+v pair: 2 * Hkv * D *
    itemsize for fp, 2 * Hkv * (D + 4) for int8 (one byte per element and
    one f32 scale per head-row)."""
    if is_quantized(cache_dtype):
        return 2 * num_kv_heads * (head_dim + 4)
    dt = torch_dtype(cache_dtype) if isinstance(cache_dtype, str) \
        else cache_dtype
    return 2 * num_kv_heads * head_dim * dt.itemsize
