"""The decode step's write side in one kernel: q/k/v projection, RoPE and
the tree-row cache write of one layer.

``fused_qkv_rope_commit`` replaces
``repro/kernels/cache_update.py::fused_qkv_rope_commit`` (the Pallas TPU
kernel, dense bodies ``_fused_qkv_body``/``_fused_qkv_dense`` and
``_rope_half``) with the hand-written CUDA kernel
``csrc/fused_qkv_rope_commit.cu`` for Hopper (sm_90a), built by
``kernels/build.py`` and called through ``ctypes``.  One block owns 64
rows and one head, so RoPE's pairs and the head's cache rows stay in the
block (the design is in the source).  The paged variant
(``_fused_qkv_paged``) is a later slice.

Rows that would land at or past the cache's end are dropped, the rule of
the port's and the unfused reference's ``_update_rows``.  (The Pallas
kernel's dense write clamps its start instead when run in interpret mode;
the port does not copy that.)

``fused_qkv_rope_commit_plain`` is the same function in plain PyTorch: the
CPU path, and what the card's kernel is held against.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.models import layers as L

_KERNEL_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
_HEAD_DIMS = (64, 128)


def fused_qkv_rope_commit_plain(x, p, lengths, k_cache, v_cache, *, cos=None,
                                sin=None):
    """The fused write side in plain PyTorch; arguments and results as
    ``fused_qkv_rope_commit``.  The projections are products in x's dtype
    (f32 accumulation, rounded to x's dtype), the biases are added in x's
    dtype, RoPE is ``layers.apply_rope``, and the k/v rows go into the
    caches through ``transformer._update_rows``."""
    # imported here: models.transformer imports this module
    from repro_torch.models.transformer import _update_rows
    B, T, d = x.shape

    def proj(name):
        w = p["w" + name]
        H, hd = w.shape[1], w.shape[2]
        z = torch.matmul(x, w.to(x.dtype).reshape(d, H * hd))
        z = z.reshape(B, T, H, hd)
        if "b" + name in p:
            z = z + p["b" + name].to(x.dtype)
        return z

    q, k, v = proj("q"), proj("k"), proj("v")
    if cos is not None:
        c, s = cos[:, :, None, :], sin[:, :, None, :]
        q, k = L.apply_rope(q, c, s), L.apply_rope(k, c, s)
    _update_rows(k_cache, k, lengths)
    _update_rows(v_cache, v, lengths)
    return q, k, v


def _check_cuda_args(x, p, lengths, k_cache, v_cache, cos, sin):
    if x.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"fused_qkv_rope_commit: x dtype {x.dtype} (float32 "
                        f"or bfloat16)")
    if k_cache.dtype != x.dtype or v_cache.dtype != x.dtype:
        raise TypeError(f"fused_qkv_rope_commit: caches of {k_cache.dtype} "
                        f"and {v_cache.dtype} for x of {x.dtype}: the fused "
                        f"write side takes fp caches of x's dtype (the int8 "
                        f"cache is ROADMAP queue 1 item 9)")
    B, T, d = x.shape
    Hq, hd = p["wq"].shape[1], p["wq"].shape[2]
    Hkv = p["wk"].shape[1]
    if p["wq"].shape[0] != d or p["wk"].shape != (d, Hkv, hd) \
            or p["wv"].shape != (d, Hkv, hd):
        raise ValueError("fused_qkv_rope_commit: weights are not wq "
                         "[d, Hq, hd], wk/wv [d, Hkv, hd]")
    if hd not in _HEAD_DIMS:
        raise ValueError(f"fused_qkv_rope_commit: head_dim {hd} (kernel "
                         f"takes {_HEAD_DIMS})")
    for c in (k_cache, v_cache):
        if c.dim() != 4 or c.shape[0] != B or c.shape[2:] != (Hkv, hd) \
                or c.stride(-1) != 1:
            raise ValueError(f"fused_qkv_rope_commit: cache {tuple(c.shape)} "
                             f"is not [B, S, Hkv, hd] with unit stride over "
                             f"hd")
    if k_cache.shape != v_cache.shape:
        raise ValueError("fused_qkv_rope_commit: k and v caches differ")
    if lengths.shape != (B,) or lengths.dtype != torch.int32:
        raise ValueError("fused_qkv_rope_commit: lengths must be [B] int32")
    if (cos is None) != (sin is None):
        raise ValueError("fused_qkv_rope_commit: pass both cos and sin, or "
                         "neither")
    if cos is not None and (cos.shape != (B, T, hd // 2) or sin.shape
                            != cos.shape or cos.dtype != torch.float32
                            or sin.dtype != torch.float32):
        raise ValueError("fused_qkv_rope_commit: cos/sin must be "
                         "[B, T, hd/2] float32")
    has_bias = ["b" + n in p for n in "qkv"]
    if any(has_bias) and not all(has_bias):
        raise ValueError("fused_qkv_rope_commit: give all of bq/bk/bv or "
                         "none")
    tensors = [p["wq"], p["wk"], p["wv"], lengths, k_cache, v_cache]
    tensors += [t for t in (cos, sin) if t is not None]
    tensors += [p["b" + n] for n in "qkv" if "b" + n in p]
    for t in tensors:
        if t.device != x.device:
            raise ValueError(f"fused_qkv_rope_commit: tensors on {x.device} "
                             f"and {t.device}")


def _kernel_fn(dtype):
    from repro_torch.kernels.build import library
    fn = getattr(library("fused_qkv_rope_commit"),
                 "fused_qkv_rope_commit_" + _KERNEL_DTYPES[dtype])
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 7 + \
            [ctypes.c_int64] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def fused_qkv_rope_commit(x, p, lengths, k_cache, v_cache, *, cos=None,
                          sin=None, table=None):
    """One kernel launch per layer for the decode step's write side.

    x [B, T, d] normed activations; p: attention params with wq
    [d, Hq, hd], wk/wv [d, Hkv, hd] (and optionally bq [Hq, hd], bk/bv
    [Hkv, hd]); lengths [B] int32; k_cache/v_cache [B, S, Hkv, hd] in x's
    dtype; cos/sin [B, T, hd/2] f32 from ``layers.rope_cos_sin``, or None
    for no RoPE.  Writes the T new k/v rows into the caches in place at
    [lengths[b], lengths[b] + T), dropping rows at or past S, and returns
    (q [B, T, Hq, hd], k, v [B, T, Hkv, hd]) in x's dtype.

    CPU tensors take ``fused_qkv_rope_commit_plain``.  CUDA tensors launch
    the kernel, or raise: there is no fallback.
    ``fused_qkv_rope_commit.launches`` counts kernel launches.  The paged
    pool (``table``) is a later slice and raises.
    """
    if table is not None:
        raise NotImplementedError("fused_qkv_rope_commit: the paged variant "
                                  "is ROADMAP queue 1 item 10")
    if x.device.type == "cpu":
        return fused_qkv_rope_commit_plain(x, p, lengths, k_cache, v_cache,
                                           cos=cos, sin=sin)
    if x.device.type != "cuda":
        raise ValueError(f"fused_qkv_rope_commit: unsupported device "
                         f"{x.device}")
    _check_cuda_args(x, p, lengths, k_cache, v_cache, cos, sin)
    B, T, d = x.shape
    Hq, hd = p["wq"].shape[1], p["wq"].shape[2]
    Hkv = p["wk"].shape[1]
    x, lengths = x.contiguous(), lengths.contiguous()
    w = [p["w" + n].to(x.dtype).contiguous() for n in "qkv"]
    b = [p["b" + n].to(x.dtype).contiguous() if "b" + n in p else None
         for n in "qkv"]
    cs = [t.contiguous() if t is not None else None for t in (cos, sin)]
    q = torch.empty((B, T, Hq, hd), dtype=x.dtype, device=x.device)
    k = torch.empty((B, T, Hkv, hd), dtype=x.dtype, device=x.device)
    v = torch.empty((B, T, Hkv, hd), dtype=x.dtype, device=x.device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = _kernel_fn(x.dtype)(
        x.data_ptr(), *(t.data_ptr() for t in w), *(ptr(t) for t in b),
        *(ptr(t) for t in cs), lengths.data_ptr(), q.data_ptr(),
        k.data_ptr(), v.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        B * T, T, d, Hq, Hkv, hd, k_cache.shape[1], k_cache.stride(0),
        k_cache.stride(1), k_cache.stride(2), v_cache.stride(0),
        v_cache.stride(1), v_cache.stride(2),
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_qkv_rope_commit: CUDA launch failed with "
                           f"error {err}")
    fused_qkv_rope_commit.launches += 1
    return q, k, v


fused_qkv_rope_commit.launches = 0
