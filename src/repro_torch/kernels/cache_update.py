"""The cache's write kernels: the decode step's fused write side, and the
in-place commit of the accepted rows.

``fused_qkv_rope_commit`` replaces
``repro/kernels/cache_update.py::fused_qkv_rope_commit`` (the Pallas TPU
kernel, bodies ``_fused_qkv_body``/``_fused_qkv_dense``/``_fused_qkv_paged``
and ``_rope_half``) with the hand-written CUDA kernel
``csrc/fused_qkv_rope_commit.cu`` for Hopper (sm_90a): q/k/v projection,
RoPE and the tree-row write of one layer.  A block owns one head, so
RoPE's pairs and the head's cache rows stay in it.  Two routes, chosen per
launch by ``qkv_plan`` from the dtype, the row count and the alignment:
the ``"wgmma"`` route (bf16, every pointer and row stride 16-byte aligned:
the main path) runs the product on ``csrc/hopper_gemm.cuh``'s TMA +
``wgmma`` mainloop, with the depth split over a cluster of blocks; the
``"tile"`` route (f32, or anything TMA cannot take) keeps the
``csrc/tile_gemm.cuh`` product (the design of both is in the source).

``commit_rows_stacked`` and ``commit_rows_paged_stacked`` replace
``commit_rows`` (body ``_kernel``) and ``commit_rows_paged`` (body
``_kernel_paged``) of the same reference file with ``csrc/commit_rows.cu``:
one launch writes K1 rows per slot of every unit in place, at
[lengths[b], lengths[b] + K1), with one block per row.  The reference's
one-cache form is the unit view ``cache[None]``; its ``*_quantized``
wrappers are ``quant.quantize_rows`` followed by one launch for the
values and one for the scales, which the model's commit does itself.

Write rules.  Dense: rows that would land at or past the cache's end are
dropped, the rule of the port's and the unfused reference's
``_update_rows`` (the Pallas kernels' dense writes clamp their start
instead when run in interpret mode; the port does not copy that).  Paged:
rows past the table's reach go to trash block 0, as in the reference.

Each ``*_plain`` function is the same function in plain PyTorch: the CPU
path, and what the card's kernel is held against.  Each wrapper counts in
its ``.launches`` the kernel launches it makes itself.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import paging as P
from repro_torch.models import layers as L

_KERNEL_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
_HEAD_DIMS = (64, 128)


def fused_qkv_rope_commit_plain(x, p, lengths, k_cache, v_cache, *, cos=None,
                                sin=None, table=None):
    """The fused write side in plain PyTorch; arguments and results as
    ``fused_qkv_rope_commit``.  The projections are products in x's dtype
    (f32 accumulation, rounded to x's dtype), the biases are added in x's
    dtype, RoPE is ``layers.apply_rope``, and the k/v rows go into the
    caches through ``commit_rows_plain`` (dense) or ``paging.scatter_rows``
    (paged)."""
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
    if table is None:
        commit_rows_plain(k_cache, k, lengths)
        commit_rows_plain(v_cache, v, lengths)
    else:
        P.scatter_rows(k_cache, table, k, lengths, k_cache.shape[1])
        P.scatter_rows(v_cache, table, v, lengths, v_cache.shape[1])
    return q, k, v


def _check_cuda_args(x, p, lengths, k_cache, v_cache, cos, sin, table):
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
        if c.dim() != 4 or c.shape[2:] != (Hkv, hd) or c.stride(-1) != 1:
            raise ValueError(f"fused_qkv_rope_commit: cache {tuple(c.shape)} "
                             f"is not [B, S, Hkv, hd] (or a pool "
                             f"[n_blocks, page_size, Hkv, hd]) with unit "
                             f"stride over hd")
        if table is None and c.shape[0] != B:
            raise ValueError(f"fused_qkv_rope_commit: cache {tuple(c.shape)} "
                             f"for {B} slots")
        if table is not None and c.stride(0) != c.shape[1] * c.stride(1):
            raise ValueError("fused_qkv_rope_commit: pool block stride is "
                             "not page_size times its row stride")
    if table is not None and (table.dim() != 2 or table.shape[0] != B
                              or table.dtype != torch.int32):
        raise ValueError(f"fused_qkv_rope_commit: table must be [B={B}, "
                         f"max_blocks] int32")
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
    tensors += [t for t in (cos, sin, table) if t is not None]
    tensors += [p["b" + n] for n in "qkv" if "b" + n in p]
    for t in tensors:
        if t.device != x.device:
            raise ValueError(f"fused_qkv_rope_commit: tensors on {x.device} "
                             f"and {t.device}")


def aligned16(ptrs=(), strides=()) -> bool:
    """Whether every address in ``ptrs`` and every bf16 element stride in
    ``strides`` is a multiple of 16 bytes: what TMA boxes and the wgmma
    routes' 16-byte stores need."""
    return all(p % 16 == 0 for p in ptrs) and all(s % 8 == 0 for s in strides)


def qkv_plan(M, d, hd, dtype, aligned=True):
    """(route, consumers, splits) of one ``fused_qkv_rope_commit`` launch on
    the card, for M = B * T rows, depth d and head_dim hd.

    ``"wgmma"`` (bf16, d a multiple of 8 and ``aligned``, see
    ``aligned16``): at the spec step (M > 64) 2 consumer warpgroups, 256
    rows a block, d split over clusters of 2 blocks (96 blocks for 48
    heads); at the AR step (M <= 64) 1 consumer warpgroup, 64 rows a
    block, d split 4 ways (192 blocks, two per SM, streaming the weights).
    No split gets fewer than one 64-deep stage.  ``"tile"`` otherwise:
    ``(route, 0, 1)``."""
    if dtype != torch.bfloat16 or not aligned or d % 8 or hd not in _HEAD_DIMS:
        return "tile", 0, 1
    stages = -(-d // 64)
    if M <= 64:
        return "wgmma", 1, min(4, stages)
    return "wgmma", 2, min(2, stages)


def _kernel_fn(dtype, route="tile"):
    from repro_torch.kernels.build import library
    name = "fused_qkv_rope_commit_" + _KERNEL_DTYPES[dtype]
    if route == "wgmma":
        name += "_wgmma"
    fn = getattr(library("fused_qkv_rope_commit"), name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 7 + \
            [ctypes.c_int64] * 6 + [ctypes.c_void_p] + [ctypes.c_int] * 2 + \
            [ctypes.c_int] * (2 if route == "wgmma" else 0) + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def qkv_map_encodings() -> int:
    """Tensor maps the K3 library has encoded for weights since it was
    loaded (each weight's map is encoded once, then cached)."""
    from repro_torch.kernels.build import library
    fn = library("fused_qkv_rope_commit").fused_qkv_rope_commit_map_encodings
    fn.restype = ctypes.c_longlong
    return fn()


def fused_qkv_rope_commit(x, p, lengths, k_cache, v_cache, *, cos=None,
                          sin=None, table=None):
    """One kernel launch per layer for the decode step's write side.

    x [B, T, d] normed activations; p: attention params with wq
    [d, Hq, hd], wk/wv [d, Hkv, hd] (and optionally bq [Hq, hd], bk/bv
    [Hkv, hd]); lengths [B] int32; k_cache/v_cache [B, S, Hkv, hd] in x's
    dtype; cos/sin [B, T, hd/2] f32 from ``layers.rope_cos_sin``, or None
    for no RoPE.  Writes the T new k/v rows into the caches in place at
    [lengths[b], lengths[b] + T), dropping rows at or past S, and returns
    (q [B, T, Hq, hd], k, v [B, T, Hkv, hd]) in x's dtype.  With ``table``
    [B, max_blocks] int32 the caches are pools
    [n_blocks, page_size, Hkv, hd] and the rows go through the table, rows
    past it to trash block 0.

    CPU tensors take ``fused_qkv_rope_commit_plain``.  CUDA tensors launch
    the kernel on the route ``qkv_plan`` picks, or raise: there is no
    fallback.  ``fused_qkv_rope_commit.launches`` counts kernel launches,
    ``.launches_by_route`` the same launches by route.
    """
    if x.device.type == "cpu":
        return fused_qkv_rope_commit_plain(x, p, lengths, k_cache, v_cache,
                                           cos=cos, sin=sin, table=table)
    if x.device.type != "cuda":
        raise ValueError(f"fused_qkv_rope_commit: unsupported device "
                         f"{x.device}")
    _check_cuda_args(x, p, lengths, k_cache, v_cache, cos, sin, table)
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

    if table is not None:
        table = table.contiguous()
        ps, mb = k_cache.shape[1], table.shape[1]
    else:
        ps = mb = 0

    def ptr(t):
        return None if t is None else t.data_ptr()

    inputs = [x, *w, *b, *cs, k_cache, v_cache]
    strides = [*k_cache.stride()[:3], *v_cache.stride()[:3]]
    route, consumers, splits = qkv_plan(
        B * T, d, hd, x.dtype,
        aligned16([t.data_ptr() for t in inputs if t is not None], strides))
    extra = (consumers, splits) if route == "wgmma" else ()
    err = _kernel_fn(x.dtype, route)(
        x.data_ptr(), *(t.data_ptr() for t in w), *(ptr(t) for t in b),
        *(ptr(t) for t in cs), lengths.data_ptr(), q.data_ptr(),
        k.data_ptr(), v.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        B * T, T, d, Hq, Hkv, hd, k_cache.shape[1], *strides, ptr(table), ps,
        mb, *extra, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_qkv_rope_commit: CUDA launch ({route} "
                           f"route) failed with error {err}")
    fused_qkv_rope_commit.launches += 1
    fused_qkv_rope_commit.launches_by_route[route] += 1
    return q, k, v


fused_qkv_rope_commit.launches = 0
fused_qkv_rope_commit.launches_by_route = {"wgmma": 0, "tile": 0}


# ---------------------------------------------------------------------------
# in-place commit of the accepted rows (K4 dense, K5 paged)
# ---------------------------------------------------------------------------

def commit_rows_plain(cache, rows, lengths):
    """Per-row write, in place: cache [..., B, S, H, D] gets rows
    [..., B, K1, H, D] (cast to the cache's dtype) at
    [lengths[b], lengths[b] + K1).  Returns the cache.

    Rows that land at or past S are dropped, never wrapped or raised on
    (the reference's ``_update_rows`` rule).  Dropping them needs no host
    sync: each such row is sent to slot ``pos % S``, which lies before
    ``lengths[b]`` (or, when every row of the slot is dropped, is written
    by no kept row), and it writes back that slot's own current value.
    That needs S >= K1, which is checked.
    """
    B, S = cache.shape[-4], cache.shape[-3]
    T = rows.shape[-3]
    if S < T:
        raise ValueError(f"cache of {S} rows cannot take {T} rows per step")
    dev = cache.device
    pos = lengths.long()[:, None] + torch.arange(T, device=dev)   # [B, T]
    keep = pos < S
    idx = pos % S
    bidx = torch.arange(B, device=dev)[:, None].expand(B, T)
    old = cache[..., bidx, idx, :, :]
    vals = torch.where(keep[:, :, None, None], rows.to(cache.dtype), old)
    cache[..., bidx, idx, :, :] = vals
    return cache


def commit_rows_stacked_plain(cache, rows, lengths):
    """``commit_rows_stacked`` in plain PyTorch (``commit_rows_plain``
    takes the leading units axis as it is)."""
    return commit_rows_plain(cache, rows, lengths)


def commit_rows_paged_stacked_plain(pool, block_tables, rows, lengths):
    """``commit_rows_paged_stacked`` in plain PyTorch
    (``paging.scatter_rows_stacked``)."""
    return P.scatter_rows_stacked(pool, block_tables, rows, lengths,
                                  pool.shape[2])


def _check_commit_args(name, cache, rows, lengths, table):
    """Shapes, devices and layout for the commit kernel: cache
    [nu, B, S, H, D] or pool [nu, n_blocks, ps, H, D], rows
    [nu, B, K1, H, D]."""
    if cache.dim() != 5 or rows.dim() != 5:
        raise ValueError(f"{name}: cache {tuple(cache.shape)} and rows "
                         f"{tuple(rows.shape)} have the wrong rank")
    nu, B = rows.shape[0], rows.shape[1]
    if cache.shape[0] != nu or cache.shape[-2:] != rows.shape[-2:]:
        raise ValueError(f"{name}: rows {tuple(rows.shape)} do not fit the "
                         f"cache {tuple(cache.shape)}")
    if table is None and cache.shape[1] != B:
        raise ValueError(f"{name}: cache {tuple(cache.shape)} for {B} slots")
    H, D = cache.shape[-2:]
    if cache.stride(-1) != 1 or cache.stride(-2) != D:
        raise ValueError(f"{name}: cache rows [H, D] must be contiguous")
    if table is not None:
        if cache.stride(1) != cache.shape[2] * cache.stride(2):
            raise ValueError(f"{name}: pool block stride is not page_size "
                             f"times its row stride")
        if table.dim() != 2 or table.shape[0] != B \
                or table.dtype != torch.int32:
            raise ValueError(f"{name}: block_tables must be [B={B}, "
                             f"max_blocks] int32")
    if lengths.shape != (B,) or lengths.dtype != torch.int32:
        raise ValueError(f"{name}: lengths must be [B] int32")
    for t in (rows, lengths, table):
        if t is not None and t.device != cache.device:
            raise ValueError(f"{name}: tensors on {cache.device} and "
                             f"{t.device}")


def _commit_fn():
    from repro_torch.kernels.build import library
    fn = library("commit_rows").commit_rows
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + \
            [ctypes.c_int64] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _launch_commit(name, cache, rows, lengths, table):
    """One launch of ``csrc/commit_rows.cu``: cache [nu, B, S, H, D] or,
    with ``table``, pool [nu, n_blocks, ps, H, D]; rows [nu, B, K1, H, D]
    (cast to the cache's dtype)."""
    _check_commit_args(name, cache, rows, lengths, table)
    rows = rows.to(cache.dtype).contiguous()
    nu, B, K1 = rows.shape[:3]
    es = cache.element_size()
    row_bytes = rows.shape[-2] * rows.shape[-1] * es
    if table is not None:
        table = table.contiguous()
        S, ps, mb = 0, cache.shape[2], table.shape[1]
        s_b = 0
    else:
        S, ps, mb = cache.shape[2], 0, 0
        s_b = cache.stride(1) * es
    err = _commit_fn()(
        rows.data_ptr(), cache.data_ptr(), lengths.data_ptr(),
        None if table is None else table.data_ptr(), nu, B, K1, row_bytes, S,
        ps, mb, cache.stride(0) * es, s_b, cache.stride(2) * es,
        torch.cuda.current_stream(cache.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def _device_of(name, cache):
    """'cpu' or 'cuda'; any other device raises."""
    if cache.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {cache.device}")
    return cache.device.type


def commit_rows_stacked(cache, rows, lengths):
    """In-place commit of K1 rows per slot into every unit of a dense cache.

    cache [nu, B, S, H, D] any dtype (bf16, f32, int8 values, f32 scales),
    rows [nu, B, K1, H, D] (cast to the cache's dtype), lengths [B] int32.
    Row j of rows[u, b] lands at cache[u, b, lengths[b] + j]; rows at or
    past S are dropped.  Returns the cache.  One launch for every unit.

    CPU tensors take ``commit_rows_stacked_plain``; CUDA tensors launch
    ``csrc/commit_rows.cu`` or raise (the cache's [H, D] rows must be
    contiguous)."""
    if _device_of("commit_rows_stacked", cache) == "cpu":
        return commit_rows_stacked_plain(cache, rows, lengths)
    _launch_commit("commit_rows_stacked", cache, rows, lengths, None)
    commit_rows_stacked.launches += 1
    return cache


def commit_rows_paged_stacked(pool, block_tables, rows, lengths):
    """In-place commit through the block table into every unit's pool.

    pool [nu, n_blocks, page_size, H, D] any dtype, block_tables
    [B, max_blocks] int32 (one table for every unit), rows
    [nu, B, K1, H, D], lengths [B] int32.  Row j of rows[u, b] lands at
    row pos % page_size of block ``block_tables[b, pos // page_size]`` of
    unit u, pos = lengths[b] + j; rows past the table go to trash block 0.
    Returns the pool.  One launch for every unit.

    CPU tensors take ``commit_rows_paged_stacked_plain``; CUDA tensors
    launch ``csrc/commit_rows.cu`` or raise."""
    if _device_of("commit_rows_paged_stacked", pool) == "cpu":
        return commit_rows_paged_stacked_plain(pool, block_tables, rows,
                                               lengths)
    _launch_commit("commit_rows_paged_stacked", pool, rows, lengths,
                   block_tables)
    commit_rows_paged_stacked.launches += 1
    return pool


commit_rows_stacked.launches = 0
commit_rows_paged_stacked.launches = 0
