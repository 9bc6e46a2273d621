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

``commit_path_stacked`` replaces ``commit_rows`` (body ``_kernel``) and
``commit_rows_paged`` (body ``_kernel_paged``) of the same reference file,
with their ``*_quantized`` wrappers and the gather of the best path's rows
around them (``repro/models/transformer.py::_commit_attn_entry``), by one
launch of ``csrc/commit_rows.cu`` a spec step: every unit's accepted rows
of every cache leaf, read from the in-flight rows where decode left them
(a table of per-unit pointers: nothing is stacked or gathered), quantized
on the way under int8, written in place at [lengths[b], lengths[b] + K1).
``commit_rows_stacked`` and ``commit_rows_paged_stacked`` keep the
reference's interface, the rows given, over the same kernel (path row j
is row j); the reference's one-cache form is the unit view ``cache[None]``.

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
from repro_torch.kernels import quant as Q
from repro_torch.kernels.build import refuse_fake
from repro_torch.models import layers as L
from repro_torch.runtime import counted

_KERNEL_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
_HEAD_DIMS = (64, 128, 256)


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
                        f"write side takes fp caches of x's dtype; an int8 "
                        f"cache keeps the unfused projection, as the "
                        f"reference does "
                        f"(repro/models/transformer.py:508-513)")
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
    At head_dim 256 a block holds one SM's shared memory and takes 128
    rows at the spec step, and a few heads (gemma-2b's 8 + 1 + 1) fill few
    SMs, so d is split 4 ways at the spec step (80 blocks: 2 row tiles x
    10 heads x 4) and 8 at the AR step (80 blocks).  No split gets fewer
    than one 64-deep stage.  ``"tile"`` otherwise: ``(route, 0, 1)``."""
    if dtype != torch.bfloat16 or not aligned or d % 8 or hd not in _HEAD_DIMS:
        return "tile", 0, 1
    stages = -(-d // 64)
    wide = hd == 256
    if M <= 64:
        return "wgmma", 1, min(8 if wide else 4, stages)
    return "wgmma", 2, min(4 if wide else 2, stages)


def qkv_smem(hd, consumers) -> int:
    """Dynamic shared memory of one wgmma-route block (``QkvCfg::SMEM`` in
    ``csrc/fused_qkv_rope_commit.cu``): a 4-stage ring of (rows x 128
    bytes of x, hd / 64 boxes of 8 KB of weights), reused as the f32
    epilogue tile (rows x (hd + 8) x 4 bytes), plus 1024 bytes of
    alignment and the ring's barriers."""
    rows = 64 if consumers == 1 else (128 if hd == 256 else 256)
    ring = 4 * (rows * 128 + hd // 64 * 8192)
    return max(ring, rows * (hd + 8) * 4) + 1024 + 4 * 2 * 8


def qkv_blocks(M, Hq, Hkv, hd, route, consumers, splits):
    """Blocks of one ``fused_qkv_rope_commit`` launch on the plan's route:
    the wgmma route's splits x heads x row tiles (``qkv_plan``'s rows a
    block), the tile route's (64-row tiles) x heads."""
    heads = Hq + 2 * Hkv
    if route == "tile":
        return -(-M // 64) * heads
    rows = 64 if consumers == 1 else (128 if hd == 256 else 256)
    return splits * heads * -(-M // rows)


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
    refuse_fake("fused_qkv_rope_commit", x, lengths, k_cache, v_cache, cos,
                sin, table, *p.values())
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


counted(fused_qkv_rope_commit, ("wgmma", "tile"))


# ---------------------------------------------------------------------------
# in-place commit of the accepted rows (K4 dense, K5 paged)
# ---------------------------------------------------------------------------

# units the kernel's per-unit source table holds (``kMaxUnits`` in
# ``csrc/commit_rows.cu``); the registry's deepest model has 40
COMMIT_MAX_UNITS = 128
_CAST = (torch.float32, torch.bfloat16)


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


def _gather_path(src, path_slots):
    """The best path's in-flight rows [nu, B, K1, H, D]: row
    ``path_slots[b, j]`` of slot b of every unit.  ``src`` is a stacked
    [nu, B, T, H, D] tensor or a sequence of nu [B, T, H, D] tensors."""
    bidx = torch.arange(path_slots.shape[0],
                        device=path_slots.device)[:, None]
    path = path_slots.long()
    if isinstance(src, torch.Tensor):
        return src[:, bidx, path]
    return torch.stack([s[bidx, path] for s in src])


def commit_path_stacked_plain(leaves, sources, path_slots, lengths,
                              table=None):
    """``commit_path_stacked`` in plain PyTorch: per source, the gather of
    the path's rows (``_gather_path``), ``quant.quantize_rows`` where the
    leaf has scales, and ``commit_rows_stacked_plain`` (dense) or
    ``commit_rows_paged_stacked_plain`` (paged) per cache leaf.  Returns
    ``leaves``."""
    for name, src in sources.items():
        picked = _gather_path(src, path_slots)
        rows = {name: picked}
        if name + "_scale" in leaves:
            q, s = Q.quantize_rows(picked)
            rows = {name: q, name + "_scale": s}
        for leaf, r in rows.items():
            if table is None:
                commit_rows_stacked_plain(leaves[leaf], r, lengths)
            else:
                commit_rows_paged_stacked_plain(leaves[leaf], table, r,
                                                lengths)
    return leaves


def _commit_fn():
    from repro_torch.kernels.build import library
    fn = library("commit_rows").commit_path
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9 + \
            [ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] + \
            [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _extent(t):
    """[first, past the last) byte address of ``t``'s elements."""
    span = sum((n - 1) * s for n, s in zip(t.shape, t.stride())) + 1
    return t.data_ptr(), t.data_ptr() + span * t.element_size()


def _rows_ok(t, H, D):
    return t.stride(-1) == 1 and t.stride(-2) == D and t.shape[-2:] == (H, D)


def _check_leaf(name, t, lead, H, D, table):
    """A cache leaf [nu, B, S, H, D] (or a pool [nu, n_blocks, ps, H, D];
    D 1 for the scales) with contiguous [H, D] rows."""
    if t.dim() != 5 or tuple(t.shape[:3]) != lead or not _rows_ok(t, H, D):
        raise ValueError(f"{name}: cache leaf {tuple(t.shape)} is not "
                         f"{lead + (H, D)} with contiguous [H, D] rows")
    if table is not None and t.stride(1) != t.shape[2] * t.stride(2):
        raise ValueError(f"{name}: pool block stride is not page_size "
                         f"times its row stride")


def _launch_commit(name, pairs, path_slots, lengths, table):
    """One launch of ``csrc/commit_rows.cu``.  ``pairs``: one or two
    (unit sources, values leaf, scales leaf or None); unit u's source
    [B, T, H, D] lands in leaf [nu, B, S, H, D] (a pool [nu, n_blocks, ps,
    H, D] through ``table``): row ``path_slots[b, j]`` (row j when
    ``path_slots`` is None) at lengths[b] + j.  Copies where the dtypes
    agree, casts f32 <-> bf16, quantizes into an int8 leaf with scales."""
    units0, cache, _ = pairs[0]
    nu, B = cache.shape[0], lengths.shape[0]
    H, D = cache.shape[-2:]
    if not units0 or units0[0].dim() != 4:
        raise ValueError(f"{name}: sources must be [B, T, H, D] per unit")
    T = units0[0].shape[1]
    K1 = T if path_slots is None else path_slots.shape[-1]
    if nu > COMMIT_MAX_UNITS:
        raise ValueError(f"{name}: {nu} units; the kernel's source table "
                         f"holds {COMMIT_MAX_UNITS}")
    if lengths.shape != (B,) or lengths.dtype != torch.int32:
        raise ValueError(f"{name}: lengths must be [B] int32")
    if path_slots is not None and (
            path_slots.shape != (B, K1)
            or path_slots.dtype not in (torch.int32, torch.int64)):
        raise ValueError(f"{name}: path_slots must be [B={B}, K1] int32 or "
                         f"int64")
    if table is not None:
        if table.dim() != 2 or table.shape[0] != B \
                or table.dtype != torch.int32:
            raise ValueError(f"{name}: block_tables must be [B={B}, "
                             f"max_blocks] int32")
        lead = tuple(cache.shape[:3])
    else:
        lead = (nu, B, cache.shape[2])
        if cache.shape[2] < K1:
            raise ValueError(f"cache of {cache.shape[2]} rows cannot take "
                             f"{K1} rows per step")
    src_dt, src_stride = units0[0].dtype, units0[0].stride()
    if units0[0].shape != (B, T, H, D) or not _rows_ok(units0[0], H, D):
        raise ValueError(f"{name}: sources must be [B={B}, T, H={H}, D={D}] "
                         f"with contiguous [H, D] rows")
    mode = None
    ptrs = []
    for units, leaf, scale in pairs:
        _check_leaf(name, leaf, lead, H, D, table)
        if len(units) != nu:
            raise ValueError(f"{name}: {len(units)} source units for a "
                             f"cache of {nu}")
        for t in units:
            if t.shape != units0[0].shape or t.dtype != src_dt \
                    or t.stride() != src_stride or t.device != cache.device:
                raise ValueError(f"{name}: sources differ in shape, dtype, "
                                 f"layout or device")
            ptrs.append(t.data_ptr())
        if scale is not None:
            _check_leaf(name, scale, lead, H, 1, table)
            if leaf.dtype != torch.int8 or scale.dtype != torch.float32 \
                    or src_dt not in _CAST:
                raise TypeError(f"{name}: int8 values with f32 scales take "
                                f"f32 or bf16 rows, not {src_dt}")
            if D % 8 or 32 % (D // 8):
                raise ValueError(f"{name}: quantizing takes head_dim 8, "
                                 f"16, 32, 64, 128 or 256, not {D}")
            m = 2
        elif leaf.dtype == src_dt:
            m = 0
        elif leaf.dtype in _CAST and src_dt in _CAST and (H * D) % 8 == 0:
            m = 1
        else:
            raise TypeError(f"{name}: rows of {src_dt} for a {leaf.dtype} "
                            f"leaf")
        if mode not in (None, m) or leaf.dtype != cache.dtype:
            raise TypeError(f"{name}: the leaves differ in dtype")
        mode = m
    outs = [t for _, leaf, scale in pairs for t in (leaf, scale)
            if t is not None]
    for t in [lengths, path_slots, table] + outs:
        if t is not None and t.device != cache.device:
            raise ValueError(f"{name}: tensors on {cache.device} and "
                             f"{t.device}")
    # the in-flight rows are never the cache: no source may overlap a leaf
    span = _extent(units0[0])[1] - ptrs[0]
    for lo, hi in map(_extent, outs):
        if any(lo - span < q < hi for q in ptrs):
            raise ValueError(f"{name}: a source overlaps a cache leaf")
    lengths = lengths.contiguous()
    if path_slots is not None:
        path_slots = path_slots.contiguous()
    if table is not None:
        table = table.contiguous()
        S, ps, mb = 0, cache.shape[2], table.shape[1]
    else:
        S, ps, mb = cache.shape[2], 0, 0
    n = len(pairs)
    src = (ctypes.c_void_p * (n * nu))(*ptrs)
    dst = (ctypes.c_void_p * (2 * n))(
        *(p for _, leaf, scale in pairs
          for p in (leaf.data_ptr(), scale.data_ptr() if scale is not None
                    else None)))
    ses, es = units0[0].element_size(), cache.element_size()
    strides = (ctypes.c_int64 * (8 * n))(
        *(v for units, leaf, scale in pairs for v in (
            units[0].stride(0) * ses, units[0].stride(1) * ses,
            leaf.stride(0) * es, leaf.stride(1) * es, leaf.stride(2) * es,
            *((scale.stride(0) * 4, scale.stride(1) * 4, scale.stride(2) * 4)
              if scale is not None else (0, 0, 0)))))
    err = _commit_fn()(
        src, dst, strides, n, nu, B, K1, H, D, mode,
        1 if src_dt == torch.bfloat16 else 0, es, lengths.data_ptr(),
        None if path_slots is None else path_slots.data_ptr(),
        0 if path_slots is None else path_slots.element_size(),
        None if table is None else table.data_ptr(), S, ps, mb,
        torch.cuda.current_stream(cache.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def _device_of(name, cache, *others):
    """'cpu' or 'cuda'; any other device, or a fake tensor on the card,
    raises."""
    if cache.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {cache.device}")
    if cache.device.type == "cuda":
        refuse_fake(name, cache, *others)
    return cache.device.type


def _rows_given(name, cache, rows, lengths, table):
    """The rows-given commit: rows [nu, B, K1, H, D] land at [lengths[b],
    lengths[b] + K1), one launch (path row j is in-flight row j)."""
    if cache.dim() != 5 or rows.dim() != 5:
        raise ValueError(f"{name}: cache {tuple(cache.shape)} and rows "
                         f"{tuple(rows.shape)} have the wrong rank")
    if rows.dtype != cache.dtype and not (
            rows.dtype in _CAST and cache.dtype in _CAST
            and rows.shape[-2] * rows.shape[-1] % 8 == 0):
        rows = rows.to(cache.dtype)
    _launch_commit(name, [(list(rows.contiguous().unbind(0)), cache, None)],
                   None, lengths, table)


def commit_rows_stacked(cache, rows, lengths):
    """In-place commit of K1 rows per slot into every unit of a dense cache.

    cache [nu, B, S, H, D] any dtype (bf16, f32, int8 values, f32 scales),
    rows [nu, B, K1, H, D] (cast to the cache's dtype), lengths [B] int32.
    Row j of rows[u, b] lands at cache[u, b, lengths[b] + j]; rows at or
    past S are dropped.  Returns the cache.  One launch for every unit.

    CPU tensors take ``commit_rows_stacked_plain``; CUDA tensors launch
    ``csrc/commit_rows.cu`` (the kernel of ``commit_path_stacked``, each
    path row its own in-flight row) or raise (the cache's [H, D] rows must
    be contiguous).  ``.launches`` also counts ``commit_path_stacked``'s
    dense launches."""
    if _device_of("commit_rows_stacked", cache, rows, lengths) == "cpu":
        return commit_rows_stacked_plain(cache, rows, lengths)
    _rows_given("commit_rows_stacked", cache, rows, lengths, None)
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
    launch ``csrc/commit_rows.cu`` or raise.  ``.launches`` also counts
    ``commit_path_stacked``'s paged launches."""
    if _device_of("commit_rows_paged_stacked", pool, block_tables, rows,
                  lengths) == "cpu":
        return commit_rows_paged_stacked_plain(pool, block_tables, rows,
                                               lengths)
    _rows_given("commit_rows_paged_stacked", pool, rows, lengths,
                block_tables)
    commit_rows_paged_stacked.launches += 1
    return pool


def commit_path_stacked(leaves, sources, path_slots, lengths, table=None):
    """One launch commits a spec step's accepted rows into every unit and
    every cache leaf, straight from the in-flight rows.

    leaves: the cache entry's leaves, ``"k"``/``"v"`` [nu, B, S, H, D]
    (pools [nu, n_blocks, page_size, H, D] with ``table`` [B, max_blocks]
    int32), and under int8 ``"k_scale"``/``"v_scale"`` [..., H, 1] f32;
    sources: ``{"k": ..., "v": ...}``, each a sequence of nu [B, T, H, D]
    tensors (decode's in-flight rows, unit by unit) or one stacked
    [nu, B, T, H, D] tensor; path_slots [B, K1] int32 or int64 (the best
    path's in-flight rows); lengths [B] int32.  Row ``path_slots[b, j]``
    of slot b of unit u lands at logical position lengths[b] + j of unit u
    of its leaf: cast to the leaf's dtype, or quantized into the values and
    the scales (``quant.quantize_rows``, bitwise); dense rows at or past S
    are dropped, paged rows past the table go to trash block 0.  All K1
    rows are written.  Returns ``leaves``.

    CPU tensors take ``commit_path_stacked_plain``.  CUDA tensors launch
    ``csrc/commit_rows.cu`` once, counted in ``commit_rows_stacked``'s
    ``.launches`` (dense: K4) or ``commit_rows_paged_stacked``'s (paged:
    K5), or raise: there is no fallback to the gather.  At most
    ``COMMIT_MAX_UNITS`` units; no source may overlap a leaf."""
    rows = [t for src in sources.values()
            for t in ([src] if isinstance(src, torch.Tensor) else src)]
    if _device_of("commit_path_stacked", leaves["k"], *leaves.values(),
                  path_slots, lengths, table, *rows) == "cpu":
        return commit_path_stacked_plain(leaves, sources, path_slots,
                                         lengths, table)
    pairs = [(list(src.unbind(0)) if isinstance(src, torch.Tensor)
              else list(src), leaves[name], leaves.get(name + "_scale"))
             for name, src in sources.items()]
    _launch_commit("commit_path_stacked", pairs, path_slots, lengths, table)
    if table is None:
        commit_rows_stacked.launches += 1
    else:
        commit_rows_paged_stacked.launches += 1
    return leaves


counted(commit_rows_stacked)
counted(commit_rows_paged_stacked)
