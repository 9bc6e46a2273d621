"""The two kernels of the decode step that read the model's largest
tensors: ``flash_decode`` (attention over the KV cache) and
``unembed_verify_stats`` (the lm head fused with the acceptance
statistics).

``flash_decode`` replaces ``repro/kernels/tree_attention.py::flash_decode``
(the Pallas TPU kernel: the dense fp/bf16 body ``_kernel``, its int8
branch and the paged body ``_kernel_paged``) with the hand-written CUDA
kernel ``csrc/flash_decode.cu`` for Hopper (sm_90a), built by
``kernels/build.py`` and called through ``ctypes``.  The kernel is bound
by the bytes of K and V it sweeps; its design (one block per (b, kv head,
32 query rows), 64-column cache tiles streamed through shared memory up
to ``lengths[b]``, int8 rows dequantized in the tile, pool rows found
through the block table per tile, f32 online softmax) is described in the
source.

``unembed_verify_stats`` replaces ``unembed_verify_stats`` of the same
reference file (body ``_verify_stats_kernel``) with ``csrc/verify_stats.cu``:
a first launch leaves per-row partial statistics in vocabulary order and a
second merges them in that order.  Two routes make the partials, chosen
per launch by ``stats_plan``: the ``"wgmma"`` route (bf16, 16-byte aligned
rows: the main path) is a persistent grid of one block per SM, in
clusters of 2 that share each hidden tile, walking their vocabulary tiles
on ``csrc/hopper_gemm.cuh``'s TMA + ``wgmma`` mainloop with 256 rows a
tile; the ``"tile"`` route (f32, or rows TMA cannot take) keeps one block
per (128 rows, 128 columns) tile on ``csrc/tile_gemm.cuh`` (the design of
both is in the source).

Each ``*_plain`` function is the same function in plain PyTorch: the CPU
path, and what the card's kernel is held against.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import paging as P
from repro_torch.kernels import quant as Q
from repro_torch.kernels.cache_update import aligned16
from repro_torch.models.layers import NEG_INF

_KERNEL_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
_HEAD_DIMS = (64, 128, 256)


def flash_decode_plain(q, k, v, lengths, *, k_scale=None, v_scale=None,
                       block_tables=None):
    """Partial-softmax decode attention in plain PyTorch.

    Arguments and results as ``flash_decode``.  The statistics run over
    columns s < lengths[b] in f32.  fp cache: p is rounded to v's dtype
    before the PV product, as the TPU kernel does.  int8 cache: k and v are
    dequantized to f32 (one product with the scale), the scores are the
    f32 dot of the promoted q with them, and p is not rounded.  A paged
    pool is first gathered into its dense view.  A row of length 0 gives
    m = -1e30, l = 0, acc = 0.
    """
    if block_tables is not None:
        k, v = P.gather_cache(k, block_tables), P.gather_cache(v, block_tables)
        if k_scale is not None:
            k_scale = P.gather_cache(k_scale, block_tables)
            v_scale = P.gather_cache(v_scale, block_tables)
    S = k.shape[1]
    if k_scale is not None:
        kt, vt = Q.dequantize(k, k_scale), Q.dequantize(v, v_scale)
    else:
        kt, vt = k.float(), v
    kt = kt.permute(0, 2, 1, 3)                             # [B, Hkv, S, D]
    vt = vt.permute(0, 2, 1, 3)
    scores = torch.matmul(q.float(), kt.transpose(-1, -2))  # [B, Hkv, R, S]
    valid = (torch.arange(S, device=q.device)[None, :]
             < lengths.to(q.device)[:, None])[:, None, None, :]
    neg = torch.tensor(NEG_INF, dtype=torch.float32, device=q.device)
    scores = torch.where(valid, scores, neg)
    m = torch.amax(scores, dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(scores - m), torch.zeros((), device=q.device))
    l = torch.sum(p, dim=-1, keepdim=True)
    acc = torch.matmul(p.to(vt.dtype).float(), vt.float())
    return acc, m, l


def _check_layout(name, t, shape, dtype, paged):
    if t.dtype != dtype:
        raise TypeError(f"flash_decode: {name} is {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"flash_decode: {name} {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if t.stride(-1) != 1:
        raise ValueError(f"flash_decode: {name} needs unit stride over its "
                         f"last axis")
    if paged and t.stride(0) != t.shape[1] * t.stride(1):
        raise ValueError(f"flash_decode: pool {name} needs its block stride "
                         f"to be page_size times its row stride")


def _check_cuda_args(q, k, v, lengths, k_scale, v_scale, block_tables):
    if q.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"flash_decode: q dtype {q.dtype} (float32 or bfloat16)")
    B, Hkv, R, D = q.shape
    if D not in _HEAD_DIMS:
        raise ValueError(f"flash_decode: head_dim {D} (kernel takes {_HEAD_DIMS})")
    paged = block_tables is not None
    if paged:
        if block_tables.dim() != 2 or block_tables.shape[0] != B \
                or block_tables.dtype != torch.int32:
            raise ValueError(f"flash_decode: block_tables must be [B={B}, "
                             f"max_blocks] int32")
        lead = k.shape[:2]                                  # [nb, ps]
    else:
        lead = (B, k.shape[1])                              # [B, S]
    cache_dt = torch.int8 if k_scale is not None else q.dtype
    for name, t in (("k", k), ("v", v)):
        _check_layout(name, t, (*lead, Hkv, D), cache_dt, paged)
    if k_scale is not None:
        for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            _check_layout(name, t, (*lead, Hkv, 1), torch.float32, paged)
    if lengths.shape != (B,) or lengths.dtype != torch.int32:
        raise ValueError("flash_decode: lengths must be [B] int32")
    for t in (k, v, lengths, k_scale, v_scale, block_tables):
        if t is not None and t.device != q.device:
            raise ValueError(f"flash_decode: tensors on {q.device} and {t.device}")


def _kernel_fn(dtype):
    from repro_torch.kernels.build import library
    fn = getattr(library("flash_decode"), "flash_decode_" + _KERNEL_DTYPES[dtype])
    if fn.argtypes is None:
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp] * 10 + [i32] * 8 + [vp, vp]
        fn.restype = ctypes.c_int
    return fn


def flash_decode(q, k, v, lengths, *, k_scale=None, v_scale=None,
                 block_tables=None):
    """Partial-softmax decode attention over the committed cache region.

    q [B, Hkv, R, D] f32/bf16 (pre-scaled by 1/sqrt(D)); lengths [B] int32.
    Dense cache: k/v [B, S, Hkv, D] in the port's layout (the TPU kernel
    takes [B, Hkv, S, D]; here the kernel reads the cache through its
    strides, so no transposed copy is made), in q's dtype, or int8 with
    ``k_scale``/``v_scale`` [B, S, Hkv, 1] f32.  Paged cache: pass
    ``block_tables`` [B, max_blocks] int32 with pool-form k/v
    [n_blocks, page_size, Hkv, D] (scales [n_blocks, page_size, Hkv, 1]);
    logical row s of slot b lives at row s % page_size of block
    ``block_tables[b, s // page_size]``.  Returns (acc [B, Hkv, R, D],
    m [B, Hkv, R, 1], l [B, Hkv, R, 1]) in f32 for the exact tree-block
    merge in ``ops.py``.

    CPU tensors take ``flash_decode_plain``.  CUDA tensors launch the
    kernel, or raise: there is no fallback.  ``flash_decode.launches``
    counts kernel launches.
    """
    if (k.dtype == torch.int8) != (k_scale is not None) \
            or (k_scale is None) != (v_scale is None):
        raise ValueError("flash_decode: an int8 cache comes with k_scale and "
                         "v_scale, an fp cache with neither")
    if q.device.type == "cpu":
        return flash_decode_plain(q, k, v, lengths, k_scale=k_scale,
                                  v_scale=v_scale, block_tables=block_tables)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode: unsupported device {q.device}")
    _check_cuda_args(q, k, v, lengths, k_scale, v_scale, block_tables)
    q = q.contiguous()
    B, Hkv, R, D = q.shape
    paged = block_tables is not None
    if paged:
        block_tables = block_tables.contiguous()
        ps, mb = k.shape[1], block_tables.shape[1]
        S = ps * mb
    else:
        ps, mb, S = 0, 0, k.shape[1]
    acc = torch.empty((B, Hkv, R, D), dtype=torch.float32, device=q.device)
    m = torch.empty((B, Hkv, R, 1), dtype=torch.float32, device=q.device)
    l = torch.empty((B, Hkv, R, 1), dtype=torch.float32, device=q.device)
    quantized = k_scale is not None
    strides = []
    for t in (k, v, k_scale, v_scale):
        strides += [t.stride(0), t.stride(1), t.stride(2)] if t is not None \
            else [0, 0, 0]
    if paged:                      # the pool row, not the block, is indexed
        strides[0::3] = [0, 0, 0, 0]
    c_strides = (ctypes.c_int64 * 12)(*strides)

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = _kernel_fn(q.dtype)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), ptr(k_scale), ptr(v_scale),
        lengths.data_ptr(), ptr(block_tables), acc.data_ptr(), m.data_ptr(),
        l.data_ptr(), B, Hkv, R, D, S, int(quantized), ps, mb, c_strides,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_decode: CUDA launch failed with error {err}")
    flash_decode.launches += 1
    return acc, m, l


flash_decode.launches = 0


# ---------------------------------------------------------------------------
# fused verify epilogue: unembed + acceptance statistics
# ---------------------------------------------------------------------------

def unembed_verify_stats_plain(hidden, w, candidates, tmax, *,
                               block_v: int = 16384):
    """The kernel's statistics in plain PyTorch, streamed over vocabulary
    blocks of ``block_v`` columns as the TPU kernel streams them: per
    block, logits rounded through hidden's dtype and divided by ``tmax``,
    then a first-wins argmax (a later block wins only if strictly
    greater), the running max ``m``, the online sum-exp ``l`` and the
    candidate logits ``cand_w``.  Arguments and results as
    ``unembed_verify_stats``.  With one block, ``l`` is the plain
    ``sum(exp(wv - m))``; with several it carries the online rescale's
    rounding, as the TPU kernel's does."""
    B, T, _ = hidden.shape
    V = w.shape[1]
    dev = hidden.device
    w = w.to(hidden.dtype)
    cand = candidates.long()
    m = torch.full((B, T), float("-inf"), dtype=torch.float32, device=dev)
    l = torch.zeros((B, T), dtype=torch.float32, device=dev)
    argm = torch.zeros((B, T), dtype=torch.int64, device=dev)
    cand_w = torch.zeros((B, T, T), dtype=torch.float32, device=dev)
    for v0 in range(0, V, block_v):
        wv = torch.matmul(hidden, w[:, v0:v0 + block_v]).float()
        wv = wv / tmax[:, None, None]
        n = wv.shape[-1]
        bm = torch.amax(wv, dim=-1)
        argm = torch.where(bm > m, torch.argmax(wv, dim=-1) + v0, argm)
        m_new = torch.maximum(m, bm)
        l = l * torch.exp(m - m_new) + torch.sum(
            torch.exp(wv - m_new[..., None]), dim=-1)
        m = m_new
        rel = cand - v0
        inside = (rel >= 0) & (rel < n)
        idx = torch.clamp(rel, 0, n - 1)[:, None, :].expand(B, T, T)
        cand_w = torch.where(inside[:, None, :], torch.gather(wv, 2, idx),
                             cand_w)
    return argm.to(torch.int32), m, l, cand_w


_STATS_TILE_V = 128   # vocabulary columns per tile, both routes of the kernel
_STATS_CLUSTER = 2    # wgmma route: blocks of a cluster share each hidden tile


def stats_plan(N, d, V, dtype, aligned=True, n_sm=132):
    """(route, n_parts) of one ``unembed_verify_stats`` launch on the card,
    for N rows, depth d and V vocabulary columns; the partials are
    [N, n_parts] each (max, argmax, sum-exp).

    ``"wgmma"`` (bf16, d and V multiples of 8 and ``aligned``: TMA takes
    the rows): a persistent grid of at most one block per SM, in clusters
    of 2 blocks that share each hidden tile, each cluster owning a run of
    at least one 128-column vocabulary tile; one partial per row and
    block.  ``"tile"`` otherwise: one partial per row and vocabulary
    tile."""
    n_tiles = -(-V // _STATS_TILE_V)
    if dtype != torch.bfloat16 or not aligned or d % 8 or V % 8:
        return "tile", n_tiles
    return "wgmma", _STATS_CLUSTER * min(n_sm // _STATS_CLUSTER, n_tiles)


@functools.lru_cache(maxsize=None)
def _n_sm(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def _stats_fn(dtype, route="tile"):
    from repro_torch.kernels.build import library
    name = "verify_stats_" + _KERNEL_DTYPES[dtype]
    if route == "wgmma":
        name += "_wgmma"
    fn = getattr(library("verify_stats"), name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 4 + \
            [ctypes.c_int] * (1 if route == "wgmma" else 0) + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def stats_map_encodings() -> int:
    """Tensor maps the K2 library has encoded for weights since it was
    loaded (the lm head's map is encoded once, then cached)."""
    from repro_torch.kernels.build import library
    fn = library("verify_stats").verify_stats_map_encodings
    fn.restype = ctypes.c_longlong
    return fn()


def _check_stats_args(hidden, w, candidates, tmax):
    if hidden.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"unembed_verify_stats: hidden dtype {hidden.dtype} "
                        f"(float32 or bfloat16)")
    B, T, d = hidden.shape
    if w.dim() != 2 or w.shape[0] != d:
        raise ValueError(f"unembed_verify_stats: w {tuple(w.shape)} is not "
                         f"[d={d}, V]")
    if candidates.shape != (B, T) or candidates.dtype != torch.int32:
        raise ValueError("unembed_verify_stats: candidates must be [B, T] "
                         "int32")
    if tmax.shape != (B,) or tmax.dtype != torch.float32:
        raise ValueError("unembed_verify_stats: tmax must be [B] float32")
    for t in (w, candidates, tmax):
        if t.device != hidden.device:
            raise ValueError(f"unembed_verify_stats: tensors on "
                             f"{hidden.device} and {t.device}")


def unembed_verify_stats(hidden, w, candidates, tmax):
    """Fused unembed + verification statistics.

    hidden [B, T, d] f32/bf16; w [d, V] lm head (cast to hidden's dtype,
    as ``unembed`` casts it); candidates [B, T] int32 in [0, V); tmax [B]
    f32 warp temperatures (ones for greedy).  Returns (argm [B, T] int32,
    m [B, T] f32, l [B, T] f32, cand_w [B, T, T] f32): with wv the logits
    rounded through hidden's dtype and divided by ``tmax[b]``, the
    first-wins argmax of wv, its max, sum(exp(wv - m)), and
    ``cand_w[b, t, j]`` = wv[b, t, candidates[b, j]].  No [B, T, V] tensor
    is made on the card.

    CPU tensors take ``unembed_verify_stats_plain``.  CUDA tensors launch
    the kernel on the route ``stats_plan`` picks (a partials pass and a
    merge pass, counted as one launch of the op in
    ``unembed_verify_stats.launches``, and by route in
    ``.launches_by_route``), or raise: there is no fallback.
    """
    if hidden.device.type == "cpu":
        return unembed_verify_stats_plain(hidden, w, candidates, tmax)
    if hidden.device.type != "cuda":
        raise ValueError(f"unembed_verify_stats: unsupported device "
                         f"{hidden.device}")
    _check_stats_args(hidden, w, candidates, tmax)
    hidden = hidden.contiguous()
    w = w.to(hidden.dtype).contiguous()
    candidates, tmax = candidates.contiguous(), tmax.contiguous()
    B, T, d = hidden.shape
    V = w.shape[1]
    dev = hidden.device
    route, n_parts = stats_plan(
        B * T, d, V, hidden.dtype, aligned16((hidden.data_ptr(),
                                              w.data_ptr())),
        _n_sm(dev.index if dev.index is not None
              else torch.cuda.current_device()))
    f32 = torch.float32
    argm = torch.empty((B, T), dtype=torch.int32, device=dev)
    m = torch.empty((B, T), dtype=f32, device=dev)
    l = torch.empty((B, T), dtype=f32, device=dev)
    cand_w = torch.empty((B, T, T), dtype=f32, device=dev)
    pm = torch.empty((B * T, n_parts), dtype=f32, device=dev)
    pi = torch.empty((B * T, n_parts), dtype=torch.int32, device=dev)
    pl = torch.empty((B * T, n_parts), dtype=f32, device=dev)
    extra = (n_parts,) if route == "wgmma" else ()
    err = _stats_fn(hidden.dtype, route)(
        hidden.data_ptr(), w.data_ptr(), candidates.data_ptr(),
        tmax.data_ptr(), argm.data_ptr(), m.data_ptr(), l.data_ptr(),
        cand_w.data_ptr(), pm.data_ptr(), pi.data_ptr(), pl.data_ptr(),
        B * T, T, d, V, *extra, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"unembed_verify_stats: CUDA launch ({route} "
                           f"route) failed with error {err}")
    unembed_verify_stats.launches += 1
    unembed_verify_stats.launches_by_route[route] += 1
    return argm, m, l, cand_w


unembed_verify_stats.launches = 0
unembed_verify_stats.launches_by_route = {"wgmma": 0, "tile": 0}
