"""Flash-decoding attention over a KV cache with per-row lengths — the hot
spot of the static tree-verification step (and of the AR baseline).

``flash_decode`` replaces ``repro/kernels/tree_attention.py::flash_decode``
(the Pallas TPU kernel, dense fp/bf16 body ``_kernel``) with the
hand-written CUDA kernel ``csrc/flash_decode.cu`` for Hopper (sm_90a),
built by ``kernels/build.py`` and called through ``ctypes``.  The kernel is
bound by the bytes of K and V it sweeps; its design (one block per
(b, kv head, 32 query rows), cache tiles streamed through shared memory up
to ``lengths[b]``, f32 online softmax) is described in the source.

``flash_decode_plain`` is the same function in plain PyTorch: the CPU
path, and what the card's kernel is held against.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.models.layers import NEG_INF

_KERNEL_DTYPES = {torch.float32: "flash_decode_f32",
                  torch.bfloat16: "flash_decode_bf16"}
_HEAD_DIMS = (64, 128, 256)


def flash_decode_plain(q, k, v, lengths):
    """Partial-softmax decode attention in plain PyTorch.

    q [B, Hkv, R, D] f32/bf16 (pre-scaled by 1/sqrt(D)); k/v [B, S, Hkv, D]
    (the port's cache layout); lengths [B] int.  Returns (acc [B, Hkv, R, D],
    m [B, Hkv, R, 1], l [B, Hkv, R, 1]) in f32: the kernel's statistics over
    columns s < lengths[b], with p rounded to v's dtype before the PV
    product as the TPU kernel does.  A row of length 0 gives m = -1e30,
    l = 0, acc = 0.
    """
    S = k.shape[1]
    kt = k.permute(0, 2, 1, 3).float()                     # [B, Hkv, S, D]
    vt = v.permute(0, 2, 1, 3)
    scores = torch.matmul(q.float(), kt.transpose(-1, -2))  # [B, Hkv, R, S]
    valid = (torch.arange(S, device=q.device)[None, :]
             < lengths.to(q.device)[:, None])[:, None, None, :]
    neg = torch.tensor(NEG_INF, dtype=torch.float32, device=q.device)
    scores = torch.where(valid, scores, neg)
    m = torch.amax(scores, dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(scores - m), torch.zeros((), device=q.device))
    l = torch.sum(p, dim=-1, keepdim=True)
    acc = torch.matmul(p.to(v.dtype).float(), vt.float())
    return acc, m, l


def _check_cuda_args(q, k, v, lengths):
    if q.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"flash_decode: q dtype {q.dtype} (float32 or bfloat16)")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_decode: q/k/v dtypes differ "
                        f"({q.dtype}, {k.dtype}, {v.dtype})")
    B, Hkv, R, D = q.shape
    if k.dim() != 4 or k.shape[0] != B or k.shape[2] != Hkv or k.shape[3] != D \
            or v.shape != k.shape:
        raise ValueError(f"flash_decode: q {tuple(q.shape)} does not fit "
                         f"k {tuple(k.shape)} / v {tuple(v.shape)} "
                         f"([B, S, Hkv, D])")
    if D not in _HEAD_DIMS:
        raise ValueError(f"flash_decode: head_dim {D} (kernel takes {_HEAD_DIMS})")
    if k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("flash_decode: k/v need unit stride over head_dim")
    if lengths.shape != (B,) or lengths.dtype != torch.int32:
        raise ValueError("flash_decode: lengths must be [B] int32")
    for t in (k, v, lengths):
        if t.device != q.device:
            raise ValueError(f"flash_decode: tensors on {q.device} and {t.device}")


def _kernel_fn(dtype):
    from repro_torch.kernels.build import library
    fn = getattr(library("flash_decode"), _KERNEL_DTYPES[dtype])
    if fn.argtypes is None:
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        fn.argtypes = [vp] * 7 + [i32] * 5 + [i64] * 6 + [vp]
        fn.restype = ctypes.c_int
    return fn


def flash_decode(q, k, v, lengths, *, k_scale=None, v_scale=None,
                 block_tables=None):
    """Partial-softmax decode attention over the committed cache region.

    q [B, Hkv, R, D] f32/bf16 (pre-scaled by 1/sqrt(D)); k/v [B, S, Hkv, D]
    in the port's cache layout (the TPU kernel takes [B, Hkv, S, D]; here
    the kernel reads the cache through its strides, so no transposed copy
    is made); lengths [B] int32.  Returns (acc [B, Hkv, R, D],
    m [B, Hkv, R, 1], l [B, Hkv, R, 1]) in f32 for the exact tree-block
    merge in ``ops.py``.

    CPU tensors take ``flash_decode_plain``.  CUDA tensors launch the
    kernel, or raise: there is no fallback.  ``flash_decode.launches``
    counts kernel launches.  The int8 cache (``k_scale``/``v_scale``) and
    the paged pool (``block_tables``) are later slices and raise.
    """
    if k_scale is not None or v_scale is not None or k.dtype == torch.int8:
        raise NotImplementedError("flash_decode: the int8 cache variant is "
                                  "ROADMAP queue 1 item 9")
    if block_tables is not None:
        raise NotImplementedError("flash_decode: the paged variant is "
                                  "ROADMAP queue 1 item 10")
    if q.device.type == "cpu":
        return flash_decode_plain(q, k, v, lengths)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode: unsupported device {q.device}")
    _check_cuda_args(q, k, v, lengths)
    q = q.contiguous()
    B, Hkv, R, D = q.shape
    acc = torch.empty((B, Hkv, R, D), dtype=torch.float32, device=q.device)
    m = torch.empty((B, Hkv, R, 1), dtype=torch.float32, device=q.device)
    l = torch.empty((B, Hkv, R, 1), dtype=torch.float32, device=q.device)
    err = _kernel_fn(q.dtype)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
        acc.data_ptr(), m.data_ptr(), l.data_ptr(), B, Hkv, R, D, k.shape[1],
        k.stride(0), k.stride(1), k.stride(2), v.stride(0), v.stride(1),
        v.stride(2), torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_decode: CUDA launch failed with error {err}")
    flash_decode.launches += 1
    return acc, m, l


flash_decode.launches = 0
