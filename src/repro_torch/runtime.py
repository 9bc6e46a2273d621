"""Device resolution shared by the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """-> ``torch.device`` for an entry point.

    ``"cuda"`` (the default everywhere) raises when no GPU is visible: the
    port never falls back to the CPU on its own, only when the caller asks
    for ``device="cpu"`` (the tests do).  Float32 matrix products and
    convolutions are pinned to full float32 here, so no entry point runs
    in TF32 by accident.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible; pass device='cpu' to "
                           "run the plain PyTorch versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev


def torch_dtype(name: str) -> torch.dtype:
    """Config dtype string ("float32", "bfloat16", "int8" for the
    quantized cache) -> torch dtype."""
    try:
        return {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "int8": torch.int8}[name]
    except KeyError:
        raise NotImplementedError(
            f"dtype {name!r}: the port carries float32 and bfloat16 (and "
            f"int8 for the KV cache)")
