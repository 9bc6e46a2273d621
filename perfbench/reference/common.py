"""What the references share: the precisions they compute in, RMSNorm,
the float8 rounding of the control, and the unembedding read at chosen
rows."""
from __future__ import annotations

import torch

F8_MAX = 448.0            # the largest finite float8 e4m3 value
PRECISIONS = ("f32", "fp8")


def full_f32():
    """Pin float32 products to float32 (no TF32), for the references."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def to_f8(x, dim: int):
    """``x`` rounded to float8 e4m3 with one scale a slice along ``dim``
    (amax / 448), and back to float32: a product's operand as an fp8
    kernel would read it."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12)
    scale = amax / F8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def matmul(x, w, precision: str):
    """``x`` [..., k] times ``w`` [k, n] (any float dtype) in float32; the
    ``"fp8"`` control rounds x a row and w an output column to float8."""
    w = w.float()
    if precision == "fp8":
        return to_f8(x, -1) @ to_f8(w, 0)
    return x @ w


def rms_norm(x, w, eps: float):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w.float()


def silu(x):
    return x * torch.sigmoid(x)


def read_logits(h, lm_head, rows, precision: str, block: int = 256):
    """Logits [len(rows), V] f32 of the final hidden rows ``h[rows]``
    (h [n * S, d] f32), a block of rows at a time."""
    out = []
    for i in range(0, len(rows), block):
        out.append(matmul(h[rows[i:i + block]], lm_head, precision))
    return torch.cat(out)
