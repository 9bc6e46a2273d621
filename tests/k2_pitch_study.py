"""K2 (``unembed_verify_stats``, the ``wgmma`` route) over an lm head laid out
at a 16-byte row pitch, against depth and rows, and ``torch.matmul`` over
the same head three ways.  Needs one NVIDIA GPU; not collected by pytest.

    python3 tests/k2_pitch_study.py      # from the repo's root

Part 1 times K2 queued behind a spin kernel (``chip_smoke.queued_ms``) at
whisper-tiny's and granite-moe-1b-a400m's vocabularies (51865, 49155,
pitched) for d from 64 to 4096 at N 256, and at the models' own d for N
64, 16 x 4 and 20: a time that stays put as d falls below a few hundred
is a cost per vocabulary tile (the epilogue over the 256-row tile, the
launch, the merge), not the stream of the head.  It also times an aligned
V (51872, contiguous) and the sampled step's per-row temperatures.

Part 2 times ``torch.matmul`` at the three unaligned heads over the
contiguous head, over the pitched view, and over the whole pitched
allocation [d, ceil8(V)], and names the kernel cuBLAS picks for each
(``torch.profiler``): the logits' row stride, not the head's, decides it.
"""
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as CS  # noqa: E402
from repro_torch.kernels.tree_attention import (  # noqa: E402
    pitch_lm_head, unembed_verify_stats)
from repro_torch.runtime import resolve_device  # noqa: E402

BF16 = torch.bfloat16


def head(dev, d, V, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return gen, (torch.randn((d, V), generator=gen, device=dev)
                 * d ** -0.5).to(BF16)


def time_k2(dev, V, d, B, T, pitched=True, tmax=None):
    gen, w = head(dev, d, V)
    h = torch.randn((B, T, d), generator=gen, device=dev).to(BF16)
    if pitched:
        w = pitch_lm_head(w)
    cand = torch.randint(0, V, (B, T), generator=gen, device=dev,
                         dtype=torch.int32)
    tm = (torch.ones((B,), device=dev) if tmax is None
          else torch.tensor(tmax, device=dev))
    _, route = CS.routed(unembed_verify_stats, h, w, cand, tm)
    ms = CS.queued_ms(lambda: CS.uncounted(unembed_verify_stats, h, w, cand,
                                           tm), 50)
    b_ms, by = CS.bound(d * V * 2 + B * T * d * 2, 2 * B * T * d * V)
    at = "" if tmax is None else f" at tmax {tmax}"
    CS.log(f"K2 V {V} d {d} N {B * T} pitch {w.stride(0)}{at} ({route}): "
           f"{ms:.4f} ms, bound {b_ms:.5f} ({by}), {ms / b_ms:.1f}x")


def lib_kernels(fn) -> str:
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.device_time_total / e.count / 1e3)
            for e in prof.key_averages() if e.device_time_total > 0]
    return "; ".join(f"{k[:90]} {ms:.4f} ms" for k, ms in rows[:3])


def main():
    dev = resolve_device("cuda")
    CS.log(CS.smi_line())
    for V, d0 in ((51865, 384), (49155, 1024)):
        for d in (64, 128, 384, 1024, 2048, 4096):
            time_k2(dev, V, d, 4, 64)
        for B, T in ((1, 64), (4, 16), (4, 5)):
            time_k2(dev, V, d0, B, T)
    time_k2(dev, 51872, 384, 4, 64, pitched=False)
    time_k2(dev, 51865, 384, 4, 64, tmax=[0.7, 1.0, 1e-6, 2.0])
    for V, d in ((92553, 6144), (49155, 1024), (51865, 384)):
        gen, w = head(dev, d, V)
        h = torch.randn((256, d), generator=gen, device=dev).to(BF16)
        p = pitch_lm_head(w)
        full = p.as_strided((d, p.stride(0)), (p.stride(0), 1))
        for label, op in (("contiguous", w), ("pitched view", p),
                          ("pitched allocation", full)):
            ms = CS.queued_ms(lambda: torch.matmul(h, op), 30)
            CS.log(f"matmul V {V} d {d} {label} {tuple(op.shape)} stride "
                   f"{op.stride()}: {ms:.4f} ms; "
                   f"{lib_kernels(lambda: torch.matmul(h, op))}")


if __name__ == "__main__":
    main()
