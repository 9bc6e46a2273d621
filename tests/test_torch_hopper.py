"""The Hopper routes of K2 (``unembed_verify_stats``) and K3
(``fused_qkv_rope_commit``): what can be held on the CPU.

* No kernel source reaches a library GEMM (cuBLAS, cuDNN, CUTLASS's
  device-level GEMMs), the build links no cuBLAS, and the CUDA paths of
  the two wrappers call no PyTorch product and catch no failure.
* The host-side route and split choice (``qkv_plan``, ``stats_plan``,
  ``aligned16``) at the main path's shapes, at the edge shapes the chip
  smoke checks, at V 4099 (rows TMA cannot take) and at f32.
* The K2 partials' sizing: one per row and block on the wgmma route, one
  per row and 128-column tile on the tile route.
* On CPU tensors neither wrapper counts a launch on any route.

The kernels themselves run only on the card: the last tests hold them to
their plain versions at the new edge shapes there and skip here.
"""
import ast
import inspect
import pathlib
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels import cache_update as CU
from repro_torch.kernels import tree_attention as TA

CSRC = pathlib.Path(build.__file__).resolve().parent / "csrc"
BF16, F32 = torch.bfloat16, torch.float32
D, V, HD = 4096, 153376, 128          # openPangu-7B


def test_no_library_gemm_in_the_kernels():
    sources = sorted(CSRC.glob("*.cu*"))
    assert {p.name for p in sources} >= {"hopper_gemm.cuh", "tile_gemm.cuh",
                                         "verify_stats.cu",
                                         "fused_qkv_rope_commit.cu"}
    for path in sources:
        includes = [ln for ln in path.read_text().splitlines()
                    if ln.lstrip().startswith("#include")]
        for ln in includes:
            low = ln.lower()
            assert "cublas" not in low and "cudnn" not in low, (path, ln)
            assert "cutlass/gemm/device" not in low, (path, ln)
    flags = " ".join(build.NVCC_FLAGS + build.LINK_FLAGS).lower()
    assert "cublas" not in flags and "cudnn" not in flags


@pytest.mark.parametrize("fn", [CU.fused_qkv_rope_commit,
                                TA.unembed_verify_stats])
def test_wrappers_call_no_product_and_catch_nothing(fn):
    tree = ast.parse(textwrap.dedent(inspect.getsource(fn)))
    names = {n.attr for n in ast.walk(tree) if isinstance(n, ast.Attribute)}
    names |= {n.id for n in ast.walk(tree) if isinstance(n, ast.Name)}
    assert not names & {"matmul", "mm", "bmm", "einsum", "linear"}
    assert not any(isinstance(n, ast.Try) for n in ast.walk(tree))


@pytest.mark.parametrize("M, d, hd, dtype, aligned, want", [
    (256, D, HD, BF16, True, ("wgmma", 2, 2)),     # spec step, B 4 T 64
    (4, D, HD, BF16, True, ("wgmma", 1, 4)),       # AR step
    (192, D, HD, BF16, True, ("wgmma", 2, 2)),     # B 3, T 64
    (28, D, HD, BF16, True, ("wgmma", 1, 4)),      # B 4, T 7
    (64, D, HD, BF16, True, ("wgmma", 1, 4)),      # one full 64-row tile
    (65, D, HD, BF16, True, ("wgmma", 2, 2)),
    (512, D, HD, BF16, True, ("wgmma", 2, 2)),     # two row tiles
    (256, D, 64, BF16, True, ("wgmma", 2, 2)),     # head_dim 64
    (4, D, 64, BF16, True, ("wgmma", 1, 4)),
    (4, 128, HD, BF16, True, ("wgmma", 1, 2)),     # 2 stages: 2 splits
    (256, 64, HD, BF16, True, ("wgmma", 2, 1)),
    (256, D, HD, F32, True, ("tile", 0, 1)),       # f32 stays on CUDA cores
    (4, D, HD, F32, True, ("tile", 0, 1)),
    (256, D, HD, BF16, False, ("tile", 0, 1)),     # a pointer or stride off
    (256, 4100, HD, BF16, True, ("tile", 0, 1)),   # x rows not 16-byte aligned
    (256, D, 96, BF16, True, ("tile", 0, 1)),
])
def test_qkv_plan(M, d, hd, dtype, aligned, want):
    assert CU.qkv_plan(M, d, hd, dtype, aligned) == want


def test_aligned16():
    assert CU.aligned16((0, 16, 4096), (8, 1024, 2048 * 1024))
    assert CU.aligned16()
    assert not CU.aligned16((0, 8), ())
    assert not CU.aligned16((), (1024, 4))          # a bf16 stride of 8 bytes
    # a dense cache [B, S, Hkv, hd] and a pool [nb, ps, Hkv, hd]
    cache = torch.empty((4, 64, 8, 128), dtype=BF16)
    pool = torch.empty((9, 16, 8, 64), dtype=BF16)
    assert CU.aligned16((cache.data_ptr(),), cache.stride()[:3])
    assert CU.aligned16((pool.data_ptr(),), pool.stride()[:3])
    # a view one element into the cache is no longer 16-byte aligned
    assert not CU.aligned16((cache.view(-1)[1:].data_ptr(),), ())


@pytest.mark.parametrize("N, d, v, dtype, aligned, n_sm, want", [
    (256, D, V, BF16, True, 132, ("wgmma", 132)),   # the spec step
    (512, D, V, BF16, True, 132, ("wgmma", 132)),   # B 8, T 64
    (64, D, V, BF16, True, 132, ("wgmma", 132)),    # B 1, T 64
    (256, D, V, BF16, True, 114, ("wgmma", 114)),   # a card with 114 SMs
    (256, D, V, BF16, True, 131, ("wgmma", 130)),   # whole clusters only
    (256, D, 1000, BF16, True, 132, ("wgmma", 16)),  # 8 tiles, 8 clusters
    (256, D, 1152, BF16, True, 132, ("wgmma", 18)),  # 9 tiles
    (256, D, 128, BF16, True, 132, ("wgmma", 2)),    # 1 tile, 1 padding
    (128, 512, 4099, BF16, True, 132, ("tile", 33)),  # rows TMA cannot take
    (256, D, V, F32, True, 132, ("tile", 1199)),
    (256, D, V, BF16, False, 132, ("tile", 1199)),
    (256, 4100, V, BF16, True, 132, ("tile", 1199)),
])
def test_stats_plan(N, d, v, dtype, aligned, n_sm, want):
    assert TA.stats_plan(N, d, v, dtype, aligned, n_sm) == want


@pytest.mark.parametrize("v, n_sm", [(V, 132), (V, 114), (1000, 132),
                                     (128, 132), (4096, 132), (1152, 132)])
def test_stats_partials_sizing(v, n_sm):
    """The wgmma route's clusters of 2 split the vocabulary tiles into
    contiguous ascending runs (cluster c: tiles [c n / C, (c + 1) n / C)),
    each at least one tile, walked 2 tiles a step, rank r taking tile
    t0 + 2 j + r: every tile has exactly one block, each block's tiles
    ascend, and padding (a tile past its cluster's run) comes only in a
    cluster's last step.  The partials are [N, n_parts]."""
    cl = 2
    route, parts = TA.stats_plan(256, D, v, BF16, True, n_sm)
    assert route == "wgmma" and parts % cl == 0 and parts <= n_sm
    n_tiles = -(-v // 128)
    n_cl = parts // cl
    tiles, padding = [], 0
    for c in range(n_cl):
        t0, t1 = c * n_tiles // n_cl, (c + 1) * n_tiles // n_cl
        assert t1 > t0
        steps = -(-(t1 - t0) // cl)
        for r in range(cl):
            mine = [t0 + cl * j + r for j in range(steps)]
            tiles += [t for t in mine if t < t1]
            padding += sum(t >= t1 for t in mine)
            assert all(t < t1 for t in mine[:-1])
    assert sorted(tiles) == list(range(n_tiles))
    assert padding < cl * n_cl
    # at the spec step the partials shrink from N x 1199 to N x 132, and
    # no block walks more than 10 of the 1199 tiles (9.08 on average)
    if v == V and n_sm == 132:
        assert 256 * parts * 12 == 405_504
        assert TA.stats_plan(256, D, v, F32, True, n_sm)[1] * 256 * 12 \
            == 3_683_328
        assert max(-(-((c + 1) * n_tiles // n_cl - c * n_tiles // n_cl)
                     // cl) for c in range(n_cl)) == 10


def test_no_route_counted_on_the_cpu():
    rng = np.random.default_rng(0)
    h = torch.from_numpy(rng.standard_normal((1, 3, 16))).float()
    w = torch.from_numpy(rng.standard_normal((16, 40))).float()
    cand = torch.zeros(1, 3, dtype=torch.int32)
    p = {n: torch.from_numpy(rng.standard_normal((16, H, 64))).float()
         for n, H in (("wq", 4), ("wk", 2), ("wv", 2))}
    k = torch.zeros(1, 32, 2, 64)
    lengths = torch.tensor([5], dtype=torch.int32)
    before = [dict(f.launches_by_route) for f in (TA.unembed_verify_stats,
                                                  CU.fused_qkv_rope_commit)]
    TA.unembed_verify_stats(h, w, cand, torch.ones(1))
    CU.fused_qkv_rope_commit(h, p, lengths, k, k.clone())
    assert [f.launches_by_route for f in (TA.unembed_verify_stats,
                                          CU.fused_qkv_rope_commit)] == before
    assert set(before[0]) == set(before[1]) == {"wgmma", "tile"}


# ---------------------------------------------------------------------------
# on the card: the new edge shapes against the plain versions
# ---------------------------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B, T", [(8, 64), (1, 64), (4, 64)])
def test_cuda_stats_wgmma_matches_plain(B, T):
    """K2's wgmma route at N 512, 64 and 256 (full d and V) against its
    plain version: argm equal up to bf16 near-ties, m and cand_w within
    one bf16 step, l within 2e-2."""
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(B)
    h = torch.randn((B, T, D), generator=gen, device=dev).to(BF16)
    w = (torch.randn((D, V), generator=gen, device=dev) * D ** -0.5).to(BF16)
    cand = torch.randint(0, V, (B, T), generator=gen, device=dev,
                         dtype=torch.int32)
    cand[:, -1] = V - 1
    tmax = torch.ones((B,), device=dev)
    before = dict(TA.unembed_verify_stats.launches_by_route)
    argm, m, l, cw = TA.unembed_verify_stats(h, w, cand, tmax)
    assert TA.unembed_verify_stats.launches_by_route["wgmma"] \
        == before["wgmma"] + 1
    rargm, rm, rl, rcw = TA.unembed_verify_stats_plain(h, w, cand, tmax)
    torch.cuda.synchronize()
    scale = rm.abs().clamp(min=1.0)
    assert ((m - rm).abs() / scale).max().item() < 2e-2
    assert ((l / rl) - 1).abs().max().item() < 2e-2
    assert ((cw - rcw).abs() / rcw.abs().clamp(min=1.0)).max().item() < 2e-2
    differ = argm != rargm
    if differ.any():
        logits = torch.matmul(h, w).float()
        gap = rm[differ] - logits[differ, argm[differ].long()]
        assert (gap <= 2.0 ** (torch.floor(torch.log2(rm[differ].abs())) - 7)
                ).all()


@pytest.mark.cuda
@pytest.mark.parametrize("B, T, hd", [(3, 64, 128), (4, 7, 128), (4, 64, 64),
                                      (4, 1, 64)])
def test_cuda_qkv_wgmma_matches_plain_and_paged_is_dense(B, T, hd):
    """K3's wgmma route at M 192, 28 and head_dim 64 against its plain
    version (2e-2, bf16), and K3-paged bitwise equal to K3-dense on the
    same inputs."""
    from repro_torch.kernels.paging import identity_table
    from repro_torch.models.layers import rope_cos_sin

    dev = _cuda()
    Hq, Hkv, S, ps = 32, 8, 256, 16
    gen = torch.Generator(device=dev).manual_seed(T)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(BF16)

    x = rnd(B, T, D)
    p = {n: rnd(D, H, hd, scale=D ** -0.5)
         for n, H in (("wq", Hq), ("wk", Hkv), ("wv", Hkv))}
    lens = torch.tensor([3 + 40 * b for b in range(B)], dtype=torch.int32,
                        device=dev)
    cos, sin = rope_cos_sin(lens[:, None] + torch.arange(T, device=dev), hd,
                            1e6)
    kc, vc = rnd(B, S, Hkv, hd), rnd(B, S, Hkv, hd)
    kr, vr = kc.clone(), vc.clone()
    before = dict(CU.fused_qkv_rope_commit.launches_by_route)
    got = CU.fused_qkv_rope_commit(x, p, lens, kc, vc, cos=cos, sin=sin)
    assert CU.fused_qkv_rope_commit.launches_by_route["wgmma"] \
        == before["wgmma"] + 1
    ref = CU.fused_qkv_rope_commit_plain(x, p, lens, kr, vr, cos=cos,
                                         sin=sin)
    for g, r in zip((*got, kc, vc), (*ref, kr, vr)):
        err = ((g.float() - r.float()).abs()
               / r.float().abs().clamp(min=1.0)).max().item()
        assert err < 2e-2
    table = identity_table(B, S // ps).to(dev)
    pk = torch.zeros((1 + B * S // ps, ps, Hkv, hd), dtype=BF16, device=dev)
    paged = CU.fused_qkv_rope_commit(x, p, lens, pk, pk.clone(), cos=cos,
                                     sin=sin, table=table)
    for a, b in zip(got, paged):
        assert torch.equal(a, b)
