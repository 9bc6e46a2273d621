"""The Hopper routes of K1 (``flash_decode``), K2
(``unembed_verify_stats``) and K3 (``fused_qkv_rope_commit``): what can be
held on the CPU.

* No kernel source reaches a library GEMM (cuBLAS, cuDNN, CUTLASS's
  device-level GEMMs), the build links no cuBLAS, and the CUDA paths of
  the two wrappers call no PyTorch product and catch no failure.
* The host-side route and split choice (``qkv_plan``, ``stats_plan``,
  ``aligned16``) at the main path's shapes, at the edge shapes the chip
  smoke checks, at V 4099 (rows TMA cannot take) and at f32.
* The K2 partials' sizing: one per row and block on the wgmma route, one
  per row and 128-column tile on the tile route.
* On CPU tensors neither wrapper counts a launch on any route.
* An lm head laid out at a 16-byte row pitch (``pitch_lm_head``, for V
  not a multiple of 8): its layout, its route by the pitch, the plain
  statistics over it bitwise those over the contiguous head with the pad
  poisoned; on the card K2 over it on both routes at V 4099 and at
  granite-moe's, internvl2's and whisper-tiny's heads.
* K1's grid plan (``decode_plan``): rows a block, splits of whole 64-column
  tiles, the partials' size, at the main path's shapes and at
  ``tests/test_kernels.py::CASES``, from host-known ints only (never
  ``lengths``).

The kernels themselves run only on the card: the last tests hold them to
their plain versions at the new edge shapes there and skip here, and
launch K2 and K3 on a second card where one is present (their
shared-memory limit is raised once per device).
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
from repro_torch.runtime import resolve_device

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
                                TA.unembed_verify_stats, TA.flash_decode])
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


# B, Hkv, R (folded), S, dtype -> (route, rows, split_cols, n_splits)
PLAN_CASES = [
    (4, 8, 256, 2048, BF16, ("single", 64, 2048, 1)),   # spec step, R 256
    (4, 8, 8, 2048, BF16, ("split", 16, 64, 32)),       # AR step, R 8
    (4, 8, 256, 512, F32, ("single", 32, 512, 1)),      # f32 spec step
    (4, 8, 8, 512, F32, ("split", 8, 64, 8)),           # f32 AR step
    (4, 8, 64, 2048, BF16, ("split", 64, 512, 4)),      # 32 blocks, L 8 R
    (32, 8, 8, 2048, BF16, ("single", 16, 2048, 1)),    # 256 blocks fill it
    (4, 8, 8, 32768, BF16, ("split", 16, 1024, 32)),    # at most 32 splits
    (4, 8, 8, 100, BF16, ("split", 16, 64, 2)),         # S not whole tiles
    # tests/test_kernels.py::CASES: (B, S, Hq, Hkv, D, tree) folded
    (2, 2, 256, 1024, F32, ("single", 32, 1024, 1)),    # medusa, G 4
    (1, 4, 8, 512, F32, ("split", 8, 64, 8)),           # chain, G 1
    (3, 1, 512, 2048, BF16, ("single", 64, 2048, 1)),   # medusa, G 8
    (2, 2, 24, 640, F32, ("split", 32, 192, 4)),        # chain, G 3
    (1, 2, 8, 256, BF16, ("split", 16, 64, 4)),         # chain, D 256
    (2, 8, 128, 512, F32, ("single", 32, 512, 1)),      # medusa, G 2
]


@pytest.mark.parametrize("B, Hkv, R, S, dtype, want", PLAN_CASES)
def test_decode_plan(B, Hkv, R, S, dtype, want):
    plan = TA.decode_plan(B, Hkv, R, S, dtype)
    assert tuple(plan) == want
    route, rows, split_cols, n = plan
    assert split_cols % 64 == 0 and 1 <= n <= 32
    assert (n - 1) * split_cols < max(S, 64) <= n * split_cols
    assert (route == "single") == (n == 1)
    if route == "split":
        # the partials, written and read (8 R D bytes a split), stay within
        # a quarter of the bf16 K/V a split streams (4 split_cols D bytes)
        assert split_cols >= 8 * R
        assert B * Hkv * -(-R // rows) < 132


def test_decode_plan_sees_no_lengths():
    """The plan takes host ints only, and the wrapper hands it none of
    ``lengths``: choosing the grid needs no device sync."""
    params = list(inspect.signature(TA.decode_plan).parameters)
    assert params == ["B", "Hkv", "R", "S", "dtype", "n_sm"]
    tree = ast.parse(textwrap.dedent(inspect.getsource(TA.flash_decode)))
    calls = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
             and getattr(n.func, "id", None) == "decode_plan"]
    assert len(calls) == 1
    assert "lengths" not in {n.id for n in ast.walk(calls[0])
                             if isinstance(n, ast.Name)}


def test_decode_plan_partials_at_the_main_shapes():
    """The split route's partials at the AR step: acc [32, 4, 8, 8, 128]
    and m, l [32, 4, 8, 8] f32 (4.25 MB); the spec step has none."""
    n = TA.decode_plan(4, 8, 8, 2048, BF16).n_splits
    assert n * 4 * 8 * 8 * (128 + 2) * 4 == 4_259_840
    assert TA.decode_plan(4, 8, 256, 2048, BF16).n_splits == 1
    # a card with fewer SMs still keeps one split at R 256 (128 blocks)
    assert TA.decode_plan(4, 8, 256, 2048, BF16, 114).route == "single"
    assert TA.decode_plan(4, 8, 64, 2048, BF16, 16).route == "single"


def test_no_k1_route_counted_on_the_cpu():
    before = dict(TA.flash_decode.launches_by_route)
    q = torch.zeros(1, 2, 8, 64)
    k = torch.zeros(1, 128, 2, 64)
    TA.flash_decode(q, k, k, torch.tensor([5], dtype=torch.int32))
    assert TA.flash_decode.launches_by_route == before
    assert set(before) == {"single", "split", "merge"}


# ---------------------------------------------------------------------------
# on the card: the new edge shapes against the plain versions
# ---------------------------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    # the plain versions' bf16 products reduce in f32, as every entry
    # point pins them (cuBLAS may otherwise sum split-K partials in bf16)
    return resolve_device("cuda")


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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_cuda_stats_reads_a_tied_table_in_place(dtype):
    """K2 over a tied model's [V, d] table passed as ``embed.T`` (gemma-2b's
    d 2048, a vocabulary of 2000 tiles): the route ``stats_plan`` gives the
    layout, the call allocates far less than the table (no copy), and the
    statistics match the plain version (f32 exactly on argm)."""
    dev = _cuda()
    d, v, B, T = 2048, 256000, 4, 64
    gen = torch.Generator(device=dev).manual_seed(7)
    embed = (torch.randn((v, d), generator=gen, device=dev)
             * d ** -0.5).to(dtype)
    h = torch.randn((B, T, d), generator=gen, device=dev).to(dtype)
    cand = torch.randint(0, v, (B, T), generator=gen, device=dev,
                         dtype=torch.int32)
    tmax = torch.ones((B,), device=dev)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    before = dict(TA.unembed_verify_stats.launches_by_route)
    argm, m, l, cw = TA.unembed_verify_stats(h, embed.T, cand, tmax,
                                             layout="vd")
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - held < embed.numel() // 8
    route = "wgmma" if dtype == BF16 else "tile"
    assert TA.unembed_verify_stats.launches_by_route[route] \
        == before[route] + 1
    rargm, rm, rl, rcw = TA.unembed_verify_stats_plain(h, embed.T, cand, tmax)
    tol = 2e-2 if dtype == BF16 else 3e-5
    assert ((m - rm).abs() / rm.abs().clamp(min=1.0)).max().item() < tol
    assert ((l / rl) - 1).abs().max().item() < tol
    assert ((cw - rcw).abs() / rcw.abs().clamp(min=1.0)).max().item() < tol
    if dtype == F32:
        assert torch.equal(argm, rargm)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [64, 1])
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_cuda_qkv_head_dim_256_matches_plain(T, dtype):
    """K3 at gemma-2b's widths (d 2048, 8 + 1 + 1 heads of 256), with
    biases, against its plain version, and the paged run bitwise equal to
    the dense one."""
    from repro_torch.kernels.paging import identity_table
    from repro_torch.models.layers import rope_cos_sin

    dev = _cuda()
    B, d, Hq, Hkv, hd, S, ps = 4, 2048, 8, 1, 256, 256, 16
    gen = torch.Generator(device=dev).manual_seed(T)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).to(dtype)

    x = rnd(B, T, d)
    p = {n: rnd(d, H, hd, scale=d ** -0.5)
         for n, H in (("wq", Hq), ("wk", Hkv), ("wv", Hkv))}
    p |= {"b" + n: rnd(H, hd, scale=0.1)
          for n, H in (("q", Hq), ("k", Hkv), ("v", Hkv))}
    lens = torch.tensor([3 + 40 * b for b in range(B)], dtype=torch.int32,
                        device=dev)
    cos, sin = rope_cos_sin(lens[:, None] + torch.arange(T, device=dev), hd,
                            1e4)
    kc, vc = rnd(B, S, Hkv, hd), rnd(B, S, Hkv, hd)
    kr, vr = kc.clone(), vc.clone()
    route = "wgmma" if dtype == BF16 else "tile"
    before = dict(CU.fused_qkv_rope_commit.launches_by_route)
    got = CU.fused_qkv_rope_commit(x, p, lens, kc, vc, cos=cos, sin=sin)
    assert CU.fused_qkv_rope_commit.launches_by_route[route] \
        == before[route] + 1
    ref = CU.fused_qkv_rope_commit_plain(x, p, lens, kr, vr, cos=cos,
                                         sin=sin)
    tol = 2e-2 if dtype == BF16 else 3e-5
    for g, r in zip((*got, kc, vc), (*ref, kr, vr)):
        err = ((g.float() - r.float()).abs()
               / r.float().abs().clamp(min=1.0)).max().item()
        assert err < tol
    table = identity_table(B, S // ps).to(dev)
    pk = torch.zeros((1 + B * S // ps, ps, Hkv, hd), dtype=dtype, device=dev)
    paged = CU.fused_qkv_rope_commit(x, p, lens, pk, pk.clone(), cos=cos,
                                     sin=sin, table=table)
    for a, b in zip(got, paged):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_stats_and_qkv_launch_on_a_second_device():
    """K2 and K3 raise their wgmma kernels' dynamic shared-memory limit
    once per device (``hopper_host::allow_smem``), not once per process:
    after launching on card 0 they launch on card 1 too, on their wgmma
    routes, and match their plain versions there.  Skips with one card."""
    _cuda()
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards (the shared-memory limit per device)")
    for index in (0, 1):
        dev = torch.device("cuda", index)
        with torch.cuda.device(dev):
            gen = torch.Generator(device=dev).manual_seed(index)
            h = torch.randn((2, 64, 512), generator=gen, device=dev).to(BF16)
            w = (torch.randn((512, 4096), generator=gen, device=dev)
                 * 512 ** -0.5).to(BF16)
            cand = torch.randint(0, 4096, (2, 64), generator=gen, device=dev,
                                 dtype=torch.int32)
            tmax = torch.ones((2,), device=dev)
            before = TA.unembed_verify_stats.launches_by_route["wgmma"]
            got = TA.unembed_verify_stats(h, w, cand, tmax)
            assert TA.unembed_verify_stats.launches_by_route["wgmma"] \
                == before + 1
            ref = TA.unembed_verify_stats_plain(h, w, cand, tmax)
            for g, r in zip(got[1:], ref[1:]):
                assert ((g - r).abs() / r.abs().clamp(min=1.0)).max() < 2e-2
            p = {n: (torch.randn((512, H, 128), generator=gen, device=dev)
                     * 512 ** -0.5).to(BF16)
                 for n, H in (("wq", 8), ("wk", 2), ("wv", 2))}
            lens = torch.tensor([3, 40], dtype=torch.int32, device=dev)
            kc = torch.zeros((2, 256, 2, 128), dtype=BF16, device=dev)
            kr = kc.clone()
            before = CU.fused_qkv_rope_commit.launches_by_route["wgmma"]
            got = CU.fused_qkv_rope_commit(h, p, lens, kc, kc.clone())
            assert CU.fused_qkv_rope_commit.launches_by_route["wgmma"] \
                == before + 1
            ref = CU.fused_qkv_rope_commit_plain(h, p, lens, kr, kr.clone())
            torch.cuda.synchronize(dev)
            for g, r in zip((*got, kc), (*ref, kr)):
                err = ((g.float() - r.float()).abs()
                       / r.float().abs().clamp(min=1.0)).max().item()
                assert err < 2e-2


# ------------------------------------------- an lm head at a 16-byte pitch

# (d, V) of the heads whose V is not a multiple of 8: an edge case and
# granite-moe-1b-a400m's, internvl2-26b's and whisper-tiny's
PITCHED = [(512, 4099), (1024, 49155), (6144, 92553), (384, 51865)]
PITCHED_IDS = ["V4099", "granite-moe", "internvl2", "whisper-tiny"]


def _full(w):
    """The whole [d, pitch] allocation under a pitched [d, V] view."""
    return w.as_strided((w.shape[0], w.stride(0)), (w.stride(0), 1))


@pytest.mark.parametrize("v", [259, 4099, 49155, 92553, 51865, 256, 4096])
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_pitch_lm_head(v, dtype):
    """``pitch_lm_head`` puts a [d, V] head whose V is not a multiple of 8
    at a row pitch of ceil8(V): the same shape and values, the pad columns
    zero and outside the view; an aligned head, a pitched one and a tied
    model's ``embed.T`` come back as they are."""
    d = 6
    w = torch.randn((d, v)).to(dtype)
    p = TA.pitch_lm_head(w)
    if v % 8 == 0:
        assert p is w
        return
    pitch = -(-v // 8) * 8
    assert p.shape == w.shape and p.stride() == (pitch, 1)
    assert p.dtype == dtype and p.storage_offset() == 0
    assert torch.equal(p, w)
    assert p.untyped_storage().nbytes() == d * pitch * p.element_size()
    assert torch.equal(_full(p)[:, v:], torch.zeros((d, pitch - v),
                                                    dtype=dtype))
    assert TA.pitch_lm_head(p) is p
    assert TA.weight_layout(p) == "dv"
    tied = torch.randn((v, d)).to(dtype).T
    assert TA.pitch_lm_head(tied) is tied
    # a column slice of a wider head whose pitch is odd is laid out anew
    odd = torch.randn((d, v + 2)).to(dtype)[:, :v]
    q = TA.pitch_lm_head(odd)
    assert q.stride(0) == pitch and torch.equal(q, odd)


@pytest.mark.parametrize("N, d, v, dtype, ldw, aligned, want", [
    (256, 1024, 49155, BF16, 49160, True, ("wgmma", 132)),  # granite-moe
    (256, 6144, 92553, BF16, 92560, True, ("wgmma", 132)),  # internvl2
    (256, 384, 51865, BF16, 51872, True, ("wgmma", 132)),   # whisper-tiny
    (128, 512, 4099, BF16, 4104, True, ("wgmma", 66)),      # 33 tiles
    (256, 1024, 49155, F32, 49160, True, ("tile", 385)),    # f32: tile
    (256, 1024, 49155, BF16, 49155, True, ("tile", 385)),   # contiguous
    (256, 1024, 49155, BF16, 49157, True, ("tile", 385)),   # odd pitch
    (256, 1024, 49155, BF16, 49156, True, ("tile", 385)),   # 8-byte pitch
    (256, 1024, 49155, BF16, 49160, False, ("tile", 385)),  # pointer off
])
def test_stats_plan_over_a_pitched_head(N, d, v, dtype, ldw, aligned, want):
    """The route follows the head's row pitch, not V: a [d, V] head whose
    rows lie a multiple of 8 elements apart takes the wgmma route in bf16
    whatever V is; the wrapper's alignment check holds the pitch among
    its strides (``aligned16``)."""
    assert TA.stats_plan(N, d, v, dtype, aligned, 132, "dv", ldw) == want
    assert CU.aligned16((0, 512), (ldw,)) == (ldw % 8 == 0)


def test_weight_layout_takes_a_pitch_and_refuses_other_strides(monkeypatch):
    """A pitched head is ``"dv"``, and the kernel's operand is its own
    storage (no copy: ``contiguous`` / ``clone`` are not called), read at
    its pitch; a row stride below V, or columns not contiguous, raise."""
    w = TA.pitch_lm_head(torch.randn((48, 259)).to(BF16))

    def refuse(*a, **k):
        raise AssertionError("the lm head was copied")

    monkeypatch.setattr(torch.Tensor, "contiguous", refuse)
    monkeypatch.setattr(torch.Tensor, "clone", refuse)
    table, found = TA.stats_operand(w.to(BF16), "dv")
    assert found == "dv" and table.data_ptr() == w.data_ptr()
    assert table.stride() == (264, 1)
    monkeypatch.undo()
    base = torch.randn(48 * 259)
    with pytest.raises(ValueError, match="neither"):
        TA.weight_layout(base.as_strided((48, 259), (258, 1)))
    with pytest.raises(ValueError, match="neither"):
        TA.weight_layout(torch.randn((48, 518))[:, ::2])
    with pytest.raises(ValueError, match="laid out"):
        TA.stats_operand(w, "vd")


@pytest.mark.parametrize("negative", [False, True],
                         ids=["random", "negative"])
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_plain_stats_over_a_pitched_head_are_bitwise(dtype, negative):
    """The plain statistics (and the wrapper on the CPU) over a pitched
    head equal those over the contiguous head bit for bit, with 1e4 in
    every pad column (a pad column read as a logit would win every row);
    ``negative``: every real logit is below -20, where a pad column read
    as 0 would win."""
    rng = np.random.default_rng(3)
    B, T, d, v = 2, 8, 32, 259
    h = torch.from_numpy(rng.standard_normal((B, T, d))).to(dtype)
    w = torch.from_numpy(rng.standard_normal((d, v)) * d ** -0.5).to(dtype)
    if negative:
        h[..., 0] = 8.0
        w[0, :] = -4.0
    p = TA.pitch_lm_head(w)
    _full(p)[:, v:] = 1e4
    cand = torch.from_numpy(rng.integers(0, v, (B, T))).int()
    cand[:, -1] = v - 1
    tmax = torch.tensor([1.0, 0.7])
    for fn in (TA.unembed_verify_stats_plain, TA.unembed_verify_stats):
        for kw in ({}, {"block_v": 128}):
            if kw and fn is TA.unembed_verify_stats:
                continue
            got = fn(h, p, cand, tmax, **kw)
            want = TA.unembed_verify_stats_plain(h, w, cand, tmax, **kw)
            for g, r in zip(got, want):
                assert torch.equal(g, r)
            assert (got[0] < v).all()
    if negative:
        assert (want[1] < 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["greedy", "tmax", "poison", "negative"])
@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("d, v", PITCHED, ids=PITCHED_IDS)
def test_cuda_stats_over_a_pitched_head(d, v, dtype, case):
    """K2 over a [d, V] head laid out by ``pitch_lm_head`` (V not a
    multiple of 8): bf16 on the wgmma route, f32 on the tile route, each
    reading the rows at their pitch, against the plain version: greedy,
    at per-row temperatures, with 1e4 in the pad columns, and with every
    real logit negative (a pad column read as 0 would win).  f32 argm
    exactly; bf16 argm up to a near-tie of one bf16 step, m and cand_w
    within 2e-2 of their magnitude (3e-5 in f32), l within the same."""
    dev = _cuda()
    B, T = 4, 64
    gen = torch.Generator(device=dev).manual_seed(v)
    h = torch.randn((B, T, d), generator=gen, device=dev).to(dtype)
    w = (torch.randn((d, v), generator=gen, device=dev) * d ** -0.5).to(dtype)
    if case == "negative":
        h[..., 0] = 8.0
        w[0, :] = -4.0
    w = TA.pitch_lm_head(w)
    assert w.stride(0) == -(-v // 8) * 8
    if case == "poison":
        _full(w)[:, v:] = 1e4
    cand = torch.randint(0, v, (B, T), generator=gen, device=dev,
                         dtype=torch.int32)
    cand[:, -1] = v - 1
    tmax = (torch.tensor([0.7, 1.0, 1e-6, 2.0], device=dev) if case == "tmax"
            else torch.ones((B,), device=dev))
    route = "wgmma" if dtype == BF16 else "tile"
    before = dict(TA.unembed_verify_stats.launches_by_route)
    argm, m, l, cw = TA.unembed_verify_stats(h, w, cand, tmax)
    assert TA.unembed_verify_stats.launches_by_route[route] \
        == before[route] + 1
    rargm, rm, rl, rcw = TA.unembed_verify_stats_plain(h, w, cand, tmax)
    torch.cuda.synchronize()
    assert ((argm >= 0) & (argm < v)).all()
    if case == "negative":
        assert (rm < 0).all() and (m < 0).all()
    t2, t3 = tmax[:, None], tmax[:, None, None]
    tol = 2e-2 if dtype == BF16 else 3e-5
    assert ((m - rm).abs() * t2 / (rm * t2).abs().clamp(min=1.0)
            ).max().item() < tol
    assert ((cw - rcw).abs() * t3 / (rcw * t3).abs().clamp(min=1.0)
            ).max().item() < tol
    logits = torch.matmul(h, w).float() / t3
    l_own = torch.exp(logits - m[..., None]).sum(-1)
    assert torch.minimum((l / rl - 1).abs(), (l / l_own - 1).abs()
                         ).max().item() < tol
    if dtype == F32:
        assert torch.equal(argm, rargm)
        return
    differ = argm != rargm
    if differ.any():
        gap = rm[differ] - logits[differ, argm[differ].long()]
        assert (gap <= 2.0 ** (torch.floor(torch.log2(rm[differ].abs())) - 7)
                ).all()


@pytest.mark.cuda
def test_cuda_stats_keep_a_pitch_through_the_cast():
    """A pitched f32 head under bf16 hidden states: the wrapper's cast to
    bf16 is a copy at the same pitch, so the launch takes the wgmma route
    (a contiguous copy would take the tile route)."""
    dev = _cuda()
    d, v = 1024, 49155
    gen = torch.Generator(device=dev).manual_seed(0)
    h = torch.randn((4, 64, d), generator=gen, device=dev).to(BF16)
    w = TA.pitch_lm_head(torch.randn((d, v), generator=gen, device=dev)
                         * d ** -0.5)
    cand = torch.randint(0, v, (4, 64), generator=gen, device=dev,
                         dtype=torch.int32)
    tmax = torch.ones((4,), device=dev)
    before = dict(TA.unembed_verify_stats.launches_by_route)
    got = TA.unembed_verify_stats(h, w, cand, tmax)
    assert TA.unembed_verify_stats.launches_by_route["wgmma"] \
        == before["wgmma"] + 1
    ref = TA.unembed_verify_stats_plain(h, w, cand, tmax)
    for g, r in zip(got[1:], ref[1:]):
        assert ((g - r).abs() / r.abs().clamp(min=1.0)).max() < 2e-2
