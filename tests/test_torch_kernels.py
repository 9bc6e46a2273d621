"""The port's tree attention against the JAX reference on the CPU.

``flash_decode`` takes its plain PyTorch version on CPU tensors; it is held
against the Pallas kernel run in interpret mode, and ``ops.tree_attention``
against the reference wrapper and its oracle, over the reference kernel
tests' shape sweep (``tests/test_kernels.py::CASES``).  Tolerances are
that file's: 3e-5 for float32, 2e-2 for bfloat16 (bf16 rounds p and the
outputs at other places in the two frameworks).  The CUDA kernel itself
runs only on the card: ``test_torch_cuda.py`` (which imports no JAX, so it
runs there) and ``chip_smoke.py`` hold it to the same sweep."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.tree import chain_tree, medusa_63
from repro.kernels import ops as JO
from repro.kernels import ref as JR
from repro.kernels.tree_attention import flash_decode as jax_flash_decode
from repro_torch.kernels import ops as TO
from repro_torch.kernels import ref as TR
from repro_torch.kernels.tree_attention import flash_decode

# B, S, Hq, Hkv, D, tree, dtype — tests/test_kernels.py::CASES
CASES = [
    (2, 1024, 8, 2, 64, "medusa", "float32"),
    (1, 512, 4, 4, 128, "chain", "float32"),
    (3, 2048, 8, 1, 128, "medusa", "bfloat16"),
    (2, 640, 6, 2, 64, "chain", "float32"),
    (1, 256, 2, 2, 256, "chain", "bfloat16"),
    (2, 512, 16, 8, 64, "medusa", "float32"),
]
TOL = {"float32": 3e-5, "bfloat16": 2e-2}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture
def rng():
    """Each test's inputs from its own seed, whatever ran before it (the
    shared fixture is one generator for the whole session)."""
    return np.random.default_rng(0)


def _inputs(rng, B, S, Hq, Hkv, D, tree, dt):
    tb = medusa_63() if tree == "medusa" else chain_tree(4)
    T = tb.T
    q = rng.standard_normal((B, T, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    lengths = rng.integers(1, S - T - 1, size=(B,)).astype(np.int32)
    jx = [jnp.asarray(a, dt) for a in (q, k, v)]
    tx = [torch.from_numpy(a).to(TDT[dt]) for a in (q, k, v)]
    return tb, jx, tx, lengths


def _err(t, j):
    return float(np.max(np.abs(t.float().numpy()
                               - np.asarray(j, np.float32))))


def _stats_err(got, ref):
    """acc / l (what the merge consumes), m, and l relative."""
    acc, m, l = (x.float().numpy() for x in got)
    racc, rm, rl = (np.asarray(x, np.float32) for x in ref)
    return max(np.max(np.abs(acc / l - racc / rl)), np.max(np.abs(m - rm)),
               np.max(np.abs(l / rl - 1)))


@pytest.mark.parametrize("B,S,Hq,Hkv,D,tree,dt", CASES)
def test_plain_flash_decode_matches_pallas(rng, B, S, Hq, Hkv, D, tree, dt):
    # the folded row count the wrapper gives the kernel: G * T_pad
    T, G = (medusa_63() if tree == "medusa" else chain_tree(4)).T, Hq // Hkv
    T_pad = T
    while (G * T_pad) % 8:
        T_pad += 1
    R = G * T_pad
    q = rng.standard_normal((B, Hkv, R, D)).astype(np.float32) / np.sqrt(D)
    k = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    lengths = rng.integers(1, S + 1, size=(B,)).astype(np.int32)
    ref = jax_flash_decode(jnp.asarray(q, dt),
                           jnp.asarray(k, dt).transpose(0, 2, 1, 3),
                           jnp.asarray(v, dt).transpose(0, 2, 1, 3),
                           jnp.asarray(lengths), interpret=True)
    got = flash_decode(*(torch.from_numpy(a).to(TDT[dt]) for a in (q, k, v)),
                       torch.from_numpy(lengths))
    assert _stats_err(got, ref) < TOL[dt]


@pytest.mark.parametrize("B,S,Hq,Hkv,D,tree,dt", CASES)
def test_tree_attention_matches_reference(rng, B, S, Hq, Hkv, D, tree, dt):
    tb, (jq, jk, jv), (q, k, v), lengths = _inputs(rng, B, S, Hq, Hkv, D,
                                                   tree, dt)
    scale = 1.0 / np.sqrt(D)
    jmask, tmask = jnp.asarray(tb.mask), torch.from_numpy(tb.mask)
    tl = torch.from_numpy(lengths)
    out = TO.tree_attention(q, k, v, tmask, tl, scale)
    ref_kernel = JO.tree_attention(jq, jk, jv, jmask, jnp.asarray(lengths),
                                   scale, interpret=True)
    ref_oracle = JR.tree_attention_ref(jq, jk, jv, jmask,
                                       jnp.asarray(lengths), scale)
    assert _err(out, ref_kernel) < TOL[dt]
    assert _err(out, ref_oracle) < TOL[dt]
    assert _err(TR.tree_attention_ref(q, k, v, tmask, tl, scale),
                ref_oracle) < TOL[dt]


def test_oracle_mask_matches_reference():
    tb = medusa_63()
    lengths = np.array([0, 7, 190], np.int32)     # 190 + T runs past S
    got = TR.decode_mask_ref(torch.from_numpy(tb.mask),
                             torch.from_numpy(lengths), 200)
    ref = JR.decode_mask_ref(jnp.asarray(tb.mask), jnp.asarray(lengths), 200)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_length_one_and_inflight_rows(rng):
    """Minimal cache occupancy, and the k_tree/v_tree bypass."""
    tb = chain_tree(3)
    T = tb.T
    q = torch.from_numpy(rng.standard_normal((2, T, 4, 64)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 512, 2, 64)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((2, 512, 2, 64)).astype(np.float32))
    mask = torch.from_numpy(tb.mask)
    for lengths in ([1, 1], [100, 200]):
        tl = torch.tensor(lengths, dtype=torch.int32)
        a = TO.tree_attention(q, k, v, mask, tl, 0.125)
        ref = TR.tree_attention_ref(q, k, v, mask, tl, 0.125)
        np.testing.assert_allclose(a.numpy(), ref.numpy(), atol=3e-5)
        idx = tl[:, None].long() + torch.arange(T)
        rows = torch.arange(2)[:, None]
        b = TO.tree_attention(q, k, v, mask, tl, 0.125,
                              k_tree=k[rows, idx], v_tree=v[rows, idx])
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)


def test_length_zero_row_gives_empty_stats(rng):
    q = torch.from_numpy(rng.standard_normal((2, 1, 8, 64)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 64, 1, 64)).astype(np.float32))
    acc, m, l = flash_decode(q, k, k, torch.tensor([0, 9], dtype=torch.int32))
    assert (acc[0] == 0).all() and (l[0] == 0).all()
    assert (m[0] == -1e30).all() and (l[1] > 0).all()
