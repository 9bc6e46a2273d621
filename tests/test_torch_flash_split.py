"""K1's split-KV design in plain PyTorch against the JAX reference.

On the card, ``flash_decode`` runs over the grid ``decode_plan`` chooses:
each split of whole 64-column tiles leaves partial statistics, and a merge
combines the splits that start below a slot's length in split order.
``flash_decode_split_plain`` is that split-and-merge in plain PyTorch; it
is held here against the Pallas ``flash_decode`` in interpret mode over
``tests/test_kernels.py::CASES`` in the fp, int8, paged and int8 + paged
forms, with the plan's splits and with splits of one and three tiles,
so that most splits start past a slot's length; a slot of length 0
(with a zero table when paged) must give exactly empty statistics.
Tolerances are the reference kernel tests': 3e-5 (f32), 2e-2 (bf16).
On CPU tensors ``flash_decode`` itself still takes ``flash_decode_plain``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.tree import chain_tree, medusa_63
from repro.kernels.tree_attention import flash_decode as jax_flash_decode
from repro_torch.kernels import quant as Q
from repro_torch.kernels.tree_attention import (decode_plan, flash_decode,
                                                flash_decode_plain,
                                                flash_decode_split_plain,
                                                merge_split_stats)

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
FORMS = ["fp", "int8", "paged", "int8+paged"]


def _folded_rows(Hq, Hkv, tree):
    T, G = (medusa_63() if tree == "medusa" else chain_tree(4)).T, Hq // Hkv
    T_pad = T
    while (G * T_pad) % 8:
        T_pad += 1
    return G * T_pad


def _pool(rng, dense, table, ps):
    """Pool [1 + B*mb, ps, ...] holding ``dense`` [B, mb*ps, ...] through
    ``table``; block 0 and the idle slot's blocks hold noise."""
    B, mb = table.shape
    pool = torch.from_numpy(rng.standard_normal(
        (1 + B * mb, ps) + tuple(dense.shape[2:]))).to(dense.dtype)
    pool[torch.from_numpy(table).long()] = dense.reshape(
        (B, mb, ps) + tuple(dense.shape[2:]))
    return pool


def _jax(t, dtype=None):
    """A port-layout tensor [N, S, Hkv, .] in the TPU kernel's layout
    [N, Hkv, S, .]."""
    a = t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()
    return jnp.asarray(np.ascontiguousarray(a.transpose(0, 2, 1, 3)), dtype)


def _err(got, ref, live):
    acc, m, l = (x.float().numpy()[live] for x in got)
    racc, rm, rl = (np.asarray(x, np.float32)[live] for x in ref)
    return max(np.max(np.abs(acc / l - racc / rl)), np.max(np.abs(m - rm)),
               np.max(np.abs(l / rl - 1)))


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("B,S,Hq,Hkv,D,tree,dt", CASES)
def test_split_plain_matches_pallas(B, S, Hq, Hkv, D, tree, dt, form):
    rng = np.random.default_rng(S + D)
    R = _folded_rows(Hq, Hkv, tree)
    q = torch.from_numpy(rng.standard_normal((B, Hkv, R, D)) / np.sqrt(D))
    q = q.float().to(TDT[dt])
    kd = torch.from_numpy(rng.standard_normal((B, S, Hkv, D))).float()
    vd = torch.from_numpy(rng.standard_normal((B, S, Hkv, D))).float()
    lengths = rng.integers(1, S + 1, size=(B,)).astype(np.int32)
    if B > 1:
        lengths[0] = 0                           # an idle slot
    live = lengths > 0
    tl = torch.from_numpy(lengths)
    if "int8" in form:
        (kd, ks), (vd, vs) = Q.quantize_rows(kd), Q.quantize_rows(vd)
        leaves = {"k": kd, "v": vd, "k_scale": ks, "v_scale": vs}
    else:
        leaves = {"k": kd.to(TDT[dt]), "v": vd.to(TDT[dt])}
    jdt = None if "int8" in form else jnp.dtype(dt)
    kw, jkw = {}, {}
    if "paged" in form:
        ps = 64
        table = (1 + rng.permutation(B * S // ps)).reshape(B, S // ps)
        table = table.astype(np.int32)
        table[~live] = 0                         # the idle slot's table
        leaves = {n: _pool(rng, t, table, ps) for n, t in leaves.items()}
        kw["block_tables"] = torch.from_numpy(table)
        jkw["block_tables"] = jnp.asarray(table)
    if "int8" in form:
        kw |= {"k_scale": leaves["k_scale"], "v_scale": leaves["v_scale"]}
        jkw |= {"k_scale": _jax(leaves["k_scale"]),
                "v_scale": _jax(leaves["v_scale"])}
    ref = jax_flash_decode(jnp.asarray(q.float().numpy(), dt),
                           _jax(leaves["k"], jdt), _jax(leaves["v"], jdt),
                           jnp.asarray(lengths), interpret=True, **jkw)
    plan = decode_plan(B, Hkv, R, S, TDT[dt])
    for split_cols in (None, 64, 192):
        got = flash_decode_split_plain(q, leaves["k"], leaves["v"], tl,
                                       split_cols=split_cols, **kw)
        assert _err(got, ref, live) < TOL[dt], (split_cols, plan)
        if not live.all():
            assert (got[0][~live] == 0).all() and (got[2][~live] == 0).all()
            assert (got[1][~live] == -1e30).all()


def test_merge_passes_a_single_live_split_through():
    """A slot whose only live split is the first gets that split's
    statistics bit for bit (exp(0) = 1); splits past the length and an
    all-empty slot take no part."""
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.standard_normal((3, 2, 8, 64))).float()
    k = torch.from_numpy(rng.standard_normal((3, 256, 2, 64))).float()
    v = torch.from_numpy(rng.standard_normal((3, 256, 2, 64))).float()
    lengths = torch.tensor([0, 50, 64], dtype=torch.int32)
    parts = [flash_decode_plain(q, k[:, c:c + 64], v[:, c:c + 64],
                                torch.clamp(lengths - c, 0, 64))
             for c in range(0, 256, 64)]
    acc, m, l = merge_split_stats(parts, lengths, 64)
    for x, part in zip((acc, m, l), parts[0]):
        assert torch.equal(x[1:], part[1:])
    assert (acc[0] == 0).all() and (l[0] == 0).all()
    assert (m[0] == -1e30).all()


def test_split_must_be_whole_tiles():
    q = torch.zeros(1, 1, 8, 64)
    k = torch.zeros(1, 128, 1, 64)
    with pytest.raises(ValueError, match="whole 64-column tiles"):
        flash_decode_split_plain(q, k, k, torch.tensor([5], dtype=torch.int32),
                                 split_cols=96)


@pytest.mark.parametrize("form", FORMS)
def test_cpu_flash_decode_is_the_plain_version(form):
    """On CPU tensors the wrapper is ``flash_decode_plain``, bit for bit,
    and counts no launch on any route."""
    rng = np.random.default_rng(2)
    q = torch.from_numpy(rng.standard_normal((2, 2, 8, 64))).float()
    k = torch.from_numpy(rng.standard_normal((2, 128, 2, 64))).float()
    v = torch.from_numpy(rng.standard_normal((2, 128, 2, 64))).float()
    lengths = torch.tensor([0, 100], dtype=torch.int32)
    kw = {}
    if "int8" in form:
        (k, kw["k_scale"]), (v, kw["v_scale"]) = (Q.quantize_rows(k),
                                                  Q.quantize_rows(v))
    if "paged" in form:
        table = np.array([[0, 0], [3, 1]], np.int32)
        k, v = (_pool(rng, t, table, 64) for t in (k, v))
        kw = {n: _pool(rng, t, table, 64) for n, t in kw.items()}
        kw["block_tables"] = torch.from_numpy(table)
    launches = flash_decode.launches
    routes = dict(flash_decode.launches_by_route)
    got = flash_decode(q, k, v, lengths, **kw)
    for a, b in zip(got, flash_decode_plain(q, k, v, lengths, **kw)):
        assert torch.equal(a, b)
    assert flash_decode.launches == launches
    assert flash_decode.launches_by_route == routes
