"""The one-launch commit of a spec step against the JAX reference on the
CPU.

``cache_update.commit_path_stacked`` commits every unit's accepted rows
of every cache leaf in one launch on the card (K4 dense, K5 paged),
reading the in-flight rows where decode left them; on the CPU it takes
its plain version, ``commit_path_stacked_plain`` (the gather of the best
path's rows, ``quantize_rows`` under int8, the rows-given plain writes).
Here the same numpy inputs go through the port's ``transformer.commit``
(the model's commit, which calls the wrapper) and the reference's
``transformer.commit`` on reduced openPangu-7B:

* on the dense, int8, paged and int8 + paged caches, with decode's
  in-flight rows given as a tuple of per-unit tensors (as the port's
  decode hands them) and as one stacked tensor (as the reference holds
  them), path slots int32 and int64, accepted lengths below K1: every
  leaf bitwise the reference's, rows past S dropped, rows past the table
  in trash block 0 (pools compared except block 0), lengths + acc equal;
* the CUDA wrapper's argument checks, which run before anything touches
  the card: more units than the kernel's source table holds, a source
  that overlaps a cache leaf, leaves of different dtypes, an int8 leaf
  without scales, a head_dim the quantizing kernel does not take and a
  path of the wrong shape each raise.

Integer and quantized outputs must match exactly; so must every fp leaf
(the commit copies, it does not compute)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.models import transformer as JT
from repro_torch.configs.registry import get_config
from repro_torch.kernels import cache_update as CU
from repro_torch.models import transformer as TT

LAYOUTS = {"dense": {}, "int8": dict(cache_dtype="int8"),
           "paged": dict(cache_layout="paged", page_size=8),
           "int8+paged": dict(cache_dtype="int8", cache_layout="paged",
                              page_size=8)}
B, T, K1, S_MAX = 3, 8, 5, 32


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module's torch work (the suite runs in
    several workers on a few cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.array(a))


def _spec_caches(rng, layout):
    """(jax cfg, torch cfg, numpy leaves, numpy in-flight rows, table or
    None): a reduced openPangu-7B cache of random contents (a shuffled
    block table when paged) and random in-flight rows."""
    jcfg = dataclasses.replace(jax_get_config("openpangu-7b", reduced=True),
                               **LAYOUTS[layout])
    tcfg = dataclasses.replace(get_config("openpangu-7b", reduced=True),
                               **LAYOUTS[layout])
    cache = JT.init_cache(jcfg, B, S_MAX)
    entry = cache["pos0"]
    leaves = {}
    for name, leaf in entry.items():
        shape = leaf.shape
        if leaf.dtype == jnp.int8:
            leaves[name] = rng.integers(-127, 128, shape).astype(np.int8)
        elif name.endswith("_scale"):
            leaves[name] = rng.uniform(0.01, 1.0, shape).astype(np.float32)
        else:
            leaves[name] = rng.standard_normal(shape).astype(np.float32)
    nu, H, D = entry["k"].shape[0], entry["k"].shape[-2], entry["k"].shape[-1]
    new = {n: rng.standard_normal((nu, B, T, H, D)).astype(np.float32)
           for n in ("k_new", "v_new")}
    table = None
    if JT.PAGES_KEY in cache:
        mb = cache[JT.PAGES_KEY]["table"].shape[1]
        table = (rng.permutation(B * mb) + 1).reshape(B, mb).astype(np.int32)
    return jcfg, tcfg, leaves, new, table


@pytest.mark.parametrize("sources", ["tuple", "stacked"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_commit_matches_reference(layout, sources):
    rng = np.random.default_rng(list(LAYOUTS).index(layout))
    jcfg, tcfg, leaves, new, table = _spec_caches(rng, layout)
    # in range, straddling the end and wholly past it (dense: dropped;
    # paged: past the table, into trash block 0)
    lengths = np.array([0, S_MAX - 3, S_MAX], np.int32)
    path = rng.integers(0, T, (B, K1)).astype(np.int32)
    acc = np.array([1, 3, K1], np.int32)
    jspec = {"pos0": {n: jnp.asarray(a) for n, a in {**leaves,
                                                       **new}.items()}}
    tentry = {n: _t(a) for n, a in leaves.items()}
    for n, a in new.items():
        tentry[n] = tuple(_t(a)) if sources == "tuple" else _t(a)
    tspec = {"pos0": tentry}
    if table is not None:
        jspec[JT.PAGES_KEY] = {"table": jnp.asarray(table)}
        tspec[TT.PAGES_KEY] = {"table": _t(table)}
    tpath = _t(path) if sources == "tuple" else _t(path).long()
    jc, jlen = JT.commit(jcfg, jspec, jnp.asarray(lengths),
                         jnp.asarray(path), jnp.asarray(acc))
    tc, tlen = TT.commit(tcfg, tspec, _t(lengths), tpath, _t(acc))
    np.testing.assert_array_equal(tlen.numpy(), np.asarray(jlen))
    assert set(tc["pos0"]) == set(leaves)
    for name in leaves:
        got, want = tc["pos0"][name].numpy(), np.asarray(jc["pos0"][name])
        if table is not None:       # several dead rows race on block 0
            got, want = got[:, 1:], want[:, 1:]
        np.testing.assert_array_equal(got, want)
        assert tc["pos0"][name] is tentry[name]     # written in place
    if table is None:               # slot 2 lies wholly past S: untouched
        for name in leaves:
            np.testing.assert_array_equal(tc["pos0"][name][:, 2].numpy(),
                                          leaves[name][:, 2])


def _commit_args(nu=3, H=2, D=16, dtype=torch.float32, int8=False):
    leaves = {"k": torch.zeros((nu, B, S_MAX, H, D),
                               dtype=torch.int8 if int8 else dtype),
              "v": torch.zeros((nu, B, S_MAX, H, D),
                               dtype=torch.int8 if int8 else dtype)}
    if int8:
        leaves |= {n: torch.zeros((nu, B, S_MAX, H, 1))
                   for n in ("k_scale", "v_scale")}
    sources = {n: tuple(torch.zeros((B, T, H, D), dtype=dtype)
                        for _ in range(nu)) for n in "kv"}
    path = torch.zeros((B, K1), dtype=torch.int64)
    lengths = torch.zeros((B,), dtype=torch.int32)
    return leaves, sources, path, lengths


def _pairs(leaves, sources):
    return [(list(sources[n]), leaves[n], leaves.get(n + "_scale"))
            for n in sources]


def _too_many_units():
    leaves, sources, path, lengths = _commit_args(
        nu=CU.COMMIT_MAX_UNITS + 1, H=1, D=8)
    return _pairs(leaves, sources), path, lengths, "source table holds"


def _overlap():
    leaves, sources, path, lengths = _commit_args()
    # unit 1's k rows are a view into the v cache, laid out as a source
    view = leaves["v"].view(-1)[:B * T * 2 * 16].view(B, T, 2, 16)
    sources["k"] = (sources["k"][0], view, sources["k"][2])
    return _pairs(leaves, sources), path, lengths, "overlaps a cache leaf"


def _mixed_leaves():
    leaves, sources, path, lengths = _commit_args()
    leaves["v"] = leaves["v"].to(torch.bfloat16)
    return _pairs(leaves, sources), path, lengths, "leaves differ"


def _int8_without_scales():
    leaves, sources, path, lengths = _commit_args(int8=True)
    pairs = [(u, leaf, None) for u, leaf, _ in _pairs(leaves, sources)]
    return pairs, path, lengths, "rows of torch.float32 for a torch.int8"


def _head_dim_24():
    leaves, sources, path, lengths = _commit_args(D=24, int8=True)
    return _pairs(leaves, sources), path, lengths, "head_dim"


def _path_shape():
    leaves, sources, path, lengths = _commit_args()
    return _pairs(leaves, sources), path[:, :, None], lengths, "path_slots"


@pytest.mark.parametrize("case", [_too_many_units, _overlap, _mixed_leaves,
                                  _int8_without_scales, _head_dim_24,
                                  _path_shape])
def test_commit_kernel_refuses_what_it_does_not_take(case):
    """The CUDA wrapper's checks, which raise before the library loads
    (these CPU tensors would reach the kernel on the card)."""
    pairs, path, lengths, match = case()
    with pytest.raises((ValueError, TypeError), match=match):
        CU._launch_commit("commit_path_stacked", pairs, path, lengths, None)
