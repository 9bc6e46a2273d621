"""Guards on the PyTorch port's boundaries.

* No module of ``src/repro_torch/``, and not ``chip_smoke.py``, imports
  ``jax``, ``jaxlib`` or the reference package ``repro`` (the machine with
  the card has no JAX; the port keeps its own copies).
* The entry points raise when there is no GPU and the caller did not ask
  for ``device="cpu"``: nothing falls back to the CPU on its own.
* On CPU tensors every kernel wrapper takes its plain version and
  launches nothing; on any other non-CUDA device it raises.
"""
import ast
import pathlib

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    return sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
        [ROOT / "chip_smoke.py"]


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr",
                          getattr(node.func, "id", "")) in
              ("import_module", "__import__")):
            yield node.args[0].value


def test_port_imports_nothing_of_jax_or_the_reference():
    files = _port_files()
    assert len(files) > 10
    # the tensor- and data-parallel layer is scanned too
    assert {p.name for p in files if p.parent.name == "distributed"} == {
        "__init__.py", "collectives.py", "profiles.py", "sharding.py",
        "tp.py"}
    bad = []
    for path in files:
        for mod in _imported(ast.parse(path.read_text(), str(path))):
            if mod.split(".")[0] in FORBIDDEN:
                bad.append(f"{path.relative_to(ROOT)}: {mod}")
    assert bad == []


def test_guard_sees_a_forbidden_import():
    tree = ast.parse("import jax.numpy as jnp\nfrom repro.core import tree\n"
                     "from repro_torch.core import tree\n"
                     "importlib.import_module('jaxlib')\n")
    hits = [m for m in _imported(tree) if m.split(".")[0] in FORBIDDEN]
    assert hits == ["jax.numpy", "repro.core", "jaxlib"]


def test_entry_points_raise_without_a_gpu(monkeypatch):
    from repro_torch import bridge
    from repro_torch.configs.registry import get_config
    from repro_torch.core.engine import SpecEngine, build_engine
    from repro_torch.distributed import collectives
    from repro_torch.launch import serve
    from repro_torch.models import api, transformer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("openpangu-7b", reduced=True)
    for call in (lambda: serve.main(["--reduced", "--requests", "1"]),
                 lambda: build_engine(cfg),
                 lambda: SpecEngine(cfg),
                 lambda: bridge.to_torch({}),
                 lambda: api.init_cache(cfg, 1, 16),
                 lambda: transformer.init_cache(cfg, 1, 16),
                 lambda: collectives.spawn(print, 2, backend="gloo"),
                 lambda: collectives.rank_device("gloo", 0)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    # tensor parallelism on nccl wants a card a rank, and says how to
    # choose gloo instead
    with pytest.raises(SystemExit, match="--tp-backend gloo"):
        serve.main(["--reduced", "--tp", "2"])
    # asking for the CPU works
    assert build_engine(cfg, device="cpu").device.type == "cpu"
    assert api.init_cache(cfg, 1, 16, device="cpu")["pos0"]["k"].is_cpu


def test_kernel_wrapper_launches_nothing_on_the_cpu():
    from repro_torch.kernels import cache_update as CU
    from repro_torch.kernels.cache_update import fused_qkv_rope_commit
    from repro_torch.kernels.ops import tree_attention, verify_stats
    from repro_torch.kernels.paging import identity_table
    from repro_torch.kernels.tree_attention import (flash_decode,
                                                    unembed_verify_stats)
    commits = (CU.commit_rows_stacked, CU.commit_rows_paged_stacked)
    wrappers = (flash_decode, unembed_verify_stats, fused_qkv_rope_commit,
                *commits)
    before = [f.launches for f in wrappers]
    q = torch.randn(1, 2, 8, 64)
    k = torch.randn(1, 32, 2, 64)
    lengths = torch.tensor([5], dtype=torch.int32)
    table = identity_table(1, 2)
    pool = torch.randn(3, 16, 2, 64)
    k8 = torch.randint(-127, 128, (1, 32, 2, 64), dtype=torch.int8)
    ks = torch.rand(1, 32, 2, 1)
    flash_decode(q, k, k, lengths)
    flash_decode(q, k8, k8, lengths, k_scale=ks, v_scale=ks)
    flash_decode(q, pool, pool, lengths, block_tables=table)
    tree_attention(torch.randn(1, 3, 2, 64), k, k,
                   torch.ones(3, 3, dtype=torch.bool), lengths, 0.125)
    h, w = torch.randn(1, 3, 16), torch.randn(16, 40)
    cand = torch.zeros(1, 3, dtype=torch.int32)
    verify_stats(h, w, cand, torch.ones(1))
    p = {"wq": torch.randn(16, 4, 64), "wk": torch.randn(16, 2, 64),
         "wv": torch.randn(16, 2, 64)}
    fused_qkv_rope_commit(h, p, lengths, k, k.clone())
    fused_qkv_rope_commit(h, p, lengths, pool, pool.clone(), table=table)
    rows = torch.randn(1, 5, 2, 64)
    rows8 = torch.randint(-127, 128, (1, 5, 2, 64), dtype=torch.int8)
    CU.commit_rows_stacked(k[None].clone(), rows[None], lengths)
    CU.commit_rows_stacked(k8[None].clone(), rows8[None], lengths)
    CU.commit_rows_stacked(ks[None].clone(), rows[None, ..., :1], lengths)
    CU.commit_rows_paged_stacked(pool[None].clone(), table, rows[None],
                                 lengths)
    CU.commit_rows_paged_stacked(pool[None].to(torch.int8), table,
                                 rows8[None], lengths)
    # the one-launch commit counts under K4 / K5, and not on the CPU
    path = torch.zeros((1, 5), dtype=torch.int64)
    src = {n: (torch.randn(1, 8, 2, 64),) for n in "kv"}
    CU.commit_path_stacked({"k": k[None].clone(), "v": k[None].clone()},
                           src, path, lengths)
    CU.commit_path_stacked({"k": k8[None].clone(), "v": k8[None].clone(),
                            "k_scale": ks[None].clone(),
                            "v_scale": ks[None].clone()}, src, path, lengths)
    CU.commit_path_stacked({"k": pool[None].clone(), "v": pool[None].clone()},
                           src, path, lengths, table=table)
    assert [f.launches for f in wrappers] == before
    meta = {n: t.to("meta") for n, t in
            (("k", k), ("pool", pool), ("rows", rows), ("lengths", lengths),
             ("table", table), ("k8", k8), ("ks", ks))}
    for call in (lambda: unembed_verify_stats(h.to("meta"), w.to("meta"),
                                              cand.to("meta"),
                                              torch.ones(1, device="meta")),
                 lambda: fused_qkv_rope_commit(
                     h.to("meta"), p, meta["lengths"], meta["k"], meta["k"]),
                 lambda: fused_qkv_rope_commit(
                     h.to("meta"), p, meta["lengths"], meta["pool"],
                     meta["pool"], table=meta["table"]),
                 lambda: CU.commit_rows_stacked(
                     meta["k"][None], meta["rows"][None], meta["lengths"]),
                 lambda: CU.commit_rows_stacked(
                     meta["k8"][None], meta["rows"][None], meta["lengths"]),
                 lambda: CU.commit_rows_paged_stacked(
                     meta["pool"][None], meta["table"], meta["rows"][None],
                     meta["lengths"]),
                 lambda: CU.commit_path_stacked(
                     {"k": meta["k"][None], "v": meta["k"][None]},
                     {"k": (meta["k"],), "v": (meta["k"],)},
                     torch.zeros((1, 5), dtype=torch.int64, device="meta"),
                     meta["lengths"]),
                 lambda: flash_decode(q.to("meta"), meta["k"], meta["k"],
                                      meta["lengths"]),
                 lambda: flash_decode(q.to("meta"), meta["k8"], meta["k8"],
                                      meta["lengths"], k_scale=meta["ks"],
                                      v_scale=meta["ks"]),
                 lambda: flash_decode(q.to("meta"), meta["pool"],
                                      meta["pool"], meta["lengths"],
                                      block_tables=meta["table"])):
        with pytest.raises(ValueError, match="unsupported device"):
            call()
    # an int8 cache without its scales (or scales for an fp cache) raises
    with pytest.raises(ValueError, match="k_scale"):
        flash_decode(q, k8, k8, lengths)
    with pytest.raises(ValueError, match="k_scale"):
        flash_decode(q, k, k, lengths, k_scale=ks, v_scale=ks)
