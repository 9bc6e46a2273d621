"""The port's dry-run planner against the reference, on the CPU (one torch
thread, no card, no device of JAX's beyond its one CPU device except in
one subprocess).

* Shapes and cells: ``ShapeConfig``, ``SHAPES``, ``shape_applicable``,
  ``ASSIGNED_ARCHS``, ``get_shape`` and ``iter_cells`` equal the
  reference's (40 cells, 8 skipped with its reason).
* Rules: ``make_rules`` equals the reference's for every kind,
  ``multi_pod`` and ``fsdp`` setting (the reference's other two options
  at their defaults: nothing in the port sets them).
* Axes: ``param_axes`` and ``medusa_axes`` equal the axes tree of the
  reference's ``split_params`` (by ``jax.eval_shape``) for all 11
  architectures at full width.
* Cells: ``build_cell`` equals the reference's ``build_cell`` leaf for
  leaf (path, shape, dtype and spec of every argument: parameters,
  Medusa heads, optimizer state, cache and activations), with the same
  donations and ``meta``, for all 11 architectures x the four shapes x
  both production meshes at full width, and on a 2 x 2 mesh at the
  reduced configs and a reduced ``ShapeConfig``.  The reference's
  ``NamedSharding`` is replaced by its spec, so its own ``build_cell``
  runs on the port's ``Mesh`` (sizes only) with no device.
* Cache placements: ``cache_pspecs`` equals the reference's on the
  dense, int8, paged and int8 + paged caches, the SSM and hybrid state
  and the encoder-decoder's cross entry, on both production meshes, at
  batch 128 and at batch 1 (``long_500k``'s rule).
* Bytes: the planner's per-device argument bytes equal the sums of the
  reference's ``NamedSharding.shard_shape`` on a forced 2 x 4 mesh (a
  subprocess with 8 host devices) for every reduced cell, and one
  compiled cell's ``memory_analysis().argument_size_in_bytes`` (compiled
  with ``keep_unused=True``: by default jit drops the arguments the
  greedy step never reads, its key and ``mprob``, 648 bytes there).
* The tracker: ``StorageTracker``'s temp and accessed bytes equal a hand
  count on a small program, on fake and on real tensors.
* The CLI at full width: ``--arch openpangu-7b --shape decode_32k`` exits
  0; its argument bytes equal the reference's placement's, its FLOPs lie
  within [1.00, 1.05] of ``benchmarks/roofline.py::analytic_flops``.
  A tensor-parallel cell (qwen1.5-0.5b decode on 16 x 16) is planned per
  device with 2 all-reduces a layer, one for the verify statistics and
  one all-gather.

The planned tp-2 collectives against a metered gloo run are held in
``tests/test_torch_tp.py``, whose shared ranks run the step.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from benchmarks.roofline import analytic_flops
from repro.configs import base as JB
from repro.configs import registry as JR
from repro.core import medusa as JM
from repro.distributed import profiles as JProfiles
from repro.distributed.sharding import split_params
from repro.launch import specs as JS
from repro.models.api import get_model as jax_get_model
from repro_torch.configs import base as TB
from repro_torch.configs import registry as TR
from repro_torch.distributed import profiles, sharding
from repro_torch.launch import dryrun as D
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import make_dev_mesh, make_production_mesh
from repro_torch.models.api import get_model

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
ARCHS = list(TR.ALL_ARCHS)
MESHES = {"16x16": make_production_mesh(), "2x16x16":
          make_production_mesh(multi_pod=True)}
FLOP_BAND = (1.00, 1.05)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------- helpers

_ABSTRACT = {}


def _memo(fn):
    """The reference's abstract trees are the same for every mesh and
    shape: trace each (config, dtype) once."""
    def wrapped(cfg, dtype):
        key = (fn.__name__, cfg, dtype)
        if key not in _ABSTRACT:
            _ABSTRACT[key] = fn(cfg, dtype)
        return _ABSTRACT[key]
    return wrapped


@pytest.fixture
def ref_specs(monkeypatch):
    """The reference's ``build_cell`` with its shardings as bare specs (its
    ``NamedSharding`` replaced), so it runs on any object with ``.shape``."""
    monkeypatch.setattr(JS, "NamedSharding", lambda mesh, spec: spec)
    monkeypatch.setattr(JS, "abstract_params", _memo(JS.abstract_params))
    monkeypatch.setattr(JS, "abstract_medusa", _memo(JS.abstract_medusa))
    return JS


def _dt(x) -> str:
    return str(x).replace("torch.", "")


def _port_leaves(args, specs, path=()):
    """{path: (shape, dtype, spec)} over the port's argument trees."""
    if isinstance(args, torch.Tensor):
        return {path: (tuple(args.shape), _dt(args.dtype), specs)}
    if isinstance(args, dict):
        items = [(k, args[k], specs[k]) for k in args]
    elif hasattr(args, "_fields"):
        items = [(f, getattr(args, f), getattr(specs, f))
                 for f in args._fields]
    else:
        items = [(i, a, s) for i, (a, s) in enumerate(zip(args, specs))]
    out = {}
    for k, a, s in items:
        out.update(_port_leaves(a, s, path + (k,)))
    return out


def _key(k):
    for attr in ("key", "name", "idx"):
        if hasattr(k, attr):
            return getattr(k, attr)
    raise TypeError(k)


def _ref_leaves(args, shardings):
    flat, _ = jax.tree_util.tree_flatten_with_path(args)
    sh = jax.tree_util.tree_flatten_with_path(
        shardings, is_leaf=lambda x: isinstance(x, JP))[0]
    specs = {tuple(_key(k) for k in p): tuple(s) for p, s in sh}
    return {tuple(_key(k) for k in p): (tuple(a.shape), _dt(a.dtype),
                                        specs[tuple(_key(k) for k in p)])
            for p, a in flat}


def _shapes(reduced):
    if not reduced:
        return list(TB.SHAPES.values())
    return [dataclasses.replace(s, seq_len=64,
                                global_batch=1 if s.global_batch == 1 else 8)
            for s in TB.SHAPES.values()]


# ------------------------------------------------------- shapes and rules

def test_shapes_and_cells_equal_reference():
    assert [dataclasses.asdict(s) for s in TB.SHAPES.values()] == \
        [dataclasses.asdict(s) for s in JB.SHAPES.values()]
    assert [f.name for f in dataclasses.fields(TB.ShapeConfig)] == \
        [f.name for f in dataclasses.fields(JB.ShapeConfig)]
    assert TR.ASSIGNED_ARCHS == JR.ASSIGNED_ARCHS
    for arch in ARCHS:
        for name in TB.SHAPES:
            assert TB.shape_applicable(TR.get_config(arch),
                                       TR.get_shape(name)) == \
                JB.shape_applicable(JR.get_config(arch), JR.get_shape(name))
    cells = list(TR.iter_cells(include_skipped=True))
    assert cells == list(JR.iter_cells(include_skipped=True))
    assert len(cells) == 40
    skipped = [c for c in cells if not c[2]]
    assert len(skipped) == 8 and all(c[1] == "long_500k" for c in skipped)
    assert list(TR.iter_cells()) == list(JR.iter_cells())


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_make_rules_equal_reference(kind):
    for mp in (False, True):
        assert profiles.batch_axes(mp) == JProfiles.batch_axes(mp)
        for fsdp in (False, True):
            kw = dict(multi_pod=mp, fsdp=fsdp)
            assert profiles.make_rules(kind, **kw) == \
                JProfiles.make_rules(kind, **kw)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_medusa_axes_equal_reference(arch, ref_specs):
    cfg = JR.get_config(arch)
    _, axes = ref_specs.abstract_params(cfg, "bfloat16")
    assert sharding.param_axes(TR.get_config(arch)) == axes
    _, maxes = ref_specs.abstract_medusa(cfg, "bfloat16")
    assert sharding.medusa_axes() == maxes
    # the medusa axes of init_medusa itself (the reference's helper above
    # draws K = 4 heads; any K has the same axes)
    t = jax.eval_shape(lambda k: JM.init_medusa(k, cfg, 2),
                       jax.random.PRNGKey(0))
    assert split_params(t)[1] == sharding.medusa_axes()


# ------------------------------------------------------------------ cells

@pytest.mark.parametrize("width", ["full", "reduced"])
@pytest.mark.parametrize("arch", ARCHS)
def test_build_cell_equals_reference(arch, width, ref_specs):
    """Every argument leaf's path, shape, dtype and spec; donations and
    meta; all shapes on both production meshes (full width) or on a 2 x 2
    mesh (reduced config, reduced shapes)."""
    reduced = width == "reduced"
    meshes = ([make_dev_mesh(2, 2)] if reduced else list(MESHES.values()))
    tcfg, jcfg = (TR.get_config(arch, reduced=reduced),
                  JR.get_config(arch, reduced=reduced))
    for shape in _shapes(reduced):
        jshape = JB.ShapeConfig(**dataclasses.asdict(shape))
        for mesh in meshes:
            mp = "pod" in mesh.shape
            mine = S.build_cell(tcfg, shape, mesh, mp)
            ref = ref_specs.build_cell(jcfg, jshape, mesh, mp)
            got = _port_leaves(mine.args, mine.in_shardings)
            want = _ref_leaves(ref.args, ref.in_shardings)
            assert got.keys() == want.keys(), (shape.name, mesh)
            for path in want:
                assert got[path] == want[path], (shape.name, mesh.shape, path)
            assert mine.donate == ref.donate
            assert mine.meta == ref.meta


def _layout(cfg, layout):
    kw = {}
    if "int8" in layout:
        kw["cache_dtype"] = "int8"
    if "paged" in layout:
        kw.update(cache_layout="paged", page_size=16)
    return dataclasses.replace(cfg, **kw)


CACHE_CASES = ([("qwen1.5-0.5b", lay) for lay in
                ("dense", "int8", "paged", "int8+paged")]
               + [("mamba2-2.7b", "dense"), ("jamba-1.5-large-398b", "dense"),
                  ("jamba-1.5-large-398b", "int8+paged"),
                  ("whisper-tiny", "dense"), ("whisper-tiny", "int8+paged")])


@pytest.mark.parametrize("arch,layout", CACHE_CASES)
def test_cache_pspecs_equal_reference(arch, layout):
    tcfg = _layout(TR.get_config(arch), layout)
    jcfg = _layout(JR.get_config(arch), layout)
    for name in ("decode_32k", "long_500k"):
        shape = TB.SHAPES[name]
        jcache = jax_get_model(jcfg).init_cache(
            jcfg, shape.global_batch, shape.seq_len, abstract=True)
        with S.fake_mode():
            tcache = get_model(tcfg).init_cache(
                tcfg, shape.global_batch, shape.seq_len, device="cpu")
        shapes = jax.tree.map(lambda a: tuple(a.shape), jcache)
        assert jax.tree.map(lambda t: tuple(t.shape), tcache) == shapes
        for mp, mesh in zip((False, True), MESHES.values()):
            want = jax.tree.map(
                tuple, JProfiles.cache_pspecs(jcache, jcfg,
                                              JB.SHAPES[name], mesh, mp),
                is_leaf=lambda x: isinstance(x, JP))
            assert profiles.cache_pspecs(tcache, tcfg, shape, mesh,
                                         mp) == want, (name, mp)


# ------------------------------------------------------------------ bytes

_SUB = r"""
import os, sys, json, dataclasses
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, numpy as np
from repro.configs.base import SHAPES
from repro.configs.registry import get_config, ALL_ARCHS
from repro.distributed.sharding import axis_rules
from repro.distributed import profiles
from repro.launch.mesh import mesh_axis_types_kwargs
from repro.launch.specs import build_cell

mesh = jax.make_mesh((2, 4), ("data", "model"), **mesh_axis_types_kwargs(2))
out = {}
for arch in ALL_ARCHS:
    cfg = get_config(arch, reduced=True)
    for s in SHAPES.values():
        shape = dataclasses.replace(s, seq_len=64, global_batch=1
                                    if s.global_batch == 1 else 8)
        cell = build_cell(cfg, shape, mesh, False)
        args = jax.tree.leaves(cell.args)
        shs = jax.tree.leaves(cell.in_shardings)
        out[arch + "/" + s.name] = int(sum(
            int(np.prod(sh.shard_shape(a.shape))) * np.dtype(a.dtype).itemsize
            for a, sh in zip(args, shs)))
cfg = get_config("qwen1.5-0.5b", reduced=True)
shape = dataclasses.replace(SHAPES["decode_32k"], seq_len=512, global_batch=8)
rules = profiles.make_rules("decode", multi_pod=False)
# keep_unused: jit drops the arguments a program does not read (the
# greedy step reads neither the key nor mprob); the planner counts them all
with mesh, axis_rules(mesh, rules):
    cell = build_cell(cfg, shape, mesh, False)
    compiled = jax.jit(cell.fn, in_shardings=cell.in_shardings,
                       donate_argnums=cell.donate,
                       keep_unused=True).lower(*cell.args).compile()
out["compiled"] = int(compiled.memory_analysis().argument_size_in_bytes)
print("RESULT " + json.dumps(out))
"""


def test_argument_bytes_equal_reference_on_2x4():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.Popen([sys.executable, "-c", _SUB], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    mesh = make_dev_mesh(model=4, data=2)
    mine = {}
    for arch in ARCHS:
        cfg = TR.get_config(arch, reduced=True)
        for s in _shapes(True):
            mine[arch + "/" + s.name] = D.argument_bytes(
                S.build_cell(cfg, s, mesh, False), mesh)
    shape = dataclasses.replace(TB.SHAPES["decode_32k"], seq_len=512,
                                global_batch=8)
    compiled = D.argument_bytes(
        S.build_cell(TR.get_config("qwen1.5-0.5b", reduced=True), shape,
                     mesh, False), mesh)
    out, err = proc.communicate(timeout=300)
    line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
    assert line, err[-2000:]
    ref = json.loads(line[0][len("RESULT "):])
    assert ref.pop("compiled") == compiled
    assert mine == ref


# ---------------------------------------------------------------- tracker

@pytest.mark.parametrize("fake", [True, False])
def test_tracker_counts_by_hand(fake):
    """x [256] f32 (1 KiB), an argument: a = x * 2 (new, 1 KiB), b = a + 1
    (new, 1 KiB: peak 2 KiB), del a, a view of b and an in-place add on it
    (no storage), s = b.sum() (4 B).  Peak 2048 bytes; accessed bytes:
    mul 1024 + 1024, add 1024 + 1024, add_ 1024 + 1024 (+ its scalar
    operand, none: a Python number), sum 1024 + 4."""
    mode = S.fake_mode() if fake else None
    if mode is not None:
        mode.__enter__()
    try:
        x = torch.zeros(256)
        tr = D.StorageTracker()
        with tr:
            a = x * 2
            b = a + 1
            del a
            v = b.view(16, 16)
            v.add_(1)
            s = b.sum()
        assert tr.peak == 2048
        assert tr.current == 1024 + 4          # b and s are alive
        assert tr.accessed == 2 * 1024 * 3 + 1024 + 4
        del b, v, s
        assert tr.current == 0
    finally:
        if mode is not None:
            mode.__exit__(None, None, None)


# ---------------------------------------------------------------- the CLI

def test_cli_plans_openpangu_decode_at_full_width(tmp_path, ref_specs):
    out = tmp_path / "plan.jsonl"
    assert D.main(["--arch", "openpangu-7b", "--shape", "decode_32k",
                   "--out", str(out)]) == 0
    rec = json.loads(out.read_text().splitlines()[0])
    assert rec["arch"] == "openpangu-7b" and rec["kind"] == "decode"
    assert rec["devices"] == 256 and rec["path"] == "plain"
    # 8 kv heads do not shard 16 ways: TPSpecEngine refuses, the global
    # program is traced and says so
    assert rec["program"] == "global" and rec["per_device"] is False
    assert rec["collectives"] is None
    assert rec["meta"] == {"kind": "decode", "tree_T": 64,
                           "spec_mode": "tree", "optimized": False}
    # the argument bytes are the reference's placement's
    mesh = MESHES["16x16"]
    jcfg = JR.get_config("openpangu-7b")
    ref = ref_specs.build_cell(jcfg, JB.SHAPES["decode_32k"], mesh, False)
    want = 0
    for shape, dt, spec in _ref_leaves(ref.args, ref.in_shardings).values():
        n = math.prod(shape) * np.dtype(dt).itemsize
        for ax in spec:
            if ax is not None:
                n //= math.prod(mesh.shape[a] for a in
                                (ax if isinstance(ax, tuple) else (ax,)))
        want += n
    assert rec["mem"]["argument_bytes"] == want
    assert rec["mem"]["alias_bytes"] < rec["mem"]["argument_bytes"]
    assert rec["mem"]["peak_bytes"] == (rec["mem"]["program_argument_bytes"]
                                        + rec["mem"]["temp_bytes"])
    ratio = rec["flops_per_device"] / analytic_flops(
        jcfg, JB.SHAPES["decode_32k"], 64, 1)
    assert FLOP_BAND[0] <= ratio <= FLOP_BAND[1], ratio


def test_tp_cell_is_planned_per_device():
    cfg = TR.get_config("qwen1.5-0.5b")
    rec = D.plan(cfg, TB.SHAPES["decode_32k"], MESHES["16x16"], False)
    assert rec["program"] == "tp" and rec["per_device"] is True
    L = cfg.num_layers
    assert rec["collectives"]["all-reduce"]["count"] == 2 * L + 1
    assert rec["collectives"]["all-gather"]["count"] == 1
    # each layer's two sums carry [B / 16, T, d] in bf16
    B, T, d = 128 // 16, 64, cfg.d_model
    layer_bytes = 2 * L * B * T * d * 2
    assert rec["collectives"]["all-reduce"]["bytes"] > layer_bytes
    assert rec["meta"]["program"] == "tp" and rec["meta"]["tp"] == 16
