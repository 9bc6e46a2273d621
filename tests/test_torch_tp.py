"""The port's tensor and data parallelism against the JAX reference on the
CPU: ranks are processes joined by gloo (``collectives.spawn``), one
torch thread each.

* Refusals: ``tp._validate`` refuses what the reference's refuses (a
  non-dense family, tied embeddings, verify fusion, the draft proposer,
  an indivisible dimension, a config that already carries ``tp_axis``),
  and ``TPSpecEngine`` refuses ``graphs=True``.
* Placement: ``param_axes`` equals the axes tree the reference's
  ``split_params`` gives (by ``jax.eval_shape``) on every dense arch;
  ``spec_for`` equals the reference's on a table with both guards;
  ``tp_cache_pspecs`` makes the reference's decision on every leaf of the
  dense, paged, int8 and int8 + paged caches, the hybrid's SSM state and
  the encoder-decoder's ``cross``; a rank's parameter slices, specs and
  cache are the global ones cut on their sharded axis.
* ``tp_verify_stats`` on 2 and 4 ranks over adversarial logits (equal
  maxima on two ranks, where the first must win; a tie across a slice
  boundary; candidates on the last and first columns of adjacent slices;
  per-row tmax 0.7, 1, 1e-6, 2) equals the reference's oracle
  (``repro.kernels.ref.verify_stats_ref``) on the full logits: the argmax
  exactly, the rest within 3e-5.
* The identity matrix: ``TPSpecEngine.generate`` at tp 2 over the reduced
  config of the reference's own matrix (qwen1.5-0.5b), with the
  reference's weights, on {medusa, ngram} x {dense, paged, int8,
  int8 + paged} x {greedy, sampled at temperature 0}, and at tp 4 on
  reduced openPangu-7B with 8 / 4 heads: tokens, counts and steps equal
  the JAX single-device ``SpecEngine.generate``'s, and every rank's.
* Collectives: ``compressed_psum`` on 4 ranks equals the reference's on a
  forced 4-device mesh bit for bit (a leaf of exact halves tests the
  round-half-to-even, a zero leaf the scale's floor, a bf16 leaf the
  dtype); ``ag_matmul`` equals ``x @ w`` within 2e-4; a 2 x 2 grid's
  groups sum over the right ranks.
* Data parallelism: ``lm_train_step`` and ``medusa_train_step`` on 2
  ranks with ``dp_axis``, plain and int8-compressed, equal the
  reference's steps under ``shard_map_compat`` on a forced 2-device mesh:
  losses and updated leaves within 3e-5 of each leaf's largest magnitude.
* The launcher: ``--tp 2 --tp-backend gloo`` answers as ``--static``
  does; nccl without a card per rank, and flags TP does not take, raise.
* One device issues no collective.

The ranks and the reference's mesh run in processes of their own,
started before the reference's single-device runs and joined after them.
"""
import dataclasses
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

import test_torch_tp_ranks as R
from repro.configs.base import SamplingParams as JSamplingParams
from repro.configs.registry import get_config as jax_get_config
from repro.core import medusa as JM
from repro.core.engine import build_engine as jax_build_engine
from repro.distributed import profiles as JProfiles
from repro.distributed.sharding import spec_for as jax_spec_for
from repro.distributed.sharding import split_params
from repro.kernels.ref import verify_stats_ref
from repro.models.api import get_model as jax_get_model
from repro.models.api import init_cache as jax_init_cache
from repro.training import data as JD
from repro_torch.configs.registry import get_config
from repro_torch.core.engine import build_engine
from repro_torch.distributed import collectives as C
from repro_torch.distributed import profiles, sharding, tp as TP
from repro_torch.launch import serve
from repro_torch.models import transformer as T
from repro_torch.models.api import init_cache

TOL = 3e-5
LAYOUTS = ("dense", "paged", "int8", "int8+paged")
MATRIX = [(p, lay, acc) for p in ("medusa", "ngram") for lay in LAYOUTS
          for acc in ("greedy", "sample")]
B, S_P, NEW, MAX_LEN = 2, 32, 12, 128
TMAX_ROWS = [0.7, 1.0, 1e-6, 2.0]
METER_CASE = {"batch": 2, "prompt": 16, "max_len": 128}
ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_weights(cfg):
    params, _ = split_params(jax_get_model(cfg).init_params(
        jax.random.PRNGKey(0), cfg))
    mp, _ = split_params(JM.init_medusa(jax.random.PRNGKey(1), cfg, 4))
    return _np(params), _np(mp)


def _prompts(cfg):
    rng = np.random.default_rng(0)
    toks = rng.integers(2, cfg.vocab_size, (B, S_P)).astype(np.int32)
    return toks, np.array([S_P, S_P - 7], np.int32)


def _tp4_config(get):
    return dataclasses.replace(get("openpangu-7b", reduced=True),
                               num_heads=8, num_kv_heads=4, head_dim=16)


def _case(tcfg, params, mp, proposer, accept):
    toks, plens = _prompts(tcfg)
    return {"cfg": tcfg, "params": params,
            "mp": mp if proposer == "medusa" else None,
            "proposer": proposer, "accept": accept, "tokens": toks,
            "lengths": plens, "max_new": NEW, "max_len": MAX_LEN}


def _stats_cases(tp, seed):
    """Adversarial logits [4, 5, 32] for ``tp`` ranks, their candidates
    and per-row tmax."""
    Bs, T, V = 4, 5, 32
    vl = V // tp
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((Bs, T, V)).astype(np.float32)
    r1, r2 = (0, 1) if tp == 2 else (1, 2)
    for b in range(Bs):
        # equal maxima on two ranks: the first rank's column must win
        logits[b, b % T, [r1 * vl + 3, r2 * vl + 5]] = 9.0
    # a tie across a slice boundary: the last column of one rank and the
    # first of the next
    logits[0, 1, [vl - 1, vl]] = 8.5
    edge = vl if tp == 2 else 2 * vl
    logits[3, 4, [edge - 1, edge]] = 7.25
    edges = [vl - 1, vl, 2 * vl - 1, min(2 * vl, V - 1), 0, V - 1]
    cand = np.array([[edges[(b + t) % len(edges)] for t in range(T)]
                     for b in range(Bs)], np.int32)
    cand[1, 0] = r2 * vl + 5              # the losing tied column
    return logits, cand, np.array(TMAX_ROWS, np.float32)


def _oracle(logits, cand, tmax):
    Bs, T, V = logits.shape
    hidden = np.eye(Bs * T, dtype=np.float32).reshape(Bs, T, Bs * T)
    return tuple(np.asarray(x) for x in verify_stats_ref(
        jnp.asarray(hidden), jnp.asarray(logits.reshape(Bs * T, V)),
        jnp.asarray(cand), jnp.asarray(tmax)))


# ------------------------------------------- the reference, in subprocesses

_REF_CODE = r"""
import os, pickle, sys
os.environ["JAX_PLATFORMS"] = "cpu"
import jax, jax.numpy as jnp, numpy as np
from repro.configs.base import SamplingParams
from repro.core.engine import build_engine
from repro.models.api import init_cache

out = {}
for tag, case in pickle.load(open(sys.argv[1], "rb")).items():
    cfg = case["cfg"]
    sampling = (SamplingParams(temperature=0.0)
                if case["accept"] == "sample" else None)
    eng = build_engine(cfg, case["proposer"], accept=case["accept"],
                       sampling=sampling)
    pp = (jax.tree.map(jnp.asarray, case["mp"])
          if case["mp"] is not None else None)
    toks = jnp.asarray(case["tokens"])
    o, n, st = eng.generate(
        jax.tree.map(jnp.asarray, case["params"]), pp, toks,
        jnp.asarray(case["lengths"]),
        init_cache(cfg, toks.shape[0], case["max_len"]), case["max_new"],
        key=jax.random.PRNGKey(7))
    out[tag] = (np.asarray(o), np.asarray(n), int(st.steps))
pickle.dump(out, open(sys.argv[2], "wb"))
print("REF_OK")
"""

_MESH_CODE = r"""
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from repro.distributed.collectives import shard_map_compat
from repro.training import optimizer as JO
from repro.training import steps as JS

inp = pickle.load(open(sys.argv[1], "rb"))
out = {}
mesh4 = Mesh(np.asarray(jax.devices()[:4]), ("data",))
stacked = {k: jnp.asarray(np.stack([t[k] for t in inp["cpsum"]]))
           for k in inp["cpsum"][0]}
fn = shard_map_compat(
    lambda g: jax.tree.map(lambda x: x[None], JO.compressed_psum(
        jax.tree.map(lambda x: x[0], g), "data")),
    mesh=mesh4, in_specs=P("data"), out_specs=P("data"), check=False)
res = jax.jit(fn)(stacked)
out["cpsum"] = [{k: np.asarray(v[r].astype(jnp.float32))
                 for k, v in res.items()} for r in range(4)]
mesh2 = Mesh(np.asarray(jax.devices()[:2]), ("data",))
cfg = inp["cfg"]
params = jax.tree.map(jnp.asarray, inp["params"])
mp = jax.tree.map(jnp.asarray, inp["mp"])
toks = jnp.asarray(inp["tokens"])
out["dp"] = {}
for kind in ("lm", "head"):
    for comp in (False, True):
        if kind == "lm":
            def step(p, t, comp=comp):
                p2, o2, m = JS.lm_train_step(
                    p, JO.adamw_init(p), cfg, t[:, :-1], t[:, 1:],
                    dp_axis="data", compress_grads=comp)
                return p2, o2.mu, m["loss"][None]
            args = (params, toks)
        else:
            def step(h, t, comp=comp):
                h2, o2, m = JS.medusa_train_step(
                    h, JO.adamw_init(h), params, cfg, t, inp["K"],
                    pad_id=inp["pad_id"], dp_axis="data",
                    compress_grads=comp)
                return h2, o2.mu, m["loss"][None]
            args = (mp, toks)
        fn = shard_map_compat(step, mesh=mesh2, in_specs=(P(), P("data")),
                              out_specs=(P(), P(), P("data")), check=False)
        p2, mu, loss = jax.jit(fn)(*args)
        out["dp"][f"{kind}/{'int8' if comp else 'sum'}"] = {
            "params": jax.tree.map(np.asarray, p2),
            "mu": jax.tree.map(np.asarray, mu), "loss": np.asarray(loss)}
pickle.dump(out, open(sys.argv[2], "wb"))
print("MESH_OK")
"""


def _cpsum_trees():
    rng = np.random.default_rng(11)
    trees = []
    import ml_dtypes
    for r in range(4):
        half = np.array([0.5, 1.5, 2.5, -0.5, -2.5, 3.5, -126.5, 0.0],
                        np.float32) * (r + 1) / 4
        if r == 0:
            half[-1] = 127.0            # max |g| 127: the scale is exactly 1
        trees.append({
            "a": rng.standard_normal((6, 33)).astype(np.float32),
            "b": (rng.standard_normal(40) * 3).astype(ml_dtypes.bfloat16),
            "z": np.zeros((5,), np.float32),
            "h": half})
    return trees


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every spawned run and every reference run, once for the whole test
    session: under pytest-xdist the module's tests spread over the
    workers, so the first worker to get here computes the runs and
    pickles them into the session's shared temporary directory, under a
    file lock, and the others load them."""
    from filelock import FileLock
    shared = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        shared = shared.parent
    path = shared / "torch_tp_world.pkl"
    with FileLock(str(path) + ".lock"):
        if path.exists():
            with open(path, "rb") as f:
                return pickle.load(f)
        runs = _world(tmp_path_factory.mktemp("tp"))
        with open(path, "wb") as f:
            pickle.dump(runs, f)
        return runs


def _world(tmp):
    jobs2, jobs4 = [], []
    # verify statistics
    stats = {tp: [_stats_cases(tp, s) for s in range(3)] for tp in (2, 4)}
    jobs2.append(("stats", stats[2]))
    jobs4.append(("stats", stats[4]))
    # the identity matrix: tp 2 on the reference matrix's config
    qwen_j = jax_get_config("qwen1.5-0.5b", reduced=True)
    qwen_t = get_config("qwen1.5-0.5b", reduced=True)
    params, mp = _jax_weights(qwen_j)
    jobs2.append(("generate", {
        f"{p}/{lay}/{acc}": _case(R.with_layout(qwen_t, lay), params, mp, p,
                                  acc) for p, lay, acc in MATRIX}))
    # tp 4 on reduced openPangu-7B with 8 / 4 heads
    pangu_j, pangu_t = _tp4_config(jax_get_config), _tp4_config(get_config)
    params4, mp4 = _jax_weights(pangu_j)
    tp4_case = ("medusa", "int8+paged", "sample")
    jobs4.append(("generate", {"/".join(tp4_case): _case(
        R.with_layout(pangu_t, "int8+paged"), params4, mp4, "medusa",
        "sample")}))
    # one metered spec step a grid, for the planner's collectives
    jobs2.append(("meter", dict(METER_CASE, cfg=qwen_t, params=params,
                                mp=mp)))
    jobs4.append(("meter", dict(METER_CASE, cfg=pangu_t, params=params4,
                                mp=mp4)))
    # collectives
    trees = _cpsum_trees()
    jobs4.append(("cpsum", trees))
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 64)).astype(np.float32)
    w = rng.standard_normal((64, 24)).astype(np.float32)
    jobs4.append(("ag_matmul", (x, w)))
    jobs4.append(("grid", None))
    # data parallelism on one-layer reduced openPangu-7B
    dcfg_j = dataclasses.replace(jax_get_config("openpangu-7b", reduced=True),
                                 num_layers=1)
    dcfg_t = dataclasses.replace(get_config("openpangu-7b", reduced=True),
                                 num_layers=1)
    dparams, _ = split_params(jax_get_model(dcfg_j).init_params(
        jax.random.PRNGKey(1), dcfg_j))
    dmp, _ = split_params(JM.init_medusa(jax.random.PRNGKey(7), dcfg_j, 2,
                                         base_lm_head=dparams["lm_head"]))
    corpus = JD.synthetic_chat(JD.SyntheticChatConfig(
        vocab_size=dcfg_j.vocab_size, seq_len=33, n_samples=8, noise=0.05))
    pad = JD.special_id(dcfg_j.vocab_size, JD.PAD)
    dp = {}
    for kind in ("lm", "head"):
        for comp in (False, True):
            dp[f"{kind}/{'int8' if comp else 'sum'}"] = {
                "cfg": dcfg_t, "kind": kind, "compress": comp,
                "params": _np(dparams), "mp": _np(dmp), "tokens": corpus,
                "K": 2, "pad_id": pad}
    jobs2.append(("dp", dp))

    # the reference's single-device runs of the identity matrix, in three
    # processes beside the ranks and the reference's mesh
    jcases = {f"{p}/{lay}/{acc}": dict(
        _case(R.with_layout(qwen_j, lay), params, mp, p, acc))
        for p, lay, acc in MATRIX}
    jcases["/".join(tp4_case)] = _case(R.with_layout(pangu_j, "int8+paged"),
                                       params4, mp4, "medusa", "sample")
    tags = sorted(jcases)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    procs, outs = [], []

    def start(code, payload, name):
        inp, outp = tmp / f"{name}_in.pkl", tmp / f"{name}_out.pkl"
        with open(inp, "wb") as f:
            pickle.dump(payload, f)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code, str(inp), str(outp)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        outs.append(outp)

    ranks2 = C.spawn(R.run, 2, backend="gloo", device="cpu", threads=1,
                     args=(jobs2,), join=False)
    ranks4 = C.spawn(R.run, 4, backend="gloo", device="cpu", threads=1,
                     args=(jobs4,), join=False)
    try:
        start(_MESH_CODE, {"cpsum": trees, "cfg": dcfg_j,
                           "params": _np(dparams), "mp": _np(dmp),
                           "tokens": corpus, "K": 2, "pad_id": pad}, "mesh")
        for i in range(3):
            start(_REF_CODE, {t: jcases[t] for t in tags[i::3]}, f"ref{i}")
        oracle = {tp: [_oracle(*c) for c in cases]
                  for tp, cases in stats.items()}
    finally:
        # every process is waited for (and a hung one ended) before any
        # failure propagates
        joined = []
        for ranks in (ranks2, ranks4):
            try:
                joined.append(ranks.join(timeout=400))
            except Exception as e:
                joined.append(e)
        done = [p.communicate(timeout=400) for p in procs]
    for out in joined:
        if isinstance(out, Exception):
            raise out
    out2, out4 = joined
    for (stdout, stderr), word in zip(done, ["MESH_OK"] + ["REF_OK"] * 3):
        assert word in stdout, stderr[-3000:]
    loaded = []
    for outp in outs:
        with open(outp, "rb") as f:
            loaded.append(pickle.load(f))
    jmesh, ref = loaded[0], {k: v for d in loaded[1:] for k, v in d.items()}
    return {"out": {2: out2, 4: out4}, "ref": ref, "oracle": oracle,
            "dp_start": {"lm": _np(dparams), "head": _np(dmp)},
            "jmesh": jmesh, "trees": trees, "x": x, "w": w,
            "params": params, "qwen": (qwen_j, qwen_t)}


# ------------------------------------------------------------- refusals

def _cfg(**kw):
    return dataclasses.replace(get_config("qwen1.5-0.5b", reduced=True), **kw)


@pytest.mark.parametrize("bad, msg", [
    (dict(family="moe", num_experts=4), "dense family"),
    (dict(tie_embeddings=True), "lm_head"),
    (dict(verify_fusion=True), "verify_fusion"),
    (dict(num_heads=3, num_kv_heads=1, head_dim=16), "divide"),
    (dict(tp_axis="model"), "global config"),
])
def test_validate_refuses_what_the_reference_refuses(bad, msg):
    from repro.distributed.tp import _validate as jax_validate
    with pytest.raises(ValueError, match=msg):
        jax_validate(dataclasses.replace(
            jax_get_config("qwen1.5-0.5b", reduced=True), **bad), "medusa", 2)
    with pytest.raises(ValueError, match=msg):
        TP._validate(_cfg(**bad), "medusa", 2)


def test_validate_refuses_the_draft_proposer():
    with pytest.raises(ValueError, match="proposer"):
        TP._validate(_cfg(), "draft", 2)
    TP._validate(_cfg(), "ngram", 2)


def test_tp_engine_refuses_graphs_and_runs_no_unregistered_axis():
    mesh = TP.TPMesh({"data": 1, "model": 2}, 0, 0, "gloo")
    with pytest.raises(ValueError, match="eagerly"):
        TP.TPSpecEngine(_cfg(), mesh, graphs=True, device="cpu")
    with pytest.raises(ValueError, match="no process group"):
        TP.TPSpecEngine(_cfg(), mesh, device="cpu")


def test_non_dense_tp_config_is_refused_by_the_model():
    from repro_torch.models.api import get_model
    get_model(_cfg(tp_axis="model"))
    for arch in ("granite-moe-1b-a400m", "mamba2-2.7b", "whisper-tiny"):
        with pytest.raises(ValueError, match="dense family"):
            get_model(dataclasses.replace(get_config(arch, reduced=True),
                                          tp_axis="model"))


def test_single_device_issues_no_collective():
    cfg = _cfg()
    eng = build_engine(cfg, "ngram", device="cpu")
    assert not eng._tp_stats
    params = T.init_params(torch.Generator().manual_seed(0), cfg)
    toks = torch.randint(2, cfg.vocab_size, (1, 8), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(1))
    with C.metered() as meter:
        eng.generate(params, None, toks, torch.tensor([8], dtype=torch.int32),
                     eng.init_cache(1, 64), 6)
    assert meter.total() == (0, 0)
    with pytest.raises(ValueError, match="no process group"):
        C.psum(torch.ones(2), "model")


# ------------------------------------------------------------- placement

DENSE_ARCHS = ["openpangu-7b", "qwen1.5-0.5b", "granite-8b", "qwen1.5-4b",
               "gemma-2b"]


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_param_axes_match_reference(arch):
    cfg = jax_get_config(arch, reduced=True)
    abstract = jax.eval_shape(
        lambda: jax_get_model(cfg).init_params(jax.random.PRNGKey(0), cfg))
    _, axes = split_params(abstract)
    assert sharding.param_axes(get_config(arch, reduced=True)) == \
        jax.tree.map(tuple, axes, is_leaf=lambda x: isinstance(x, tuple))
    # every family has its axes now (the planner's); the MoE's experts
    moe = sharding.param_axes(get_config("granite-moe-1b-a400m"))
    assert moe["units"]["pos0"]["ffn"]["wi"] == ("layers", "experts",
                                                 "embed", "ff")


class FakeMesh:
    shape = {"data": 2, "model": 2}


SPEC_CASES = [
    (("embed", "heads", "head_dim"), (64, 4, 16)),
    (("layers", "embed", "kv_heads", "head_dim"), (4, 64, 2, 16)),
    (("layers", "embed", "kv_heads", "head_dim"), (4, 64, 3, 16)),  # divides
    (("embed", "vocab"), (64, 256)),
    (("vocab", "embed"), (256, 64)),
    (("batch", "seq", "vocab"), (4, 64, 256)),        # uniqueness: seq wins
    (("batch", "seq", "vocab"), (4, 63, 256)),        # seq drops, vocab takes
    (("heads", None, "ff"), (4, 8, 128)),             # heads wins, ff drops
    ((None, "norm"), (4, 64)),
    ((), ()),
]
SPEC_RULES = {"heads": "model", "kv_heads": "model", "ff": "model",
              "vocab": "model", "seq": "model", "batch": ("data",),
              "embed": None}


@pytest.mark.parametrize("axes, shape", SPEC_CASES)
def test_spec_for_matches_reference(axes, shape):
    want = tuple(jax_spec_for(axes, SPEC_RULES, shape=shape, mesh=FakeMesh()))
    assert sharding.spec_for(axes, SPEC_RULES, shape=shape,
                             mesh=FakeMesh()) == want
    assert sharding.spec_for(axes, SPEC_RULES) == tuple(
        jax_spec_for(axes, SPEC_RULES))


@pytest.mark.parametrize("arch, layout", [
    ("qwen1.5-0.5b", lay) for lay in LAYOUTS] + [
    ("jamba-1.5-large-398b", "int8+paged"), ("whisper-tiny", "dense")])
def test_tp_cache_pspecs_match_reference(arch, layout):
    jcfg = R.with_layout(jax_get_config(arch, reduced=True), layout)
    tcfg = R.with_layout(get_config(arch, reduced=True), layout)
    for mesh in (FakeMesh(), type("Wide", (), {"shape": {"model": 8}})()):
        want = JProfiles.tp_cache_pspecs(
            jax_get_model(jcfg).init_cache(jcfg, 2, 64, abstract=True),
            jcfg, mesh)
        got = profiles.tp_cache_pspecs(init_cache(tcfg, 2, 64, device="cpu"),
                                       tcfg, mesh)
        assert got == jax.tree.map(tuple, want,
                                   is_leaf=lambda x: isinstance(x, JP))


def test_rank_holds_the_global_slices(world):
    qwen_j, qwen_t = world["qwen"]
    tp = 2
    _, axes = split_params(jax.eval_shape(
        lambda: jax_get_model(qwen_j).init_params(jax.random.PRNGKey(0),
                                                  qwen_j)))
    rules = {"heads": "model", "kv_heads": "model", "ff": "model",
             "vocab": "model"}
    mesh = type("M", (), {"shape": {"data": 1, "model": tp}})()

    def spec(ax, arr):
        return tuple(jax_spec_for(tuple(ax), rules, shape=arr.shape,
                                  mesh=mesh))
    want = jax.tree.map(spec, axes, world["params"],
                        is_leaf=lambda x: isinstance(x, tuple))
    want["embed"] = ()
    for lay in LAYOUTS:
        run = world["out"][2][0]["generate"][f"medusa/{lay}/greedy"]
        assert run["pspecs"] == want
        # each sharded leaf is the global leaf cut tp ways on its axis
        for path, shp in jax.tree_util.tree_leaves_with_path(
                run["param_shapes"], is_leaf=lambda x: isinstance(x, tuple)):
            g = world["params"]
            s = want
            for k in path:
                g, s = g[k.key], s[k.key]
            exp = list(g.shape)
            for i, a in enumerate(s):
                if a is not None:
                    exp[i] //= tp
            assert shp == tuple(exp), path
        cfg = R.with_layout(qwen_t, lay)
        glob = init_cache(cfg, B, MAX_LEN, device="cpu")
        specs = profiles.tp_cache_pspecs(glob, cfg, mesh)
        for pos, entry in glob.items():
            for name, t in entry.items():
                exp = list(t.shape)
                for i, a in enumerate(specs[pos][name]):
                    if a is not None:
                        exp[i] //= tp
                assert run["cache_shapes"][pos][name] == tuple(exp)


# ------------------------------------------------------- verify statistics

@pytest.mark.parametrize("tp", [2, 4])
def test_tp_verify_stats_match_oracle(world, tp):
    for r, out in enumerate(world["out"][tp]):
        for got, want in zip(out["stats"], world["oracle"][tp]):
            np.testing.assert_array_equal(got[0], want[0], err_msg=f"rank {r}")
            for g, w in zip(got[1:], want[1:]):
                np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)
    # the constructed ties: the first rank's column wins
    logits, cand, _ = _stats_cases(tp, 0)
    vl = 32 // tp
    first = vl * (0 if tp == 2 else 1) + 3
    assert world["out"][tp][0]["stats"][0][0][1, 1] == first
    assert world["out"][tp][0]["stats"][0][0][0, 1] == vl - 1


# ------------------------------------------------------ the identity matrix

@pytest.mark.parametrize("tag", [f"{p}/{lay}/{acc}" for p, lay, acc in MATRIX]
                         + ["medusa/int8+paged/sample"])
def test_tp_generate_equals_jax_single_device(world, tag):
    tp = 4 if tag == "medusa/int8+paged/sample" else 2
    out_r, n_r, steps_r = world["ref"][tag]
    runs = [o["generate"][tag] for o in world["out"][tp]]
    for r, run in enumerate(runs):
        np.testing.assert_array_equal(run["n"], n_r, err_msg=f"{tag} {r}")
        for b in range(B):
            np.testing.assert_array_equal(run["out"][b, :n_r[b]],
                                          out_r[b, :n_r[b]],
                                          err_msg=f"{tag} rank {r} row {b}")
        assert run["steps"] == steps_r
        np.testing.assert_array_equal(run["out"], runs[0]["out"])
    assert n_r.min() == NEW


# ------------------------------------------------------------- collectives

def test_compressed_psum_equals_reference_bitwise(world):
    for r, out in enumerate(world["out"][4]):
        want = world["jmesh"]["cpsum"][r]
        assert set(out["cpsum"]) == set(want)
        for k in want:
            np.testing.assert_array_equal(out["cpsum"][k], want[k],
                                          err_msg=f"rank {r} leaf {k}")
    # round half to even at a scale of exactly 1: 0.5 -> 0, 1.5 -> 2, ...
    halves = world["trees"][0]["h"][:-1] * 4
    assert list(np.round(halves)) == [0.0, 2.0, 2.0, -0.0, -2.0, 4.0, -126.0]


def test_ag_matmul_matches_matmul(world):
    want = world["x"] @ world["w"]
    for out in world["out"][4]:
        np.testing.assert_allclose(out["ag_matmul"], want, rtol=2e-4,
                                   atol=2e-4)


def test_grid_groups_sum_over_their_axis(world):
    got = [o["grid"] for o in world["out"][4]]
    assert [g["coords"] for g in got] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert [g["model"] for g in got] == [1.0, 1.0, 5.0, 5.0]
    assert [g["data"] for g in got] == [2.0, 4.0, 2.0, 4.0]
    np.testing.assert_array_equal(got[3]["gathered"], [2.0, 3.0])


# ------------------------------------------------------ data parallelism

def _leaf_close(got, ref, tol=TOL):
    scale = max(float(np.max(np.abs(ref))), 1e-30)
    assert float(np.max(np.abs(got - ref))) <= tol * scale


def _tree_close(got, ref):
    for path, leaf in jax.tree_util.tree_leaves_with_path(ref):
        g = got
        for k in path:
            g = g[k.key]
        _leaf_close(g, leaf)


def _int8_update(world, tag):
    """The reference's compressed all-reduce (``compressed_psum`` over a
    vmapped axis), clip and AdamW, as its step runs them, applied to the
    gradients each port rank computed."""
    from repro.training import optimizer as JO
    kind = tag.split("/")[0]
    runs = [o["dp"][tag] for o in world["out"][2]]
    stacked = jax.tree.map(lambda *g: jnp.stack(g),
                           *(r["grads"] for r in runs))
    grads = _compressed_then_clip(stacked)
    start = jax.tree.map(jnp.asarray, world["dp_start"][kind])
    # the steps' own rates: lm_train_step's 3e-4 with decay 0.1, the
    # heads' 1e-3 without
    kw = dict(lr=3e-4, weight_decay=0.1) if kind == "lm" else dict(lr=1e-3)
    return jax.jit(lambda g, p: JO.adamw_update(g, JO.adamw_init(p), p,
                                                **kw))(grads, start)


@jax.jit
def _compressed_then_clip(stacked):
    from repro.training import optimizer as JO
    summed = jax.vmap(lambda g: JO.compressed_psum(g, "d"),
                      axis_name="d")(stacked)
    return JO.clip_by_global_norm(jax.tree.map(lambda g: g[0], summed),
                                  1.0)[0]


@pytest.mark.parametrize("tag", ["lm/sum", "lm/int8", "head/sum",
                                 "head/int8"])
def test_data_parallel_step_matches_reference(world, tag):
    """Each rank's loss against the reference's step on the 2-device mesh.
    The summed steps: the updated leaves and moments against that step's.
    The int8 steps: against the reference's compressed all-reduce, clip
    and AdamW over the port ranks' own gradients, because the two
    frameworks' float32 gradients differ by rounding (~4e-6 of a leaf's
    largest magnitude) and an element at a half-quantum tie then rounds
    to neighbouring int8 values, which AdamW's first step turns into a
    learning-rate-sized difference; the gradients themselves are held by
    the summed steps, the all-reduce bit for bit by
    ``test_compressed_psum_equals_reference_bitwise``."""
    ref = world["jmesh"]["dp"][tag]
    for r, out in enumerate(world["out"][2]):
        np.testing.assert_allclose(out["dp"][tag]["loss"], ref["loss"][r],
                                   rtol=TOL)
    if tag.endswith("int8"):
        p, o = _int8_update(world, tag)
        ref = {"params": _np(p), "mu": _np(o.mu)}
    for out in world["out"][2]:
        for key in ("params", "mu"):
            _tree_close(out["dp"][tag][key], ref[key])
    a, b = (o["dp"][tag]["params"] for o in world["out"][2])
    jax.tree.map(np.testing.assert_array_equal, a, b)


# ------------------------------------------------------------ the launcher

ARGV = ["--reduced", "--device", "cpu", "--requests", "4", "--max-new",
        "12", "--max-len", "192"]


def test_launcher_tp_answers_as_static():
    tp = serve.main(ARGV + ["--tp", "2", "--tp-backend", "gloo"])
    static = serve.main(ARGV + ["--static"])
    assert tp.backend == "gloo" and tp.mesh == (1, 2)
    assert [r["status"] for r in tp.results] == ["done"] * 4
    for a, b in zip(tp.results, static.results):
        np.testing.assert_array_equal(a["output"], b["output"])
    assert len(tp.ranks) == 2 and all(r["collectives"] > 0
                                      for r in tp.ranks)


@pytest.mark.parametrize("extra, msg", [
    (["--tp", "2"], "--tp-backend gloo"),
    (["--tp", "2", "--tp-backend", "nccl", "--device", "cpu"],
     "--tp-backend gloo"),
    (["--tp", "2", "--tp-backend", "gloo", "--families", "medusa,ngram"],
     "--families"),
    (["--tp", "2", "--tp-backend", "gloo", "--mesh-shape", "1x4"], "!= --tp"),
    (["--tp", "2", "--tp-backend", "gloo", "--verify-fusion"],
     "verify_fusion"),
    (["--tp", "2", "--tp-backend", "gloo", "--proposer", "draft"],
     "proposer"),
    (["--mesh-shape", "1x2"], "go with --tp"),
])
def test_launcher_refuses(extra, msg, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--reduced"] + extra
    with pytest.raises(SystemExit, match=msg):
        serve.main(argv)


# --------------------------------------------------- the planner's collectives

@pytest.mark.parametrize("tp", [2, 4])
def test_planned_tp_collectives_equal_metered(world, tp):
    """The dry-run planner's tp-``tp`` decode cell at the metered run's
    shapes (rank 0's program over planning axes) issues the collectives
    the ranks' gloo run metered, by kind, in count and result bytes, and
    plans the bytes of rank 0's step arguments (plus the cell's 8-byte
    key, which the engine's step does not take).  At reduced depth the
    step issues 2 all-reduces a layer, the verify statistics' sum and
    one all-gather."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_dev_mesh
    cfg = get_config("qwen1.5-0.5b", reduced=True) if tp == 2 \
        else _tp4_config(get_config)
    shape = ShapeConfig("metered", METER_CASE["max_len"],
                        METER_CASE["batch"], "decode")
    rec = D.plan(cfg, shape, make_dev_mesh(model=tp), False)
    assert rec["program"] == "tp" and rec["per_device"]
    for out in world["out"][tp]:
        got = out["meter"]
        want = {}
        for op, n in got["count"].items():
            e = want.setdefault(D.KINDS[op], {"count": 0, "bytes": 0,
                                              "bytes_body": 0})
            e["count"] += n
            e["bytes"] += got["bytes"][op]
        assert rec["collectives"] == want
        assert sum(got["count"].values()) == 2 * cfg.num_layers + 2
        assert rec["mem"]["program_argument_bytes"] == \
            got["argument_bytes"] + 8
