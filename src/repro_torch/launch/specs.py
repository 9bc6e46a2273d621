"""Per-cell dry-run specs (counterpart of ``repro.launch.specs``): abstract
inputs, the step function and the inputs' placements for every
(architecture x input shape x kind) cell.

No storage is allocated.  An abstract input is a fake tensor
(``torch._subclasses.fake_tensor.FakeTensorMode``): a shape, a dtype and
a device, and no data.  The trees are built by the port's own
``init_params`` / ``init_medusa`` / ``init_cache`` inside the cell's fake
mode, with a CPU generator (a generator on the meta device does not
exist).  A placement is a spec tuple (``distributed/sharding.py``).

``build_cell`` mirrors the reference's three branches, with its
arguments, donations and ``meta``; its ``fn`` is the global program, run
on the plain path (no kernel takes a fake tensor).  ``rank_cell`` is the
program one device runs where the port's own sharded program accepts the
cell (tensor-parallel decode and prefill, data-parallel training), at
that rank's shapes, over planning axes (``collectives.register_plan``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, NamedTuple, Optional

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core import medusa as M
from repro_torch.core.engine import SpecEngine
from repro_torch.core.tree import default_tree
from repro_torch.distributed import collectives as C
from repro_torch.distributed import profiles
from repro_torch.distributed import tp as TP
from repro_torch.distributed.sharding import (medusa_axes, param_axes,
                                              param_shardings, spec_for)
from repro_torch.launch.mesh import make_dev_mesh
from repro_torch.models.api import get_model
from repro_torch.models.frontends import frontend_spec
from repro_torch.models.transformer import unit_structure
from repro_torch.training import optimizer as O
from repro_torch.training import steps as ST

MEDUSA_K = 4
PLAN_DEVICE = "cpu"       # the fake tensors' device: the plain path's ops


class CellSpec(NamedTuple):
    fn: Any                    # the step function
    args: tuple                # trees of fake tensors
    in_shardings: tuple        # trees of spec tuples
    donate: tuple              # argnums to donate
    meta: dict


def fake_mode() -> FakeTensorMode:
    """A fresh fake mode for one cell.  Real tensors (an engine's tree
    buffers) may meet fake ones inside it."""
    return FakeTensorMode(allow_non_fake_inputs=True)


def _mode_of(tree):
    """The fake mode of the first fake tensor in ``tree``, or None."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for x in tree:
            m = _mode_of(x)
            if m is not None:
                return m
        return None
    return getattr(tree, "fake_mode", None)


@contextlib.contextmanager
def _within(mode: Optional[FakeTensorMode]):
    with (mode if mode is not None else fake_mode()) as m:
        yield m


def _gen():
    return torch.Generator(device=PLAN_DEVICE).manual_seed(0)


def abstract_params(cfg: ModelConfig, dtype: str, mode=None):
    """(fake params, logical axes) from the port's own ``init_params``."""
    with _within(mode):
        params = get_model(cfg).init_params(_gen(), cfg, dtype=dtype)
    return params, param_axes(cfg)


def abstract_medusa(cfg: ModelConfig, dtype: str, mode=None):
    """(fake Medusa heads, logical axes) from ``init_medusa``."""
    with _within(mode):
        mp = M.init_medusa(_gen(), cfg, MEDUSA_K, dtype=dtype)
    return mp, medusa_axes()


def _sds(shape, dtype):
    """An abstract input: a fake tensor (call inside the cell's mode)."""
    return torch.empty(tuple(shape), dtype=dtype, device=PLAN_DEVICE)


def _act(shape, axes, mesh, rules, dtype=torch.int32):
    return _sds(shape, dtype), spec_for(tuple(axes), rules, shape=shape,
                                        mesh=mesh)


def _frames(cfg: ModelConfig, B: int, mesh, rules, args, shardings):
    """Append the frontend's frames (bf16, batch-sharded) for a config
    with a frontend."""
    fe = frontend_spec(cfg, B, device=PLAN_DEVICE)
    if fe is not None:
        args.append(fe)
        shardings.append(spec_for(("batch", None, None), rules,
                                  shape=tuple(fe.shape), mesh=mesh))


def spec_tree(cfg: ModelConfig):
    return default_tree(cfg.spec_mode, K=MEDUSA_K)


def _engine(cfg: ModelConfig, optimized: bool) -> SpecEngine:
    """The cell's engine, built outside any fake mode (its tree buffers
    are small real tensors): greedy, plain path, eager."""
    return SpecEngine(cfg, spec_tree(cfg), deferred=optimized,
                      device=PLAN_DEVICE, graphs=False, use_kernel=False)


def build_cell(cfg: ModelConfig, shape: ShapeConfig, mesh,
               multi_pod: bool, *, rules_override: dict | None = None,
               optimized: bool = False) -> CellSpec:
    """The cell's global program, its abstract arguments (fake tensors of
    one fresh fake mode, which ``run_cell`` re-enters) and their specs
    under the kind's rules on ``mesh``."""
    kind = shape.kind
    fsdp = kind == "train"            # FSDP master weights for training
    rules = rules_override or profiles.make_rules(kind, multi_pod=multi_pod,
                                                  fsdp=fsdp)
    model = get_model(cfg)
    B = shape.global_batch
    mode = fake_mode()

    if kind == "train":
        # bf16 master + optimizer for very large models
        pdtype = "bfloat16" if _param_bytes_estimate(cfg) > 60e9 \
            else "float32"
        params, axes = abstract_params(cfg, pdtype, mode)
        with mode:
            opt = O.adamw_init(params)
            psh = param_shardings(axes, mesh, rules, params)
            osh = O.AdamWState(step=(), mu=psh, nu=psh)
            tok, tok_sh = _act((B, shape.seq_len), ("batch", None), mesh,
                               rules)
            tgt = _sds((B, shape.seq_len), torch.int32)
            args = [params, opt, tok, tgt]
            shardings = [psh, osh, tok_sh, tok_sh]
            _frames(cfg, B, mesh, rules, args, shardings)

        def fn(params, opt, tokens, targets, *extra):
            ee = extra[0] if extra else None
            return ST.lm_train_step(params, opt, cfg, tokens, targets,
                                    extra_embeds=ee)

        return CellSpec(fn, tuple(args), tuple(shardings), (0, 1),
                        {"kind": kind, "param_dtype": pdtype, "fsdp": fsdp})

    # ---- inference cells: bf16 weights ------------------------------------
    params, axes = abstract_params(cfg, "bfloat16", mode)
    mp, maxes = abstract_medusa(cfg, "bfloat16", mode)
    psh = param_shardings(axes, mesh, rules, params)
    msh = param_shardings(maxes, mesh, rules, mp)
    tb = spec_tree(cfg)
    eng = _engine(cfg, optimized)

    if kind == "prefill":
        with mode:
            cache = model.init_cache(cfg, B, shape.seq_len,
                                     device=PLAN_DEVICE)
            csh = profiles.cache_pspecs(cache, cfg, shape, mesh, multi_pod)
            tok, tok_sh = _act((B, shape.seq_len), ("batch", None), mesh,
                               rules)
            lens, len_sh = _act((B,), ("batch",), mesh, rules)
            args = [params, mp, tok, lens, cache]
            shardings = [psh, msh, tok_sh, len_sh, csh]
            if cfg.frontend and cfg.family != "encdec":
                # vlm decoder-only: frontend prefix + (seq - prefix) tokens
                args[2] = _sds((B, shape.seq_len - cfg.frontend_len),
                               torch.int32)
            _frames(cfg, B, mesh, rules, args, shardings)

        if cfg.frontend:
            def fn(params, mp, tokens, lengths, cache, frames):
                return eng.prefill(params, mp, tokens, lengths, cache,
                                   extra_embeds=frames)
        else:
            def fn(params, mp, tokens, lengths, cache):
                return eng.prefill(params, mp, tokens, lengths, cache)

        return CellSpec(fn, tuple(args), tuple(shardings), (4,),
                        {"kind": kind, "tree_T": tb.T})

    # ---- decode: the paper's static speculative step ----------------------
    with mode:
        cache = model.init_cache(cfg, B, shape.seq_len, device=PLAN_DEVICE)
        csh = profiles.cache_pspecs(cache, cfg, shape, mesh, multi_pod)
        args, shardings = _decode_inputs(B, tb, mesh, rules)

    def fn(params, mp, cache, lengths, base, state, key):
        # greedy: the step draws no noise, so ``key`` goes unused
        return eng.spec_step(params, mp, cache, lengths, base, state)

    return CellSpec(fn, (params, mp, cache) + args,
                    (psh, msh, csh) + shardings, (2,),
                    {"kind": "decode", "tree_T": tb.T,
                     "spec_mode": cfg.spec_mode, "optimized": optimized})


def _decode_inputs(B: int, tb, mesh, rules):
    """(lengths, base, proposer state, key) and their specs."""
    lens, len_sh = _act((B,), ("batch",), mesh, rules)
    base, base_sh = _act((B,), ("batch",), mesh, rules)
    # proposer state: the Medusa head top-k tree, [B]-leading
    mtok, mtok_sh = _act((B, MEDUSA_K, tb.max_topk), ("batch", None, None),
                         mesh, rules)
    mprob, mprob_sh = _act((B, MEDUSA_K, tb.max_topk), ("batch", None, None),
                           mesh, rules, torch.float32)
    key = _sds((2,), torch.uint32)
    return ((lens, base, {"mtok": mtok, "mprob": mprob}, key),
            (len_sh, base_sh, {"mtok": mtok_sh, "mprob": mprob_sh}, ()))


# ---------------------------------------------------------------------------
# one device's program
# ---------------------------------------------------------------------------

def batch_ranks(mesh, multi_pod: bool) -> int:
    """How many ways the batch splits: the product of the DP axes."""
    return math.prod(mesh.shape[a] for a in profiles.batch_axes(multi_pod))


def rank_program(cfg: ModelConfig, shape: ShapeConfig, mesh,
                 multi_pod: bool) -> Optional[str]:
    """Which of the port's sharded programs runs the cell on ``mesh``:
    "single" (one device), "tp" (``TPSpecEngine`` over ``model``, the
    batch split over the DP axes), "dp" (``lm_train_step`` with its
    gradient all-reduce over the DP axes, replicated over ``model``), or
    None (the port has no sharded program for it)."""
    dp = batch_ranks(mesh, multi_pod)
    tp = int(mesh.shape["model"])
    if dp * tp == 1:
        return "single"
    if shape.global_batch % dp:
        return None
    if shape.kind == "train":
        return "dp" if dp > 1 else None
    try:
        TP._validate(cfg, "medusa", tp)
    except ValueError:
        return None
    return "tp"


def rank_cell(cfg: ModelConfig, shape: ShapeConfig, mesh, multi_pod: bool, *,
              optimized: bool = False, program: Optional[str] = None,
              rank: int = 0):
    """The program device ``rank`` runs (``rank_program``), as a
    ``CellSpec`` whose args are that rank's own (fake) tensors: for "tp"
    its weight slices (``in_shardings``: the specs ``TPSpecEngine`` cut
    them by), its kv heads of the cache and its rows of the batch; for
    "dp" its rows of the batch and the whole weights (``in_shardings``
    all replicated).  Call it, and its ``fn``, inside
    ``collectives.planning()``: it registers the planning axes the
    program's collectives run over.  None where the port has no sharded
    program for the cell."""
    program = program or rank_program(cfg, shape, mesh, multi_pod)
    if program is None:
        return None
    if program == "single":
        return build_cell(cfg, shape, mesh, multi_pod, optimized=optimized)
    dp = batch_ranks(mesh, multi_pod)
    tp = int(mesh.shape["model"])
    B = shape.global_batch // dp
    local = dataclasses.replace(shape, global_batch=B)
    one = make_dev_mesh()
    if program == "dp":
        cell = build_cell(cfg, local, one, False, rules_override={
            k: None for k in profiles.make_rules(shape.kind)})
        C.register_plan("data", dp, rank // tp)

        def fn(params, opt, tokens, targets, *extra):
            ee = extra[0] if extra else None
            return ST.lm_train_step(params, opt, cfg, tokens, targets,
                                    extra_embeds=ee, dp_axis="data")

        return CellSpec(fn, cell.args, cell.in_shardings, cell.donate,
                        dict(cell.meta, program="dp", batch_ranks=dp))

    tmesh = TP.plan_tp_group(tp, data=dp, rank=rank)
    tpe = TP.build_tp_engine(cfg, tmesh, "medusa", tb=spec_tree(cfg),
                             device=PLAN_DEVICE, deferred=optimized)
    mode = fake_mode()
    params, _ = abstract_params(cfg, "bfloat16", mode)
    mp, _ = abstract_medusa(cfg, "bfloat16", mode)
    rules = {k: None for k in profiles.make_rules(shape.kind)}
    meta = {"kind": shape.kind, "program": "tp", "batch_ranks": dp, "tp": tp}
    with mode:
        params = tpe.shard_params(params)
        cache = get_model(tpe.local_cfg).init_cache(
            tpe.local_cfg, B, shape.seq_len, device=PLAN_DEVICE)
        cspec = profiles.tp_cache_pspecs(
            get_model(cfg).init_cache(cfg, B, shape.seq_len,
                                      device=PLAN_DEVICE), cfg, tmesh)
        mspec = {k: () for k in mp}
        if shape.kind == "prefill":
            tok, _ = _act((B, shape.seq_len), ("batch", None), one, rules)
            lens, _ = _act((B,), ("batch",), one, rules)

            def fn(params, mp, tokens, lengths, cache):
                return tpe.prefill(params, mp, tokens, lengths, cache)

            return CellSpec(fn, (params, mp, tok, lens, cache),
                            (tpe.pspecs, mspec, (), (), cspec), (4,), meta)
        args, specs = _decode_inputs(B, tpe.tb, one, rules)

    def fn(params, mp, cache, lengths, base, state, key):
        return tpe.spec_step(params, mp, cache, lengths, base, state)

    return CellSpec(fn, (params, mp, cache) + args,
                    (tpe.pspecs, mspec, cspec) + specs, (2,),
                    dict(meta, optimized=optimized))


def _param_bytes_estimate(cfg: ModelConfig) -> float:
    """Rough non-embedding parameter count * 4 bytes (f32)."""
    d, f, L = cfg.d_model, cfg.d_ff, cfg.num_layers
    n = 0.0
    for i in range(L):
        if cfg.layer_kind(i) == "attn":
            hd = cfg.resolved_head_dim
            n += d * hd * (cfg.num_heads + 2 * cfg.num_kv_heads) + cfg.num_heads * hd * d
        else:
            n += 2 * d * cfg.d_inner + cfg.d_inner * d
        if cfg.ffn_kind(i) == "moe":
            n += cfg.num_experts * 3 * d * f
        elif cfg.ffn_kind(i) == "dense":
            n += (3 if cfg.gated_mlp else 2) * d * f
    n += 2 * cfg.vocab_size * d
    return n * 4


def with_num_units(cfg: ModelConfig, n: int) -> ModelConfig:
    """Same arch with n stacked units."""
    if cfg.family == "encdec":
        return dataclasses.replace(cfg, num_layers=n, encoder_layers=n)
    u = len(unit_structure(cfg))
    return dataclasses.replace(cfg, num_layers=n * u)
