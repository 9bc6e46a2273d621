"""Logical-axis placement of parameters and activations (counterpart of
``repro.distributed.sharding``).

A leaf's placement is a spec: a tuple with one entry per leading
dimension, the mesh axis that dimension shards over or None, trailing
Nones dropped (the reference's ``PartitionSpec`` entries).  ``spec_for``
maps a leaf's logical axis names to its spec under a rules dict, with the
reference's divisibility and uniqueness guards; ``shard_leaf`` cuts a
rank's contiguous slice.

The port's ``init_params`` returns plain tensors.  ``param_axes`` (every
family) and ``medusa_axes`` give the logical axes that the reference's
``split_params`` returns beside them, so the reference's ``Param`` /
``split_params`` pair, a JAX pytree device, has no counterpart here.
``param_shardings`` maps an axes tree and its shapes to a tree of specs.

The reference's ``logical()`` / ``axis_rules`` / ``current_rules`` /
``rule_size`` constrain activations inside one SPMD program and size
them by the installed rules; under one process per rank every tensor
already is the rank's own and nothing consults a rule while it runs, so
they have no counterpart here either.
"""
from __future__ import annotations

import math

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import unit_structure


def spec_for(axes: tuple, rules: dict, shape=None, mesh=None) -> tuple:
    """Map logical axis names to a spec under ``rules`` (logical name ->
    mesh axis name or a tuple of them).  ``mesh`` needs only ``.shape``,
    a dict of axis sizes.

    Guards:
      * divisibility: an assignment that does not divide the dimension is
        dropped (replicated), e.g. 8 KV heads on a 16-way axis;
      * uniqueness: a mesh axis shards at most one dimension; the first
        logical axis that claims it wins."""
    entries = []
    used = set()
    for i, name in enumerate(axes):
        ax = rules.get(name) if name is not None else None
        if ax is not None:
            ax_t = ax if isinstance(ax, tuple) else (ax,)
            if any(a in used for a in ax_t):
                ax = None
            elif shape is not None and mesh is not None:
                size = math.prod(mesh.shape[a] for a in ax_t)
                if shape[i] % size != 0:
                    ax = None
            if ax is not None:
                used.update(ax_t)
                # a one-axis tuple names that axis, as PartitionSpec has it
                ax = ax_t[0] if len(ax_t) == 1 else ax_t
        entries.append(ax)
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def shard_leaf(t, spec: tuple, rank: int, size: int):
    """Rank ``rank``'s slice of ``t`` out of ``size`` equal contiguous
    pieces along the dimension ``spec`` shards (``t`` itself for a
    replicated spec), as a contiguous copy.  One sharded dimension at
    most: the port's specs name one axis."""
    dims = [i for i, ax in enumerate(spec) if ax is not None]
    if not dims:
        return t
    if len(dims) > 1:
        raise ValueError(f"spec {spec} shards {len(dims)} dimensions; "
                         "shard_leaf cuts one")
    d = dims[0]
    n = t.shape[d]
    if n % size:
        raise ValueError(f"dimension {d} of {tuple(t.shape)} does not "
                         f"divide over {size}")
    piece = n // size
    return t.narrow(d, rank * piece, piece).contiguous()


def _norm_axes(cfg: ModelConfig, stack: tuple = ()):
    ax = {"w": stack + ("norm",)}
    if cfg.norm == "layernorm":
        ax["b"] = stack + ("norm",)
    return ax


def _attn_axes(cfg: ModelConfig, L: tuple):
    ax = {"wq": L + ("embed", "heads", "head_dim"),
          "wk": L + ("embed", "kv_heads", "head_dim"),
          "wv": L + ("embed", "kv_heads", "head_dim"),
          "wo": L + ("heads", "head_dim", "embed")}
    if cfg.qkv_bias:
        ax["bq"] = L + ("heads", "head_dim")
        ax["bk"] = L + ("kv_heads", "head_dim")
        ax["bv"] = L + ("kv_heads", "head_dim")
    return ax


def _mlp_axes(cfg: ModelConfig, L: tuple):
    ax = {"wi": L + ("embed", "ff"), "wo": L + ("ff", "embed")}
    if cfg.gated_mlp:
        ax["wg"] = L + ("embed", "ff")
    return ax


def _moe_axes(L: tuple):
    return {"router": L + ("embed", None),
            "wi": L + ("experts", "embed", "ff"),
            "wg": L + ("experts", "embed", "ff"),
            "wo": L + ("experts", "ff", "embed")}


def _ssm_axes(L: tuple):
    return {"wz": L + ("embed", "ssm_inner"), "wx": L + ("embed", "ssm_inner"),
            "wB": L + ("embed", None), "wC": L + ("embed", None),
            "wdt": L + ("embed", "ssm_heads"),
            "conv_x": L + ("ssm_inner", None), "conv_x_b": L + ("ssm_inner",),
            "conv_bc": L + (None, None), "conv_bc_b": L + (None,),
            "A_log": L + ("ssm_heads",), "dt_bias": L + ("ssm_heads",),
            "D": L + ("ssm_heads",), "norm_w": L + ("ssm_inner",),
            "out_proj": L + ("ssm_inner", "embed")}


def param_axes(cfg: ModelConfig) -> dict:
    """The logical axes of every leaf the family's ``init_params`` makes:
    the tree the reference's ``split_params`` returns beside the values
    (stacked unit leaves lead with "layers")."""
    L = ("layers",)
    if cfg.family == "encdec":
        return {"embed": ("vocab", "embed"), "pos_enc": (None, "embed"),
                "pos_dec": (None, "embed"), "frontend_proj": (None, "embed"),
                "enc_units": {"norm1": _norm_axes(cfg, L),
                              "attn": _attn_axes(cfg, L),
                              "norm2": _norm_axes(cfg, L),
                              "mlp": _mlp_axes(cfg, L)},
                "enc_final": _norm_axes(cfg),
                "dec_units": {"norm1": _norm_axes(cfg, L),
                              "self_attn": _attn_axes(cfg, L),
                              "norm_x": _norm_axes(cfg, L),
                              "cross_attn": _attn_axes(cfg, L),
                              "norm2": _norm_axes(cfg, L),
                              "mlp": _mlp_axes(cfg, L)},
                "final_norm": _norm_axes(cfg),
                "lm_head": ("embed", "vocab")}
    units = {}
    for i, (mix, ffn) in enumerate(unit_structure(cfg)):
        pos = {"norm1": _norm_axes(cfg, L)}
        pos["attn" if mix == "attn" else "ssm"] = (
            _attn_axes(cfg, L) if mix == "attn" else _ssm_axes(L))
        if ffn != "none":
            pos["norm2"] = _norm_axes(cfg, L)
            pos["ffn"] = _moe_axes(L) if ffn == "moe" else _mlp_axes(cfg, L)
        units[f"pos{i}"] = pos
    axes = {"embed": ("vocab", "embed"), "units": units,
            "final_norm": _norm_axes(cfg)}
    if not cfg.tie_embeddings:
        axes["lm_head"] = ("embed", "vocab")
    if cfg.frontend:
        axes["frontend_proj"] = (None, "embed")
    return axes


def medusa_axes() -> dict:
    """The logical axes of ``medusa.init_medusa``'s K stacked heads."""
    return {"w1": ("medusa", "embed", "medusa_ff"),
            "b1": ("medusa", "medusa_ff"),
            "lm": ("medusa", "embed", "vocab")}


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def param_shardings(axes_tree, mesh, rules: dict, shapes_tree):
    """The spec of every leaf of ``axes_tree`` (tuples of logical names at
    the leaves) under ``rules`` on ``mesh``, at the shape of the matching
    leaf of ``shapes_tree`` (tensors or anything with ``.shape``): a tree
    of spec tuples of the same nesting."""
    if _is_axes(axes_tree):
        return spec_for(axes_tree, rules, shape=tuple(shapes_tree.shape),
                        mesh=mesh)
    return {k: param_shardings(v, mesh, rules, shapes_tree[k])
            for k, v in axes_tree.items()}
