"""Logical-axis placement of parameters (counterpart of
``repro.distributed.sharding``).

A leaf's placement is a spec: a tuple with one entry per leading
dimension, the mesh axis that dimension shards over or None, trailing
Nones dropped (the reference's ``PartitionSpec`` entries).  ``spec_for``
maps a leaf's logical axis names to its spec under a rules dict, with the
reference's divisibility and uniqueness guards; ``shard_leaf`` cuts a
rank's contiguous slice.  The port's ``init_params`` returns plain
tensors, so ``param_axes`` gives the logical axes the reference's
``split_params`` returns beside them, for the dense family.

The reference's ``logical()`` / ``axis_rules`` (sharding constraints on
activations inside one SPMD program) have nothing to do under one
process per rank, where every tensor already is the rank's own: they are
the identity here and belong to the dry-run planner.
"""
from __future__ import annotations

import math

from repro_torch.configs.base import ModelConfig


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


def param_axes(cfg: ModelConfig) -> dict:
    """The logical axes of every leaf ``transformer.init_params`` makes
    for a dense config: the tree the reference's ``split_params`` returns
    beside the values (the stacked units lead with "layers")."""
    if cfg.family != "dense":
        raise ValueError(f"param_axes covers the dense family; "
                         f"{cfg.name} is {cfg.family!r}")
    L = ("layers",)
    attn = {"wq": L + ("embed", "heads", "head_dim"),
            "wk": L + ("embed", "kv_heads", "head_dim"),
            "wv": L + ("embed", "kv_heads", "head_dim"),
            "wo": L + ("heads", "head_dim", "embed")}
    if cfg.qkv_bias:
        attn["bq"] = L + ("heads", "head_dim")
        attn["bk"] = L + ("kv_heads", "head_dim")
        attn["bv"] = L + ("kv_heads", "head_dim")
    ffn = {"wi": L + ("embed", "ff"), "wo": L + ("ff", "embed")}
    if cfg.gated_mlp:
        ffn["wg"] = L + ("embed", "ff")
    axes = {"embed": ("vocab", "embed"),
            "units": {"pos0": {"norm1": _norm_axes(cfg, L), "attn": attn,
                               "norm2": _norm_axes(cfg, L), "ffn": ffn}},
            "final_norm": _norm_axes(cfg)}
    if not cfg.tie_embeddings:
        axes["lm_head"] = ("embed", "vocab")
    if cfg.frontend:
        axes["frontend_proj"] = (None, "embed")
    return axes
