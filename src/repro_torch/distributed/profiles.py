"""Placement profiles (counterpart of ``repro.distributed.profiles``):
logical-axis -> mesh-axis rule sets per workload kind, and the spec trees
of the decode cache.

Mesh axes: ("pod", "data", "model") multi-pod / ("data", "model") single-pod.
  - model: TP over heads / kv-heads / ffn-hidden / vocab / ssm-inner /
    ssm-heads
  - data:  DP over batch, EP over experts, FSDP over the param embed dim
  - pod:   pure DP

A spec is a tuple of mesh-axis entries, one per dimension (the
reference's ``PartitionSpec``); in the port a spec is the placement, so
the reference's ``to_named`` (a ``NamedSharding`` wrapper) has no
counterpart.  ``cache_pspecs`` places the dry-run planner's cache
(``launch/specs.py``), ``tp_cache_pspecs`` the tensor-parallel engine's.
"""
from __future__ import annotations

import math

from repro_torch.configs.base import ModelConfig, ShapeConfig

_ROW_LEAVES = ("k", "v", "k_scale", "v_scale")


def batch_axes(multi_pod: bool):
    return ("pod", "data") if multi_pod else ("data",)


def make_rules(kind: str, *, multi_pod: bool = False,
               fsdp: bool = False) -> dict:
    """kind: train | prefill | decode (the reference's rule sets at its
    defaults: saved activations sequence-sharded for training only, the
    MoE's dispatch groups over "model")."""
    ba = batch_axes(multi_pod)
    return {
        # ---- parameters ----
        "vocab": "model", "heads": "model", "kv_heads": "model",
        "ff": "model", "experts": "data",
        "ssm_inner": "model", "ssm_heads": "model",
        "medusa_ff": "model", "medusa": None,
        "embed": "data" if fsdp else None,
        "norm": None, "head_dim": None, "layers": None,
        # ---- activations ----
        "batch": ba,
        # megatron-SP: shard saved activations
        "seq": "model" if kind == "train" else None,
        "act_embed": None,
        "act_ff": "model",
        "act_heads": "model",
        "act_kv": "model",
        "act_vocab": "model",
        "act_experts": "data",
        "act_moe_g": "model",
        "act_ssm_heads": "model",
    }


def _walk(tree, spec, in_cross=False):
    """``spec(role, leaf)`` over a cache tree; a leaf's role is its key,
    or "cross" for the k/v of the encoder-decoder's ``cross`` entry."""
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out[key] = _walk(val, spec, in_cross=(key == "cross"))
        else:
            out[key] = spec("cross" if in_cross else key, val)
    return out


def cache_pspecs(cache, cfg: ModelConfig, shape: ShapeConfig, mesh,
                 multi_pod: bool):
    """Spec tree of ``cache`` (``init_cache``'s tree; tensors on any
    device, fake or meta included, or anything with ``.shape``), full
    length as the reference's are.  ``mesh.shape`` is a dict of axis
    sizes.

    Dense layout: batch >= the data axes shards batch over the DP axes
    and KV-seq over model (flash-decoding style sequence parallelism);
    batch 1 (long_500k) shards KV-seq over every axis instead.  int8
    scales [nu, B, S, Hkv, 1] shard with their values.  SSM state:
    ``conv_x`` and ``ssm`` on their inner / head axis over model.  The
    encoder-decoder's ``cross`` k/v: batch only.  Every assignment that
    does not divide its dimension is dropped.

    Paged layout: pool leaves [nu, n_blocks, page, Hkv, hd] shard their
    kv-head axis over model (int8 scale pools ride along); the block
    table and every non-pool leaf (SSM state, dense cross k/v)
    replicate."""
    if cfg.paged:
        size = int(mesh.shape["model"])

        def pool_spec(role, arr):
            shp = tuple(arr.shape)
            if role in _ROW_LEAVES and len(shp) == 5 and shp[3] % size == 0:
                return (None, None, None, "model", None)
            return (None,) * len(shp)

        return _walk(cache, pool_spec)
    ba = batch_axes(multi_pod)
    b1 = shape.global_batch == 1
    kvseq = (("pod", "data", "model") if multi_pod else ("data", "model")) \
        if b1 else "model"
    batch = None if b1 else ba

    def spec(role, arr):
        shp = tuple(arr.shape)
        if role in _ROW_LEAVES:
            axes = (None, batch, kvseq, None, None)
        elif role == "cross":
            axes = (None, batch, None, None, None)
        elif role == "conv_x":
            axes = (None, batch, "model", None)
        elif role == "conv_bc":
            axes = (None, batch, None, None)
        elif role == "ssm":
            axes = (None, batch, "model", None, None)
        else:
            axes = (None,) * len(shp)
        entries = []
        for i, ax in enumerate(axes):
            if ax is None:
                entries.append(None)
                continue
            size = math.prod(mesh.shape[a]
                             for a in (ax if isinstance(ax, tuple) else (ax,)))
            if shp[i] % size:
                ax = None
            # a one-axis tuple names that axis, as PartitionSpec has it
            entries.append(ax[0] if isinstance(ax, tuple) and len(ax) == 1
                           else ax)
        return tuple(entries)

    return _walk(cache, spec)


def tp_cache_pspecs(cache, cfg: ModelConfig, mesh, axis: str = "model"):
    """Specs of a (global-shape) decode cache for the tensor-parallel step.

    Every rank runs a local model with ``Hkv / tp`` kv heads, so each k/v
    leaf and int8 scale leaf, pool form [nu, nb, ps, Hkv, hd] and dense
    form [nu, B, S, Hkv, hd] alike, shards its kv-head axis (index 3)
    over ``axis`` when it divides; block tables, SSM state and the
    encoder-decoder's ``cross`` entry replicate.  ``cache`` holds tensors
    (any device, ``meta`` included) or anything with ``.shape``;
    ``mesh.shape`` is a dict of axis sizes.  Specs are full-length tuples,
    as the reference's are."""
    size = int(mesh.shape[axis])

    def spec(role, arr):
        shape = tuple(arr.shape)
        if role in _ROW_LEAVES and len(shape) == 5 and shape[3] % size == 0:
            return (None, None, None, axis, None)
        return (None,) * len(shape)

    return _walk(cache, spec)
