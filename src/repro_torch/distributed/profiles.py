"""Placement of the decode cache under tensor parallelism (the
``tp_cache_pspecs`` of ``repro.distributed.profiles``).

The rest of the reference's module (the dry-run's cache and activation
specs per shape cell) belongs to the dry-run planner.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig

_ROW_LEAVES = ("k", "v", "k_scale", "v_scale")


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

    def walk(tree, in_cross=False):
        out = {}
        for key, val in tree.items():
            if isinstance(val, dict):
                out[key] = walk(val, in_cross=(key == "cross"))
            else:
                out[key] = spec("cross" if in_cross else key, val)
        return out

    return walk(cache)
