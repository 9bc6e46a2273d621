"""Tensor and data parallelism on ``torch.distributed``, one process per
rank (counterpart of ``repro.distributed``).

* ``collectives``: the process-group layer.  A registry from an axis name
  ("model", "data") to its group, the collectives the model and the
  training steps call by that name (``psum``, ``pmax``, ``all_gather``,
  the ring ``ag_matmul``), and the spawner that starts the ranks.
* ``sharding``: ``spec_for`` (which dimension of a leaf shards over which
  named axis), ``shard_leaf`` (a rank's contiguous slice) and
  ``param_axes`` (the logical axes of the dense family's parameters).
* ``profiles``: ``tp_cache_pspecs``, the decode cache's placement under
  tensor parallelism.
* ``tp``: ``TPSpecEngine``, the single-device engine run over a local
  config on every rank of a "model" group.

Nothing here is imported by the single-device path: a config with an
empty ``tp_axis`` reaches no collective.
"""
