"""Tensor and data parallelism on ``torch.distributed``, one process per
rank (counterpart of ``repro.distributed``).

* ``collectives``: the process-group layer.  A registry from an axis name
  ("model", "data") to its group, the collectives the model and the
  training steps call by that name (``psum``, ``pmax``, ``all_gather``,
  the ring ``ag_matmul``), and the spawner that starts the ranks.
* ``sharding``: ``spec_for`` (which dimension of a leaf shards over which
  named axis), ``shard_leaf`` (a rank's contiguous slice), ``param_axes``
  and ``medusa_axes`` (every family's logical axes) and the dry-run
  planner's ``param_shardings``.
* ``profiles``: the rule sets per workload kind (``make_rules``) and the
  decode cache's placements: ``cache_pspecs`` (the planner's) and
  ``tp_cache_pspecs`` (under tensor parallelism).
* ``tp``: ``TPSpecEngine``, the single-device engine run over a local
  config on every rank of a "model" group; ``plan_tp_group``, its grid
  of planning axes (no process group) for the planner.

Nothing here is imported by the single-device path: a config with an
empty ``tp_axis`` reaches no collective.
"""
