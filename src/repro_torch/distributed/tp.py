"""Tensor-parallel speculative decoding on ``torch.distributed``, one
process per rank (counterpart of ``repro.distributed.tp``).

``TPSpecEngine`` runs the unchanged single-device ``SpecEngine`` on every
rank of a "model" group, built over a local config: ``replace(cfg,
num_heads=Hq/tp, num_kv_heads=Hkv/tp, head_dim=resolved, tp_axis=axis)``.
Every einsum of the model then sees its rank's slice as the whole world,
and the only cross-rank traffic is

  * one sum after each row-parallel contraction (``layers.tp_reduce``:
    the attention's ``wo``, the MLP's down projection),
  * the verify epilogue's statistics (``SpecEngine._verify_tp``), and
  * a full-row all-gather where a whole [.., V] row is needed
    (``transformer.unembed``: the prefill's base token, a row resample).

Placement (``shard_params`` / ``profiles.tp_cache_pspecs``):

  column-parallel  wq/wk/wv (and their biases) on heads, the MLP's wi/wg
                   on ff, lm_head on vocab
  row-parallel     the attention's wo on heads, the MLP's wo on ff
  replicated       embed (a take by global token id), norms, the
                   proposer's weights and state, tokens, lengths, base
                   tokens, block tables
  KV cache         the kv-head axis (index 3), dense and pool form alike

Replicated values stay the same on every rank by determinism: each rank
computes them from the same inputs and the all-reduced activations, and
each rank's engine draws its noise from a generator seeded alike, so
sampled steps agree too.  The step runs eagerly (gloo's collectives
cannot be captured in a CUDA graph).  ``make_tp_group`` builds the
``data`` x ``model`` grid of groups over the ranks ``collectives.spawn``
started; each data row repeats the same work, as the reference's
replicated specs do.  ``plan_tp_group`` builds the same grid of planning
axes for the dry-run planner, with no process group.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch.distributed as dist

from repro_torch.configs.base import ModelConfig, SamplingParams
from repro_torch.core.engine import build_engine
from repro_torch.core.tree import TreeBuffers
from repro_torch.distributed import collectives as C
from repro_torch.distributed.sharding import param_axes, shard_leaf, spec_for
from repro_torch.kernels.tree_attention import pitch_lm_head

_TP_PROPOSERS = ("medusa", "ngram")


class TPMesh(NamedTuple):
    """The ``data`` x ``model`` grid this process belongs to."""
    shape: dict          # {"data": data, "model": tp}
    data_index: int      # this rank's row
    model_index: int     # this rank's place in its "model" group
    backend: str


def make_tp_group(tp: int, data: int = 1) -> TPMesh:
    """Build and register the ("data", "model") groups over the world:
    global rank r sits at row r // tp, column r % tp.  Every rank must
    call it (group creation is collective).  The world must hold exactly
    ``data * tp`` ranks."""
    world = dist.get_world_size()
    if world != data * tp:
        raise ValueError(f"a ({data} x {tp}) grid needs {data * tp} ranks; "
                         f"the world has {world}")
    backend = str(dist.get_backend())
    me = dist.get_rank()
    rows = [[d * tp + m for m in range(tp)] for d in range(data)]
    cols = [[d * tp + m for d in range(data)] for m in range(tp)]
    # every rank creates every group, in the same order
    groups = {}
    for name, sets in (("model", rows), ("data", cols)):
        for ranks in sets:
            g = (dist.group.WORLD if len(ranks) == world
                 else dist.new_group(ranks))
            if me in ranks:
                groups[name] = (ranks, g)
    for name, (ranks, g) in groups.items():
        C.register(name, ranks, backend, g)
    return TPMesh({"data": data, "model": tp}, me // tp, me % tp, backend)


def plan_tp_group(tp: int, data: int = 1, rank: int = 0) -> TPMesh:
    """``make_tp_group``'s grid for the dry-run planner, without
    ``torch.distributed``: planning axes ``model`` (``tp``) and ``data``
    (``data``) for global rank ``rank`` (``collectives.register_plan``;
    call it inside ``collectives.planning()``)."""
    if not 0 <= rank < data * tp:
        raise ValueError(f"rank {rank} is not on a ({data} x {tp}) grid")
    C.register_plan("model", tp, rank % tp)
    C.register_plan("data", data, rank // tp)
    return TPMesh({"data": data, "model": tp}, rank // tp, rank % tp, C.PLAN)


def _validate(cfg: ModelConfig, proposer: str, tp: int):
    if cfg.tp_axis:
        raise ValueError("cfg already carries a tp_axis: pass the global "
                         "config, TPSpecEngine derives the local one")
    if cfg.family != "dense":
        raise ValueError(
            f"tensor-parallel decode supports the dense family only; "
            f"{cfg.family!r} has non-TP mixers")
    if cfg.tie_embeddings:
        raise ValueError("TP shards the lm_head over vocab; tied embeddings "
                         "would shard the token-id take too")
    if cfg.verify_fusion:
        raise ValueError("verify_fusion's kernel epilogue is single-device; "
                         "TP has its own statistics epilogue")
    if proposer not in _TP_PROPOSERS:
        raise ValueError(f"TP proposers: {_TP_PROPOSERS}; {proposer!r} runs "
                         "its own forward that is not head-sharded")
    for name, dim in (("num_heads", cfg.num_heads),
                      ("num_kv_heads", cfg.num_kv_heads),
                      ("d_ff", cfg.d_ff),
                      ("vocab_size", cfg.vocab_size)):
        if dim % tp != 0:
            raise ValueError(f"{name}={dim} does not divide over tp={tp}")


def _map_axes(fn, axes, params):
    """``fn(axes_leaf, param_leaf)`` over the axes tree (tuples at the
    leaves) and the parameter tree of the same nesting."""
    if isinstance(axes, dict):
        return {k: _map_axes(fn, axes[k], params[k]) for k in axes}
    return fn(tuple(axes), params)


class TPSpecEngine:
    """``SpecEngine`` façade whose step runs sharded over the ``axis``
    group of ``mesh`` (``make_tp_group``), on this process's rank.

    Call ``shard_params(params)`` once with the global weights (it keeps
    the spec tree and returns this rank's slices), then ``init_cache`` /
    ``prefill`` / ``spec_step`` / ``generate`` as on the single-device
    engine, with the sliced weights and replicated proposer weights.
    Every rank returns the same tokens; the cache stays sharded on its
    kv-head axis across calls.  ``use_kernel``, ``device`` and
    ``deferred`` as ``build_engine`` (``device`` the rank's own, from
    ``spawn``).
    ``graphs=True`` is refused: the step runs eagerly."""

    def __init__(self, cfg: ModelConfig, mesh: TPMesh, *, axis: str = "model",
                 proposer: str = "medusa", tb: Optional[TreeBuffers] = None,
                 gamma: int = 4, max_n: int = 3, min_n: int = 1,
                 accept: str = "greedy",
                 sampling: Optional[SamplingParams] = None,
                 use_kernel: bool = False, device="cuda",
                 graphs: bool = False, seed: int = 0,
                 deferred: bool = False):
        if graphs:
            raise ValueError("the tensor-parallel step runs eagerly: gloo's "
                             "collectives cannot be captured in a CUDA graph "
                             "(capturing the NCCL step is later work); pass "
                             "graphs=False")
        tp = int(mesh.shape[axis])
        _validate(cfg, proposer, tp)
        ax = C.axis(axis)
        if ax.size != tp:
            raise ValueError(f"axis {axis!r} has {ax.size} ranks, the mesh "
                             f"says {tp}")
        self.cfg = cfg
        self.mesh = mesh
        self.axis = axis
        self.tp = tp
        self.rank = ax.rank
        self.local_cfg = dataclasses.replace(
            cfg, num_heads=cfg.num_heads // tp,
            num_kv_heads=cfg.num_kv_heads // tp,
            head_dim=cfg.resolved_head_dim, tp_axis=axis)
        self.local = build_engine(self.local_cfg, proposer, tb=tb,
                                  gamma=gamma, max_n=max_n, min_n=min_n,
                                  use_kernel=use_kernel, device=device,
                                  accept=accept, sampling=sampling,
                                  graphs=False, seed=seed,
                                  deferred=deferred)
        self.device = self.local.device
        self.proposer = self.local.proposer
        self.tb = self.local.tb
        self.dtree = self.local.dtree
        self.accept = self.local.accept
        self.sampling = self.local.sampling
        self.step_graphs = self.local.step_graphs
        self.pspecs = None
        self.steps = 0           # decode steps ``generate`` has run

    # ------------------------------------------------------------ placement

    def shard_params(self, params, axes=None):
        """This rank's slices of the global ``params`` under the TP plan
        (``axes``: the logical axes tree, default ``param_axes(cfg)``);
        the spec tree is kept in ``pspecs``.  Sharded leaves are
        contiguous copies, replicated ones the caller's tensors; the
        ``lm_head``'s vocabulary slice, a copy of its own, is pitched again
        (``pitch_lm_head``: its start and row pitch 16-byte aligned)."""
        rules = {"heads": self.axis, "kv_heads": self.axis,
                 "ff": self.axis, "vocab": self.axis}
        axes = param_axes(self.cfg) if axes is None else axes
        specs = _map_axes(lambda ax, t: spec_for(ax, rules, shape=t.shape,
                                                 mesh=self.mesh),
                          axes, params)
        if "embed" in specs:
            # the embedding's vocab axis must not shard: embed_tokens is a
            # take by global token id, replicated on purpose
            specs["embed"] = ()
        self.pspecs = specs
        local = _map_axes(lambda spec, t: shard_leaf(t, spec, self.rank,
                                                     self.tp), specs, params)
        if "lm_head" in local:
            local["lm_head"] = pitch_lm_head(local["lm_head"])
        return local

    def init_cache(self, batch: int, max_len: int, n_blocks=None):
        """This rank's shard of the global-shape cache (its kv-head axis cut
        as ``profiles.tp_cache_pspecs`` places it): the local config's
        cache, ``Hkv / tp`` kv heads on index 3 of every k/v leaf (kept
        by the engine per shape, as ``SpecEngine.init_cache``)."""
        return self.local.init_cache(batch, max_len, n_blocks=n_blocks)

    def init_proposer_state(self, batch: int, capacity: int):
        return self.local.init_proposer_state(batch, capacity)

    # ------------------------------------------------------------- the step

    def _require_specs(self):
        if self.pspecs is None:
            raise RuntimeError("call shard_params(...) before running the "
                               "TP engine: it fixes this rank's slices")

    def prefill(self, params, proposer_params, tokens, lengths, cache,
                state=None, temperature=None, top_p=None):
        self._require_specs()
        return self.local.prefill(params, proposer_params, tokens, lengths,
                                  cache, state=state,
                                  temperature=temperature, top_p=top_p)

    def spec_step(self, params, proposer_params, cache, lengths, base, state,
                  draws=None, temperature=None, top_p=None):
        self._require_specs()
        return self.local.spec_step(params, proposer_params, cache, lengths,
                                    base, state, draws=draws,
                                    temperature=temperature, top_p=top_p)

    def generate(self, params, proposer_params, tokens, prompt_lengths,
                 cache, max_new: int, extra_embeds=None, state=None,
                 temperature=None):
        if extra_embeds is not None:
            raise ValueError("the dense family takes no extra_embeds")
        self._require_specs()
        out = self.local.generate(params, proposer_params, tokens,
                                  prompt_lengths, cache, max_new,
                                  state=state, temperature=temperature)
        self.steps += out[2].steps
        return out


def build_tp_engine(cfg: ModelConfig, mesh: TPMesh, proposer: str = "medusa",
                    **kw) -> TPSpecEngine:
    """``build_engine``'s sibling for the sharded step."""
    return TPSpecEngine(cfg, mesh, proposer=proposer, **kw)
