"""Rank workers of ``tests/test_torch_tp.py`` (no tests of its own).

``collectives.spawn`` starts each rank in a fresh process and runs
``run(rank, world, device, jobs)`` there by name, so these functions live
in a module of their own that imports torch and the port only (no JAX).
Every rank runs the same jobs in the same order, so their collectives
pair up; each job returns numpy values, which the parent holds against
the reference.
"""
import dataclasses

import numpy as np
import torch

from repro_torch import bridge
from repro_torch.configs.base import SamplingParams
from repro_torch.core import engine as E
from repro_torch.distributed import collectives as C
from repro_torch.distributed import tp as TP
from repro_torch.training import optimizer as O
from repro_torch.training import steps as St


def _np(tree):
    """Nested dicts of tensors -> numpy (bf16 widened to float32, which is
    exact)."""
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    t = tree.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def stats_job(cases):
    """``tp_verify_stats`` from this rank's vocabulary slice of each case's
    full logits."""
    ax = C.axis("model")
    out = []
    for logits, cand, tmax in cases:
        v_loc = logits.shape[-1] // ax.size
        loc = torch.from_numpy(
            logits[..., ax.rank * v_loc:(ax.rank + 1) * v_loc].copy())
        st = E.tp_verify_stats(loc, torch.from_numpy(cand),
                               torch.from_numpy(tmax), "model")
        out.append(tuple(t.numpy() for t in st))
    return out


def generate_job(mesh, case):
    """One TP ``generate`` of the identity matrix: tokens, counts, steps,
    and the shapes this rank holds."""
    sampling = (SamplingParams(temperature=0.0)
                if case["accept"] == "sample" else None)
    tpe = TP.build_tp_engine(case["cfg"], mesh, case["proposer"],
                             device="cpu", accept=case["accept"],
                             sampling=sampling)
    sp = tpe.shard_params(bridge.to_torch(case["params"], device="cpu"))
    pp = (bridge.to_torch(case["mp"], device="cpu")
          if case["mp"] is not None else None)
    B = case["tokens"].shape[0]
    cache = tpe.init_cache(B, case["max_len"])
    out, n, st = tpe.generate(sp, pp, torch.from_numpy(case["tokens"]),
                              torch.from_numpy(case["lengths"]), cache,
                              case["max_new"])
    shapes = lambda tree: {k: shapes(v) if isinstance(v, dict)  # noqa: E731
                           else tuple(v.shape) for k, v in tree.items()}
    return {"out": out.numpy(), "n": n.numpy(), "steps": st.steps,
            "param_shapes": shapes(sp), "pspecs": tpe.pspecs,
            "cache_shapes": shapes(cache)}


def dp_job(case):
    """One data-parallel step on this rank's rows of the batch, and this
    rank's own gradients (the same call the step makes first)."""
    C.register("dp", range(C.axis("model").size), "gloo")
    r, n = C.axis("dp").rank, C.axis("dp").size
    rows = case["tokens"].shape[0] // n
    toks = torch.from_numpy(case["tokens"][r * rows:(r + 1) * rows])
    cfg, comp = case["cfg"], case["compress"]
    if case["kind"] == "lm":
        params = bridge.to_torch(case["params"], device="cpu")
        _, grads = St.value_and_grad(St.lm_loss, params, cfg, toks[:, :-1],
                                     toks[:, 1:], None)
        params, opt, m = St.lm_train_step(
            params, O.adamw_init(params), cfg, toks[:, :-1], toks[:, 1:],
            dp_axis="dp", compress_grads=comp)
    else:
        backbone = bridge.to_torch(case["params"], device="cpu")
        params = bridge.to_torch(case["mp"], device="cpu")
        _, grads = St.value_and_grad(St.medusa_loss, params, backbone, cfg,
                                     toks, case["K"], lam_decay=0.8,
                                     pad_id=case["pad_id"])
        params, opt, m = St.medusa_train_step(
            params, O.adamw_init(params), backbone, cfg, toks, case["K"],
            pad_id=case["pad_id"], dp_axis="dp", compress_grads=comp)
    return {"params": _np(params), "mu": _np(opt.mu), "grads": _np(grads),
            "loss": float(m["loss"])}


def meter_job(mesh, case):
    """A prefill, then one spec step of the TP engine under
    ``collectives.metered``: the step's collectives (count and result
    bytes by op) and the bytes of the step's arguments on this rank (the
    weights in the dtypes the dry-run planner's inference cells hold:
    bf16, norms in f32)."""
    from repro_torch.launch import specs as S
    cfg = case["cfg"]
    tpe = TP.build_tp_engine(cfg, mesh, "medusa", device="cpu")
    like = lambda t, f: t.to(f.dtype)  # noqa: E731
    sp = tpe.shard_params(O.tree_map(
        like, bridge.to_torch(case["params"], device="cpu"),
        S.abstract_params(cfg, "bfloat16")[0]))
    pp = O.tree_map(like, bridge.to_torch(case["mp"], device="cpu"),
                    S.abstract_medusa(cfg, "bfloat16")[0])
    B, n = case["batch"], case["prompt"]
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        2, cfg.vocab_size, (B, n)).astype(np.int32))
    cache = tpe.init_cache(B, case["max_len"])
    cache, lens, base, state = tpe.prefill(
        sp, pp, toks, torch.full((B,), n, dtype=torch.int32), cache)
    step_args = (sp, pp, cache, lens, base, state)
    nbytes = sum(t.nbytes for t in O.tree_leaves(
        {str(i): a for i, a in enumerate(step_args)}))
    with C.metered() as m:
        tpe.spec_step(*step_args)
    return {"count": dict(m.count), "bytes": dict(m.bytes),
            "argument_bytes": nbytes}


def cpsum_job(trees):
    g = bridge.to_torch(trees[C.axis("model").rank], device="cpu")
    return _np(O.compressed_psum(g, "model"))


def ag_matmul_job(x, w):
    return C.ag_matmul(torch.from_numpy(x), torch.from_numpy(w),
                       "model").numpy()


def grid_job():
    """A 2 x 2 grid: sums of the global rank over each axis."""
    mesh = TP.make_tp_group(2, data=2)
    me = torch.tensor([float(torch.distributed.get_rank())])
    return {"coords": (mesh.data_index, mesh.model_index),
            "model": float(C.psum(me, "model")),
            "data": float(C.psum(me, "data")),
            "gathered": C.all_gather(me, "model", 0).numpy()}


def run(rank, world, dev, jobs):
    mesh = TP.make_tp_group(world)
    out = {"rank": rank}
    for name, job in jobs:
        if name == "stats":
            out[name] = stats_job(job)
        elif name == "generate":
            out[name] = {tag: generate_job(mesh, case)
                         for tag, case in job.items()}
        elif name == "dp":
            out[name] = {tag: dp_job(case) for tag, case in job.items()}
        elif name == "meter":
            out[name] = meter_job(mesh, job)
        elif name == "cpsum":
            out[name] = cpsum_job(job)
        elif name == "ag_matmul":
            out[name] = ag_matmul_job(*job)
        elif name == "grid":
            out[name] = grid_job()
        else:
            raise ValueError(f"unknown job {name!r}")
    return out


def with_layout(cfg, layout: str, page_size: int = 16):
    dtype, lay = {"dense": ("", "dense"), "paged": ("", "paged"),
                  "int8": ("int8", "dense"),
                  "int8+paged": ("int8", "paged")}[layout]
    return dataclasses.replace(cfg, cache_dtype=dtype, cache_layout=lay,
                               page_size=page_size)
