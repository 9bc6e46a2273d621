"""Fault-tolerant checkpointing in the reference's on-disk layout
(counterpart of ``repro.training.checkpoint``): ``<dir>/step_%08d/``
holds ``arrays.npz`` (leaf i as ``a<i>``) and ``manifest.msgpack``
(``step``, ``keys``, ``dtypes``, ``shapes``, ``meta``).

A checkpoint is written into ``<dir>/tmp.<step>`` and ``os.replace``'d to
``step_<step>`` only when complete, so a partial one is never taken for a
valid one; ``restore_latest`` resumes from the newest.  Trees are nested
dicts (keys sorted, as JAX flattens them), tuples and lists (by index) and
NamedTuples such as ``optimizer.AdamWState`` (by ``.field``, in field
order); a leaf's key is its path joined by ``/``, as the reference names
it, so a float32 checkpoint the reference wrote restores here.  numpy has
no bfloat16: a bf16 leaf is stored as its uint16 bits under the dtype
``"bfloat16"``.
"""
from __future__ import annotations

import os
import re
import shutil
import threading
from typing import Any, Optional

import msgpack
import numpy as np
import torch

from repro_torch.kernels.tree_attention import is_pitched, pitch_lm_head


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _flatten(tree, prefix=()):
    """-> [(key, leaf)] in the reference's order."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in
                _flatten(tree[k], prefix + (str(k),))]
    if _is_namedtuple(tree):
        return [kv for f in tree._fields for kv in
                _flatten(getattr(tree, f), prefix + ("." + f,))]
    if isinstance(tree, (tuple, list)):
        return [kv for i, x in enumerate(tree) for kv in
                _flatten(x, prefix + (str(i),))]
    return [("/".join(prefix), tree)]


def _unflatten(template, leaves):
    """``template``'s structure with its leaves taken from the iterator
    ``leaves`` in ``_flatten``'s order."""
    if isinstance(template, dict):
        got = {k: _unflatten(template[k], leaves) for k in sorted(template)}
        return {k: got[k] for k in template}
    if _is_namedtuple(template):
        return type(template)(*(_unflatten(getattr(template, f), leaves)
                                for f in template._fields))
    if isinstance(template, (tuple, list)):
        return type(template)(_unflatten(x, leaves) for x in template)
    return next(leaves)


def _to_numpy(v) -> tuple:
    """(array, dtype name) of a leaf: tensors (bf16 as uint16 bits), numpy
    arrays and Python numbers."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        if v.dtype == torch.bfloat16:
            return v.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        v = v.numpy()
    a = np.asarray(v)
    return a, str(a.dtype)


def _to_tensor(a: np.ndarray, dtype: str, like=None) -> torch.Tensor:
    """The stored array as a tensor (sharing the loaded array's memory), on
    ``like``'s device when given, and at a row pitch of its own where
    ``like`` is a pitched lm head (a [d, V] view of a wider allocation,
    ``pitch_lm_head``)."""
    if not a.flags.writeable:
        a = a.copy()
    if dtype == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    if isinstance(like, torch.Tensor):
        t = t.to(like.device)
        if is_pitched(like):
            t = pitch_lm_head(t)
    return t


def save(ckpt_dir: str, step: int, tree: Any, meta: Optional[dict] = None):
    """Atomic synchronous save.  Returns the checkpoint's directory."""
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f"tmp.{step}")
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    flat = _flatten(tree)
    arrays = [_to_numpy(v) for _, v in flat]
    np.savez(os.path.join(tmp, "arrays.npz"),
             **{f"a{i}": a for i, (a, _) in enumerate(arrays)})
    manifest = {
        "step": step,
        "keys": [k for k, _ in flat],
        "dtypes": [d for _, d in arrays],
        "shapes": [list(a.shape) for a, _ in arrays],
        "meta": meta or {},
    }
    with open(os.path.join(tmp, "manifest.msgpack"), "wb") as f:
        f.write(msgpack.packb(manifest))
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def restore(path: str, template: Any = None):
    """-> (step, tree, meta).  With a template, the leaves come back as
    tensors in its structure, each on its template leaf's device (the CPU
    for a leaf that is not a tensor), after a check that the keys match;
    without, a flat {key: tensor} dict on the CPU."""
    with open(os.path.join(path, "manifest.msgpack"), "rb") as f:
        manifest = msgpack.unpackb(f.read())
    keys, dtypes = manifest["keys"], manifest["dtypes"]
    with np.load(os.path.join(path, "arrays.npz")) as data:
        arrays = [data[f"a{i}"] for i in range(len(keys))]
    if template is None:
        return manifest["step"], {k: _to_tensor(a, d) for k, a, d in
                                  zip(keys, arrays, dtypes)}, manifest["meta"]
    flat = _flatten(template)
    if [k for k, _ in flat] != keys:
        raise ValueError(f"checkpoint/template key mismatch: "
                         f"{set(k for k, _ in flat) ^ set(keys)}")
    leaves = iter([_to_tensor(a, d, like) for a, d, (_, like) in
                   zip(arrays, dtypes, flat)])
    return manifest["step"], _unflatten(template, leaves), manifest["meta"]


def list_checkpoints(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return []
    steps = []
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d+)", name)
        if m:
            steps.append((int(m.group(1)), os.path.join(ckpt_dir, name)))
    return sorted(steps)


def restore_latest(ckpt_dir: str, template: Any = None):
    ckpts = list_checkpoints(ckpt_dir)
    if not ckpts:
        return None
    return restore(ckpts[-1][1], template)


def retain(ckpt_dir: str, keep: int = 3):
    for _, path in list_checkpoints(ckpt_dir)[:-keep]:
        shutil.rmtree(path, ignore_errors=True)


def _snapshot(tree):
    """A host copy of every tensor leaf of ``tree`` (a copy also of a CPU
    tensor: the training step updates its tensors in place)."""
    flat = _flatten(tree)
    leaves = iter([v.detach().to("cpu", copy=True)
                   if isinstance(v, torch.Tensor) else v for _, v in flat])
    return _unflatten(tree, leaves)


class AsyncCheckpointer:
    """Overlaps checkpoint I/O with training (one save in flight).  The
    tree is copied to the host before the writer thread starts."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, tree: Any, meta: Optional[dict] = None):
        self.wait()
        host_tree = _snapshot(tree)

        def run():
            try:
                save(self.ckpt_dir, step, host_tree, meta)
                retain(self.ckpt_dir, self.keep)
            except Exception as e:     # raised again by wait()
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self):
        """Join the save in flight; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
