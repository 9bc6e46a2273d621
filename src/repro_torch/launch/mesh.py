"""Mesh descriptions for the dry-run planner (counterpart of
``repro.launch.mesh``).

A ``Mesh`` names its axes and their sizes; it holds no device and no
process group.  The planner reads only
``mesh.shape`` (a dict of axis sizes, as JAX's ``Mesh.shape`` is), to
place a leaf by its spec and to size a rank's slice.  The reference's
``mesh_axis_types_kwargs`` is a JAX version shim and has no counterpart.
"""
from __future__ import annotations

from typing import NamedTuple


class Mesh(NamedTuple):
    axis_names: tuple
    sizes: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16 x 16 ("data", "model"), or 2 x 16 x 16 ("pod", "data", "model")."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_dev_mesh(model: int = 1, data: int = 1) -> Mesh:
    """A small ("data", "model") mesh."""
    return Mesh(("data", "model"), (data, model))
