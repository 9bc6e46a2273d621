"""Architecture registry: ``--arch <id>`` resolution for the port's
launcher.  The first slice lists the paper's own model only."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig

# arch id -> module
_MODULES = {
    "openpangu-7b": "repro_torch.configs.openpangu_7b",
}

ALL_ARCHS = list(_MODULES)


def get_config(arch: str, reduced: bool = False) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(_MODULES[arch])
    return mod.REDUCED if reduced else mod.CONFIG
