"""Architecture registry: ``--arch <id>`` resolution for the port's
launchers.  It lists the reference registry's decoders that the port
carries: the paper's own model, the four other dense decoders, the two
mixture-of-experts models, the vision-language model (its modality
frontend a stub), the state-space model, the hybrid and the
encoder-decoder (its audio frontend a stub): every model of the
reference's registry.  ``iter_cells`` walks the planner's grid: the
assigned architectures (every one but the paper's own openPangu-7B)
against ``SHAPES``, 40 cells."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (SHAPES, ModelConfig, ShapeConfig,
                                      shape_applicable)

# arch id -> module
_MODULES = {
    "gemma-2b": "repro_torch.configs.gemma_2b",
    "granite-8b": "repro_torch.configs.granite_8b",
    "qwen1.5-4b": "repro_torch.configs.qwen15_4b",
    "qwen1.5-0.5b": "repro_torch.configs.qwen15_05b",
    "openpangu-7b": "repro_torch.configs.openpangu_7b",
    "granite-moe-1b-a400m": "repro_torch.configs.granite_moe_1b_a400m",
    "phi3.5-moe-42b-a6.6b": "repro_torch.configs.phi35_moe_42b_a66b",
    "internvl2-26b": "repro_torch.configs.internvl2_26b",
    "mamba2-2.7b": "repro_torch.configs.mamba2_27b",
    "jamba-1.5-large-398b": "repro_torch.configs.jamba_15_large_398b",
    "whisper-tiny": "repro_torch.configs.whisper_tiny",
}

# the planner's grid, in the reference registry's order
ASSIGNED_ARCHS = ["granite-moe-1b-a400m", "phi3.5-moe-42b-a6.6b",
                  "internvl2-26b", "whisper-tiny", "gemma-2b", "granite-8b",
                  "qwen1.5-4b", "qwen1.5-0.5b", "mamba2-2.7b",
                  "jamba-1.5-large-398b"]
ALL_ARCHS = list(_MODULES)


def get_config(arch: str, reduced: bool = False) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(_MODULES[arch])
    return mod.REDUCED if reduced else mod.CONFIG


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


def iter_cells(include_skipped: bool = False):
    """Yield (arch, shape, applicable, why) over the assigned 40-cell
    grid, in the reference's order."""
    for arch in ASSIGNED_ARCHS:
        cfg = get_config(arch)
        for shape in SHAPES.values():
            ok, why = shape_applicable(cfg, shape)
            if ok or include_skipped:
                yield arch, shape.name, ok, why
