"""Architecture registry: ``--arch <id>`` resolution for the port's
launchers.  It lists the reference registry's decoders that the port
carries: the paper's own model, the four other dense decoders, the two
mixture-of-experts models, the vision-language model (its modality
frontend a stub), the state-space model, the hybrid and the
encoder-decoder (its audio frontend a stub): every model of the
reference's registry."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig

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

ALL_ARCHS = list(_MODULES)


def get_config(arch: str, reduced: bool = False) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(_MODULES[arch])
    return mod.REDUCED if reduced else mod.CONFIG
