"""Small versions of the benchmark's configurations and mixes, for the
CPU: every width cut, float32, the same families, serving settings and
code paths."""
import json
import pathlib

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]

# the port's REDUCED configs (``repro_torch.configs``), whose sizes
# ``test_reference.py`` holds these to
REDUCED = {
    "openpangu-7b": dict(num_layers=4, d_model=64, num_heads=4,
                         num_kv_heads=2, head_dim=16, d_ff=128,
                         vocab_size=256),
    "mamba2-2.7b": dict(num_layers=4, d_model=64, ssm_state=16,
                        ssm_head_dim=16, vocab_size=256, ssm_chunk=8),
}


def reduced(name: str) -> dict:
    cfg = json.loads((ROOT / "perfbench" / "configs"
                      / f"{name}.json").read_text())
    cfg.update(REDUCED[name], dtype="float32")
    return cfg


def small_mix() -> dict:
    mix = json.loads((ROOT / "perfbench" / "traffic"
                      / "chat-c8.json").read_text())
    mix.update(clients=4, prompt_tokens=[8, 40], new_tokens=[4, 16],
               max_len=160, prompt_buckets=[16, 32, 64], strata=16,
               check_tokens=40, check_requests=4)
    return mix


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)
