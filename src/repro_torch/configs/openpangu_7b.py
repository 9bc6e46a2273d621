"""openPangu-Embedded-7B-V1.1 — the paper's subject model (Table 1).

Table 1 lists: dense, 7B non-embedding params, 34 layers, "Hidden Dimension
12,800", GQA 32Q/8KV, vocab 153k, 32k native context.  12,800 as *d_model*
with 34 layers is inconsistent with 7B (it would be ~67B); it is consistent
as the FFN dimension: 34 * (4*4096^2 + 3*4096*12800) ~= 7.0B.  We therefore
use d_model=4096, d_ff=12800 and record the inference here and in DESIGN.md.
"""
from repro_torch.configs.base import ModelConfig, reduce

CONFIG = ModelConfig(
    name="openpangu-7b",
    family="dense",
    num_layers=34,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=12800,
    vocab_size=153376,
    act="silu",
    spec_mode="tree",
    source="paper Table 1 (openPangu-Embedded-7B-V1.1); arXiv:2505.22375",
)

REDUCED = reduce(CONFIG)
