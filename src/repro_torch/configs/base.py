"""Model configuration: the port's own copy of ``repro.configs.base``.

``ModelConfig`` keeps every field of the reference dataclass, with the same
names and defaults, so one architecture reads the same in both packages
and a test can compare the two field by field.  ``reduce`` derives the
CPU-test variant exactly as the reference does.  The port runs the dense
family only; ``models/api.get_model`` rejects the rest.
"""
from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int                 # query heads (0 for pure SSM)
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 => d_model // num_heads
    act: str = "silu"              # silu => SwiGLU, gelu => GeGLU
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    qkv_bias: bool = False
    gated_mlp: bool = True         # False => plain 2-matrix MLP (whisper)
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    use_rope: bool = True          # whisper uses learned positions instead
    # --- MoE ---
    num_experts: int = 0
    experts_per_tok: int = 0
    moe_every: int = 1             # MoE applied on layers with (idx % moe_every == moe_offset)
    moe_offset: int = 0
    capacity_factor: float = 1.25
    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0             # N (dstate); 0 => no ssm layers
    ssm_head_dim: int = 64         # P
    ssm_conv: int = 4              # causal conv kernel width
    ssm_expand: int = 2            # d_inner = expand * d_model
    ssm_chunk: int = 128           # SSD chunk length
    # --- hybrid (Jamba) ---
    hybrid_period: int = 0         # block length; attention at ``attn_index`` within block
    attn_index: int = 3
    # --- encoder-decoder ---
    encoder_layers: int = 0
    cross_attention: bool = False
    # --- modality frontend stub (vlm / audio) ---
    frontend: str = ""             # "" | "vit" | "conv_audio"
    frontend_len: int = 0          # number of precomputed prefix embeddings
    frontend_dim: int = 0          # raw embedding dim of the stub output (0 => d_model)
    # --- speculative decoding mode (DESIGN.md §4) ---
    spec_mode: str = "tree"        # tree | chain: chain-mode archs
                                   # (SSM/hybrid) verify single-path
                                   # candidates only, so they pair with the
                                   # chain proposers (draft/ngram) or a
                                   # chain_tree() Medusa — DESIGN.md §13
    # --- numerics ---
    dtype: str = "bfloat16"        # activation / inference weight dtype
    param_dtype: str = "float32"   # training master weight dtype
    cache_dtype: str = ""          # KV-cache storage dtype; "" => dtype;
                                   # "int8" => quantized layout (DESIGN.md §10)
    cache_layout: str = "dense"    # "dense" per-slot [B, max_len] rows, or
                                   # "paged": global block pool + per-slot
                                   # block tables (DESIGN.md §12)
    page_size: int = 64            # paged layout: logical rows per block
                                   # (TPU kernel wants a multiple of 8)
    verify_fusion: bool = False    # fold unembed + acceptance into the
                                   # decode kernel epilogue — no [B, T, V]
                                   # logits round-trip (DESIGN.md §15)
    tp_axis: str = ""              # tensor-parallel decode (DESIGN.md §18):
                                   # set only on the shard_map-local config
                                   # built by distributed/tp.py — the model
                                   # then holds per-shard head/ff/vocab
                                   # slices and psum/all_gathers over this
                                   # mesh axis at the row-parallel seams.
                                   # "" (default) traces no collective.
    max_position: int = 1 << 20    # rope table upper bound (lazy — computed per call)
    # --- attention flavour ---
    full_attention: bool = True    # False for ssm; hybrid is "not full" (sub-quadratic)
    # provenance
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def layer_kind(self, idx: int) -> str:
        """'attn' or 'ssm' for layer ``idx`` (mixer type)."""
        if self.family == "ssm":
            return "ssm"
        if self.family == "hybrid" and self.hybrid_period:
            return "attn" if (idx % self.hybrid_period) == self.attn_index else "ssm"
        return "attn"

    def ffn_kind(self, idx: int) -> str:
        """'moe' or 'dense' for layer ``idx`` (ffn type). 'none' for pure-ssm."""
        if self.family == "ssm":
            return "none"
        if self.num_experts and (idx % self.moe_every) == self.moe_offset:
            return "moe"
        return "dense"

    @property
    def num_attn_layers(self) -> int:
        return sum(1 for i in range(self.num_layers) if self.layer_kind(i) == "attn")

    @property
    def num_ssm_layers(self) -> int:
        return sum(1 for i in range(self.num_layers) if self.layer_kind(i) == "ssm")

    @property
    def is_subquadratic(self) -> bool:
        return self.family in ("ssm", "hybrid")

    @property
    def resolved_cache_dtype(self) -> str:
        """Storage dtype of the attention KV cache (DESIGN.md §10)."""
        return self.cache_dtype or self.dtype

    @property
    def paged(self) -> bool:
        """True if the attention cache uses the paged layout (DESIGN.md §12)."""
        if self.cache_layout not in ("dense", "paged"):
            raise ValueError(f"unknown cache_layout {self.cache_layout!r}")
        return self.cache_layout == "paged"

    def kv_cache_bytes_per_token(self) -> int:
        """Bytes of attention KV cache per committed token across all
        layers: k+v values plus, for int8, the per-head-per-row f32
        scales."""
        from repro_torch.kernels.quant import cache_bytes_per_token
        return self.num_attn_layers * cache_bytes_per_token(
            self.num_kv_heads, self.resolved_head_dim,
            self.resolved_cache_dtype)


def reduce(cfg: ModelConfig, **overrides) -> ModelConfig:
    """CPU smoke-test variant: tiny dims, same family structure."""
    small = dict(
        name=cfg.name + "-reduced",
        num_layers=min(cfg.num_layers, 4 if cfg.family != "hybrid" else cfg.hybrid_period),
        d_model=64,
        num_heads=4 if cfg.num_heads else 0,
        num_kv_heads=min(cfg.num_kv_heads, 2) if cfg.num_kv_heads else 0,
        head_dim=16 if cfg.num_heads else 0,
        d_ff=128,
        vocab_size=256,
        num_experts=min(cfg.num_experts, 4),
        experts_per_tok=min(cfg.experts_per_tok, 2),
        encoder_layers=min(cfg.encoder_layers, 2),
        frontend_len=min(cfg.frontend_len, 8) if cfg.frontend_len else 0,
        frontend_dim=32 if cfg.frontend_dim else 0,
        ssm_state=16 if cfg.ssm_state else 0,
        ssm_head_dim=16 if cfg.ssm_state else 64,
        ssm_chunk=8,
        hybrid_period=min(cfg.hybrid_period, 4) if cfg.hybrid_period else 0,
        attn_index=min(cfg.attn_index, 1),
        dtype="float32",
        param_dtype="float32",
    )
    # keep MQA configs MQA (kv=1)
    if cfg.num_kv_heads == 1:
        small["num_kv_heads"] = 1
    small.update(overrides)
    return replace(cfg, **small)
