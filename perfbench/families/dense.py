"""The dense decoder (openPangu-7B): pre-norm RMSNorm, GQA attention with
half-rotation RoPE, a SwiGLU MLP, an untied lm head.

The benchmark's layout, every layer's leaf stacked on a leading layer
axis: ``embed`` [V, d]; ``attn_norm`` / ``mlp_norm`` [L, d] f32; ``wq``
[L, d, Hq * hd], ``wk`` / ``wv`` [L, d, Hkv * hd], ``wo`` [L, Hq * hd,
d]; ``w_gate`` / ``w_up`` [L, d, f], ``w_down`` [L, f, d];
``final_norm`` [d] f32; ``lm_head`` [d, V]; and the Medusa heads
``heads_w1`` [K, d, d], ``heads_b1`` [K, d], ``heads_lm`` [K, d, V].
Matrices are stored [in, out], in the served dtype."""
from __future__ import annotations

import torch

from perfbench.families import sub_seed

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def dims(cfg: dict):
    """(L, d, Hq, Hkv, hd, f, V) of a configuration."""
    return (cfg["num_layers"], cfg["d_model"], cfg["num_heads"],
            cfg["num_kv_heads"], cfg["head_dim"], cfg["d_ff"],
            cfg["vocab_size"])


def draw(cfg: dict, seed: int, device) -> dict:
    """The weights, drawn on ``device`` from ``seed`` in a few large calls
    in the served dtype: N(0, 1 / fan-in) matrices, the embedding at
    0.02, norm gains uniform in [0.8, 1.2], and the heads of Medusa's
    recipe (the lm head copied, a zero residual block)."""
    L, d, hq, hkv, hd, f, V = dims(cfg)
    K = cfg["serving"]["medusa_heads"]
    dt = DTYPES[cfg["dtype"]]
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, "weights"))

    def normal(shape, scale):
        w = torch.randn(shape, generator=g, device=device, dtype=dt)
        return w.mul_(scale)

    def gain(shape):
        return torch.empty(shape, device=device,
                           dtype=torch.float32).uniform_(0.8, 1.2,
                                                         generator=g)

    w = {
        "embed": normal((V, d), 0.02),
        "attn_norm": gain((L, d)),
        "wq": normal((L, d, hq * hd), d ** -0.5),
        "wk": normal((L, d, hkv * hd), d ** -0.5),
        "wv": normal((L, d, hkv * hd), d ** -0.5),
        "wo": normal((L, hq * hd, d), (hq * hd) ** -0.5),
        "mlp_norm": gain((L, d)),
        "w_gate": normal((L, d, f), d ** -0.5),
        "w_up": normal((L, d, f), d ** -0.5),
        "w_down": normal((L, f, d), f ** -0.5),
        "final_norm": gain((d,)),
        "lm_head": normal((d, V), d ** -0.5),
    }
    w["heads_w1"] = torch.zeros((K, d, d), dtype=dt, device=device)
    w["heads_b1"] = torch.zeros((K, d), dtype=dt, device=device)
    w["heads_lm"] = w["lm_head"][None].expand(K, d, V).clone()
    return w


def port_config(cfg: dict):
    """The port's ``ModelConfig`` for this configuration, as it is run."""
    from repro_torch.configs.base import ModelConfig
    L, d, hq, hkv, hd, f, V = dims(cfg)
    sv = cfg["serving"]
    return ModelConfig(
        name=cfg["name"], family="dense", num_layers=L, d_model=d,
        num_heads=hq, num_kv_heads=hkv, head_dim=hd, d_ff=f, vocab_size=V,
        act=cfg["act"], norm=cfg["norm"], gated_mlp=cfg["gated_mlp"],
        rope_theta=cfg["rope_theta"], tie_embeddings=cfg["tie_embeddings"],
        spec_mode="tree", dtype=cfg["dtype"], param_dtype=cfg["dtype"],
        cache_layout=sv["cache_layout"],
        page_size=sv.get("page_size", 64),
        verify_fusion=sv["verify_fusion"], source=cfg["source"])


def to_port(cfg: dict, w: dict):
    """(port config, params, Medusa heads): the port's tree over views of
    ``w`` (no copy: ``wq`` [L, d, Hq * hd] is the port's [L, d, Hq, hd])."""
    L, d, hq, hkv, hd, f, V = dims(cfg)
    params = {
        "embed": w["embed"],
        "units": {"pos0": {
            "norm1": {"w": w["attn_norm"]},
            "attn": {"wq": w["wq"].view(L, d, hq, hd),
                     "wk": w["wk"].view(L, d, hkv, hd),
                     "wv": w["wv"].view(L, d, hkv, hd),
                     "wo": w["wo"].view(L, hq, hd, d)},
            "norm2": {"w": w["mlp_norm"]},
            "ffn": {"wi": w["w_up"], "wg": w["w_gate"], "wo": w["w_down"]},
        }},
        "final_norm": {"w": w["final_norm"]},
        "lm_head": w["lm_head"],
    }
    heads = {"w1": w["heads_w1"], "b1": w["heads_b1"], "lm": w["heads_lm"]}
    return port_config(cfg), params, heads


def _layer_params(cfg: dict) -> int:
    L, d, hq, hkv, hd, f, V = dims(cfg)
    return d * (hq + 2 * hkv) * hd + hq * hd * d + 3 * d * f


def weight_bytes(cfg: dict) -> int:
    """Bytes of every matrix a serve step reads once: the layers, the lm
    head and the K heads (the embedding is gathered by rows)."""
    L, d, hq, hkv, hd, f, V = dims(cfg)
    K = cfg["serving"]["medusa_heads"]
    el = DTYPES[cfg["dtype"]].itemsize
    return el * (L * _layer_params(cfg) + d * V + K * (d * d + d * V))


def kv_bytes_per_row(cfg: dict) -> int:
    """Cache bytes of one token over every layer (k and v)."""
    L, d, hq, hkv, hd, f, V = dims(cfg)
    return L * 2 * hkv * hd * DTYPES[cfg["dtype"]].itemsize


def step_cost(cfg: dict, T: int, ctx) -> tuple:
    """(flops, bytes) a serve step needs at least, for the active slots
    whose committed rows are ``ctx`` (one entry a slot), each verifying T
    tree rows: the backbone and the verify unembedding over the T rows,
    attention of the T rows over the committed ones, the heads over each
    slot's last row; the weights read once, the committed rows read
    once, the tree rows written once."""
    L, d, hq, hkv, hd, f, V = dims(cfg)
    K = cfg["serving"]["medusa_heads"]
    n = len(ctx)
    rows = n * T
    flops = (2 * rows * (L * _layer_params(cfg) + d * V)
             + 4 * T * hq * hd * L * sum(ctx)
             + 2 * n * K * (d * d + d * V))
    nbytes = (weight_bytes(cfg)
              + kv_bytes_per_row(cfg) * (sum(ctx) + rows))
    return flops, nbytes


def prefill_cost(cfg: dict, prompts) -> tuple:
    """(flops, bytes) one prefill call needs at least for prompts of the
    lengths ``prompts``: the backbone over every prompt token, causal
    attention (p^2 / 2 query-key pairs a head), the unembedding and the
    heads on each prompt's last row; the weights read once and the
    prompts' cache rows written once."""
    L, d, hq, hkv, hd, f, V = dims(cfg)
    K = cfg["serving"]["medusa_heads"]
    P, n = sum(prompts), len(prompts)
    flops = (2 * P * L * _layer_params(cfg)
             + 2 * hq * hd * L * sum(p * p for p in prompts)
             + 2 * n * (d * V + K * (d * d + d * V)))
    nbytes = weight_bytes(cfg) + kv_bytes_per_row(cfg) * P
    return flops, nbytes


def k2_cost(cfg: dict, rows: int) -> tuple:
    """(flops, bytes) of one verify-epilogue launch (K2) over ``rows``
    hidden rows: the [rows, V] product, the lm head read once, the rows
    read once (the per-row statistics it writes are a few bytes)."""
    L, d, hq, hkv, hd, f, V = dims(cfg)
    el = DTYPES[cfg["dtype"]].itemsize
    return 2 * rows * d * V, el * (d * V + rows * d)


def k3_cost(cfg: dict, rows: int) -> tuple:
    """(flops, bytes) of one fused qkv + RoPE + cache-write launch (K3)
    over ``rows`` rows of one layer: the [rows, (Hq + 2 Hkv) hd] product,
    Wq/Wk/Wv read once, the rows read once, q and the k/v rows written
    once (RoPE's few operations a value are not counted)."""
    L, d, hq, hkv, hd, f, V = dims(cfg)
    el = DTYPES[cfg["dtype"]].itemsize
    n_out = (hq + 2 * hkv) * hd
    return (2 * rows * d * n_out,
            el * (d * n_out + rows * d + rows * n_out))
