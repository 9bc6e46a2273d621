"""The attention-free Mamba-2 stack (mamba2-2.7b): pre-norm RMSNorm, one
SSD mixer a layer (no MLP), an untied lm head.

The benchmark's layout, every layer's leaf stacked on a leading layer
axis: ``embed`` [V, d]; ``norm`` [L, d] f32; ``w_z`` / ``w_x`` [L, d,
d_in], ``w_B`` / ``w_C`` [L, d, N], ``w_dt`` [L, d, H]; the depthwise
causal convolutions ``conv_x`` [L, d_in, W] with ``conv_x_b`` [L, d_in]
and ``conv_bc`` [L, 2N, W] with ``conv_bc_b`` [L, 2N] (tap W - 1
multiplies the current token); ``A_log``, ``dt_bias``, ``D`` [L, H] f32;
``gate_norm`` [L, d_in] f32; ``w_out`` [L, d_in, d]; ``final_norm`` [d]
f32; ``lm_head`` [d, V]; the Medusa heads as in the dense family.
Matrices are stored [in, out], in the served dtype."""
from __future__ import annotations

import math

import torch

from perfbench.families import sub_seed

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def dims(cfg: dict):
    """(L, d, d_in, N, H, P, W, V) of a configuration."""
    d = cfg["d_model"]
    d_in = cfg["ssm_expand"] * d
    P = cfg["ssm_head_dim"]
    return (cfg["num_layers"], d, d_in, cfg["ssm_state"], d_in // P, P,
            cfg["ssm_conv"], cfg["vocab_size"])


def draw(cfg: dict, seed: int, device) -> dict:
    """The weights, drawn on ``device`` from ``seed`` in a few large calls
    in the served dtype: N(0, 1 / fan-in) matrices and convolutions, small
    biases, dt's bias the inverse softplus of a dt log-uniform in [1e-3,
    1e-1], A = -exp(A_log) in [-16, -1), D and the gains uniform, and the
    heads of Medusa's recipe."""
    L, d, d_in, N, H, P, W, V = dims(cfg)
    K = cfg["serving"]["medusa_heads"]
    dt = DTYPES[cfg["dtype"]]
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, "weights"))
    f32 = dict(device=device, dtype=torch.float32)

    def normal(shape, scale, dtype=dt):
        w = torch.randn(shape, generator=g, device=device, dtype=dtype)
        return w.mul_(scale)

    def uniform(shape, lo, hi):
        return torch.empty(shape, **f32).uniform_(lo, hi, generator=g)

    dt0 = torch.exp(uniform((L, H), math.log(1e-3), math.log(1e-1)))
    w = {
        "embed": normal((V, d), 0.02),
        "norm": uniform((L, d), 0.8, 1.2),
        "w_z": normal((L, d, d_in), d ** -0.5),
        "w_x": normal((L, d, d_in), d ** -0.5),
        "w_B": normal((L, d, N), d ** -0.5),
        "w_C": normal((L, d, N), d ** -0.5),
        "w_dt": normal((L, d, H), d ** -0.5),
        "conv_x": normal((L, d_in, W), W ** -0.5),
        "conv_x_b": normal((L, d_in), 0.1),
        "conv_bc": normal((L, 2 * N, W), W ** -0.5),
        "conv_bc_b": normal((L, 2 * N), 0.1),
        "A_log": torch.log(uniform((L, H), 1.0, 16.0)),
        "dt_bias": dt0 + torch.log(-torch.expm1(-dt0)),
        "D": uniform((L, H), 0.5, 1.5),
        "gate_norm": uniform((L, d_in), 0.8, 1.2),
        "w_out": normal((L, d_in, d), d_in ** -0.5),
        "final_norm": uniform((d,), 0.8, 1.2),
        "lm_head": normal((d, V), d ** -0.5),
    }
    w["heads_w1"] = torch.zeros((K, d, d), dtype=dt, device=device)
    w["heads_b1"] = torch.zeros((K, d), dtype=dt, device=device)
    w["heads_lm"] = w["lm_head"][None].expand(K, d, V).clone()
    return w


def port_config(cfg: dict):
    """The port's ``ModelConfig`` for this configuration, as it is run."""
    from repro_torch.configs.base import ModelConfig
    sv = cfg["serving"]
    return ModelConfig(
        name=cfg["name"], family="ssm", num_layers=cfg["num_layers"],
        d_model=cfg["d_model"], num_heads=0, num_kv_heads=0, d_ff=0,
        vocab_size=cfg["vocab_size"], ssm_state=cfg["ssm_state"],
        ssm_head_dim=cfg["ssm_head_dim"], ssm_conv=cfg["ssm_conv"],
        ssm_expand=cfg["ssm_expand"], ssm_chunk=cfg["ssm_chunk"],
        norm=cfg["norm"], tie_embeddings=cfg["tie_embeddings"],
        spec_mode="chain", full_attention=False, dtype=cfg["dtype"],
        param_dtype=cfg["dtype"], cache_layout=sv["cache_layout"],
        verify_fusion=sv["verify_fusion"], source=cfg["source"])


def to_port(cfg: dict, w: dict):
    """(port config, params, Medusa heads): the port's tree over ``w``'s
    tensors, renamed."""
    params = {
        "embed": w["embed"],
        "units": {"pos0": {
            "norm1": {"w": w["norm"]},
            "ssm": {"wz": w["w_z"], "wx": w["w_x"], "wB": w["w_B"],
                    "wC": w["w_C"], "wdt": w["w_dt"],
                    "conv_x": w["conv_x"], "conv_x_b": w["conv_x_b"],
                    "conv_bc": w["conv_bc"], "conv_bc_b": w["conv_bc_b"],
                    "A_log": w["A_log"], "dt_bias": w["dt_bias"],
                    "D": w["D"], "norm_w": w["gate_norm"],
                    "out_proj": w["w_out"]},
        }},
        "final_norm": {"w": w["final_norm"]},
        "lm_head": w["lm_head"],
    }
    heads = {"w1": w["heads_w1"], "b1": w["heads_b1"], "lm": w["heads_lm"]}
    return port_config(cfg), params, heads


def _layer_params(cfg: dict) -> int:
    L, d, d_in, N, H, P, W, V = dims(cfg)
    return 2 * d * d_in + 2 * d * N + d * H + d_in * d


def weight_bytes(cfg: dict) -> int:
    """Bytes of every matrix a step reads once: the layers' projections
    and convolutions, the lm head and the K heads."""
    L, d, d_in, N, H, P, W, V = dims(cfg)
    K = cfg["serving"]["medusa_heads"]
    el = DTYPES[cfg["dtype"]].itemsize
    conv = (d_in + 2 * N) * (W + 1)
    return el * (L * (_layer_params(cfg) + conv) + d * V
                 + K * (d * d + d * V))


def state_bytes(cfg: dict) -> int:
    """One slot's recurrent state over every layer: the SSD state in f32
    and the convolutions' last W - 1 inputs in the served dtype."""
    L, d, d_in, N, H, P, W, V = dims(cfg)
    el = DTYPES[cfg["dtype"]].itemsize
    return L * (4 * H * P * N + el * (d_in + 2 * N) * (W - 1))


def _token_flops(cfg: dict) -> int:
    """Operations of one token through every layer and the unembedding:
    the projections, the convolutions, and the recurrence's state update
    and read-out (4 a state entry)."""
    L, d, d_in, N, H, P, W, V = dims(cfg)
    conv = 2 * (d_in + 2 * N) * W
    return L * (2 * _layer_params(cfg) + conv + 4 * H * P * N) + 2 * d * V


def step_cost(cfg: dict, T: int, ctx) -> tuple:
    """(flops, bytes) a chain step needs at least for the active slots
    (``ctx``: one entry a slot; the recurrence does not read them): T
    tokens a slot through every layer and the verify unembedding, the
    heads on each slot's last row; the weights read once, each active
    slot's state read once and written once."""
    K = cfg["serving"]["medusa_heads"]
    d, V = cfg["d_model"], cfg["vocab_size"]
    n = len(ctx)
    flops = n * T * _token_flops(cfg) + 2 * n * K * (d * d + d * V)
    return flops, weight_bytes(cfg) + 2 * n * state_bytes(cfg)


def prefill_cost(cfg: dict, prompts) -> tuple:
    """(flops, bytes) one prefill call needs at least: every prompt token
    through every layer (the recurrent form's operations), the
    unembedding and the heads on each prompt's last row; the weights read
    once and each prompt's final state written once."""
    K = cfg["serving"]["medusa_heads"]
    d, V = cfg["d_model"], cfg["vocab_size"]
    n = len(prompts)
    flops = (sum(prompts) * (_token_flops(cfg) - 2 * d * V)
             + 2 * n * (d * V + K * (d * d + d * V)))
    return flops, weight_bytes(cfg) + n * state_bytes(cfg)


def k2_cost(cfg: dict, rows: int) -> tuple:
    """(flops, bytes) of one verify-epilogue launch (K2): as the dense
    family's."""
    d, V = cfg["d_model"], cfg["vocab_size"]
    el = DTYPES[cfg["dtype"]].itemsize
    return 2 * rows * d * V, el * (d * V + rows * d)
