"""The plain references against the port, on the port's REDUCED
configurations and the benchmark's own seeded weights (float32, CPU).

Tolerance: 1e-4 on logits of magnitude ~5.  Both sides compute in
float32 from the same weights; they differ only in the order of their
sums (the port's einsums against the reference's per-sequence products,
its chunked SSD against the reference's chunks), which leaves gaps of a
few 1e-6; a wrong rotation, grouping, gate, convolution tap or decay
moves logits by 1e-2 or more."""

import pytest
import torch

from perfbench.families import family
from perfbench.reference import forward
from perfbench.tests.conftest import reduced

TOL = 1e-4


@pytest.mark.parametrize("name", ["openpangu-7b", "mamba2-2.7b"])
def test_reduced_config_is_the_ports(name):
    from repro_torch.configs.registry import get_config
    cfg = reduced(name)
    ours = family(cfg["family"]).port_config(cfg)
    theirs = get_config(name, reduced=True)
    shared = ("num_layers", "d_model", "vocab_size", "family", "spec_mode",
              "norm", "tie_embeddings", "dtype")
    own = {"dense": ("num_heads", "num_kv_heads", "resolved_head_dim",
                     "d_ff", "act", "rope_theta", "gated_mlp"),
           "ssm": ("ssm_state", "ssm_head_dim", "ssm_conv", "ssm_expand",
                   "ssm_chunk", "d_inner", "ssm_heads")}[cfg["family"]]
    for f in shared + own:
        assert getattr(ours, f) == getattr(theirs, f), f


@pytest.mark.parametrize("name", ["openpangu-7b", "mamba2-2.7b"])
def test_reference_matches_the_port(name):
    from repro_torch.models.api import get_model
    cfg = reduced(name)
    fam = family(cfg["family"])
    w = fam.draw(cfg, 2**33 + 1, "cpu")
    pcfg, params, _ = fam.to_port(cfg, w)
    model = get_model(pcfg)
    g = torch.Generator().manual_seed(5)
    toks = torch.randint(0, cfg["vocab_size"], (2, 48), generator=g)
    with torch.no_grad():
        hidden, _ = model.forward_hidden(params, pcfg, toks)
        port = model.unembed(params, pcfg, hidden)
        seqs = [toks[0].tolist(), toks[1, :31].tolist()]
        ref = forward(cfg["family"])(w, cfg, seqs, [(0, 48), (4, 27)])
    assert port.abs().max() > 1.0
    assert (ref[0] - port[0]).abs().max() < TOL
    # a shorter sequence batched beside a longer one: causal, so its
    # rows are those of the port over its own tokens
    assert (ref[1] - port[1, 4:31]).abs().max() < TOL


@pytest.mark.parametrize("name", ["openpangu-7b", "mamba2-2.7b"])
def test_reference_sees_a_changed_weight(name):
    cfg = reduced(name)
    fam = family(cfg["family"])
    w = fam.draw(cfg, 9, "cpu")
    seqs, reads = [list(range(1, 40))], [(0, 39)]
    base = forward(cfg["family"])(w, cfg, seqs, reads)[0]
    key = "wk" if "wk" in w else "conv_x"
    w2 = dict(w, **{key: w[key].clone()})
    w2[key][1] *= 1.1
    moved = forward(cfg["family"])(w2, cfg, seqs, reads)[0]
    assert (moved - base).abs().max() > 100 * TOL


@pytest.mark.parametrize("name", ["openpangu-7b", "mamba2-2.7b"])
def test_control_is_float8(name):
    cfg = reduced(name)
    w = family(cfg["family"]).draw(cfg, 11, "cpu")
    seqs, reads = [list(range(3, 60))], [(0, 57)]
    f32 = forward(cfg["family"])(w, cfg, seqs, reads, "f32")[0]
    f8 = forward(cfg["family"])(w, cfg, seqs, reads, "fp8")[0]
    err = (f8 - f32).abs().max()
    assert 1e-2 < err < 2.0
