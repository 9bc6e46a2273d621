"""Random-weight init scales of the port against the reference's.

Every leaf is drawn at the reference's scale but the attention's
projections.  The reference's ``dense_init`` takes the fan-in of every
three-dimensional leaf from its middle axis (right for its stacked
experts [E, d, f], whose scale the port passes explicitly), so it draws
``wq`` [d, Hq, hd] at 1/sqrt(Hq), ``wk`` / ``wv`` at 1/sqrt(Hkv) and
``wo`` [Hq, hd, d] at 1/sqrt(hd).  The port draws the projections at
1/sqrt(d) and ``wo`` at 1/sqrt(Hq): at the reference's scale a
full-width random model is chaotic in bf16 (a half-ulp perturbation of
the embeddings moves openPangu-7B's logits by 3.2 after 4 layers,
``tests/init_scale_study.py``), and no bf16 comparison on the card can
hold it.  These tests keep that departure deliberate: both packages'
attention leaves are held to their own documented scales, every other
leaf to the reference's.

The random bits differ between the frameworks, so each leaf's standard
deviation is compared: ``|std / want - 1| <= 6 / sqrt(n)`` for a leaf of
n elements (a sample std has a relative error of about sqrt(1 / 2n), a
ratio of two about sqrt(1 / n): six of those), and a leaf the reference
draws constant (norms, biases, the Medusa heads' zero resblock) is
constant here too.

Cases: every architecture's reduced model, a draft model (the target's
two-layer sibling), the Medusa heads, whisper-tiny whole at full width
(the encoder-decoder's self- and cross-attention) and openPangu-7B's
attention at full width.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.core import medusa as JM
from repro.distributed.sharding import split_params
from repro.models import layers as JL
from repro.models.api import get_model as jax_get_model
from repro_torch.configs.registry import ALL_ARCHS, get_config
from repro_torch.core import medusa as M
from repro_torch.models import layers as L
from repro_torch.models.api import get_model


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _flat(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, path + (k,)))
        return out
    return {path: tree}


def _stds(tree):
    out = {}
    for path, x in _flat(tree).items():
        a = np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                       dtype=np.float64)
        out[path] = (float(a.std()), a.size)
    return out


ATTN = ("attn", "self_attn", "cross_attn")
PROJ = ("wq", "wk", "wv", "wo")


def _attn_scales(cfg):
    """{leaf: (the port's scale, the reference's scale)}."""
    d, hq = cfg.d_model, cfg.num_heads
    hkv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    return {"wq": (d, hq), "wk": (d, hkv), "wv": (d, hkv), "wo": (hq, hd)}


def _close(got, want, n):
    return abs(got / want - 1.0) <= 6.0 / np.sqrt(n)


def _check(port_tree, ref_tree, cfg):
    mine, ref = _stds(port_tree), _stds(ref_tree)
    assert mine.keys() == ref.keys()
    scales = _attn_scales(cfg)
    for path, (want, n) in ref.items():
        got = mine[path][0]
        # an attention leaf: a projection inside an attention entry, or
        # one of init_attention's own leaves
        if path[-1] in PROJ and (len(path) == 1
                                 or any(p in ATTN for p in path[:-1])):
            port_fan, ref_fan = scales[path[-1]]
            assert _close(got, 1 / np.sqrt(port_fan), n), (path, got)
            assert _close(want, 1 / np.sqrt(ref_fan), n), (path, want)
        elif want == 0.0:
            assert got == 0.0, path
        else:
            assert _close(got, want, n), (path, got, want)


def _ref_params(cfg, seed=0):
    vals, _ = split_params(jax_get_model(cfg).init_params(
        jax.random.PRNGKey(seed), cfg))
    return jax.tree.map(np.asarray, vals)


def _port_params(cfg, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return get_model(cfg).init_params(gen, cfg)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_reduced_leaves_match_reference_scale(arch):
    cfg = get_config(arch, reduced=True)
    _check(_port_params(cfg), _ref_params(jax_get_config(arch, reduced=True)),
           cfg)


def test_draft_model_and_medusa_heads_match_reference_scale():
    # the draft proposer's model: the target's two-layer sibling
    tcfg = dataclasses.replace(get_config("openpangu-7b", reduced=True),
                               num_layers=2)
    jcfg = dataclasses.replace(jax_get_config("openpangu-7b", reduced=True),
                               num_layers=2)
    _check(_port_params(tcfg, 1), _ref_params(jcfg, 1), tcfg)
    mp = M.init_medusa(torch.Generator().manual_seed(1), tcfg, 4)
    ref, _ = split_params(JM.init_medusa(jax.random.PRNGKey(1), jcfg, 4))
    _check(mp, jax.tree.map(np.asarray, ref), tcfg)


def test_whisper_full_width_matches_reference_scale():
    cfg = get_config("whisper-tiny")
    _check(_port_params(cfg), _ref_params(jax_get_config("whisper-tiny")),
           cfg)


def test_openpangu_full_width_attention_scales():
    tcfg, jcfg = get_config("openpangu-7b"), jax_get_config("openpangu-7b")
    mine = L.init_attention(torch.Generator().manual_seed(0), tcfg)
    ref, _ = split_params(JL.init_attention(jax.random.PRNGKey(0), jcfg))
    _check(mine, jax.tree.map(np.asarray, ref), tcfg)
    # the projections 11.3x (wq) and 22.6x (wk, wv) larger in the
    # reference, wo half
    d, hq, hkv = tcfg.d_model, tcfg.num_heads, tcfg.num_kv_heads
    ratio = {k: float(np.asarray(ref[k], np.float64).std()
                      / mine[k].double().std()) for k in PROJ}
    want = {"wq": np.sqrt(d / hq), "wk": np.sqrt(d / hkv),
            "wv": np.sqrt(d / hkv), "wo": 0.5}
    for k in PROJ:
        assert abs(ratio[k] / want[k] - 1) < 0.01, (k, ratio[k])
