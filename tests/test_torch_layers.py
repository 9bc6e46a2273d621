"""The PyTorch port's layers and dense decoder against the JAX reference on
reduced openPangu-7B (4 layers, d 64, vocab 256, float32), on the CPU.

The same inputs, made with numpy from a seed, and the same weights
(carried across leaf by leaf with ``repro_torch.bridge``) go through both
packages.  Tolerance: atol 3e-5, the reference kernel tests' float32 bound
(sums are taken in another order by the two frameworks), with
``np.allclose``'s default rtol 1e-5 for the larger cache and hidden
values."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.distributed.sharding import split_params
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.models.api import get_model as jax_get_model
from repro_torch import bridge
from repro_torch.configs.registry import get_config
from repro_torch.models import layers as L
from repro_torch.models import transformer as TT
from repro_torch.models.api import get_model

ATOL, RTOL = 3e-5, 1e-5
B, S_P, S_MAX = 2, 8, 128


@pytest.fixture
def rng():
    """Each test's inputs from its own seed, whatever ran before it (the
    shared fixture is one generator for the whole session)."""
    return np.random.default_rng(0)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=atol,
                               rtol=RTOL)


@pytest.fixture(scope="module")
def stack():
    # one layer: the layer-level tolerance holds per layer; through the
    # four-layer stack the differences compound, and the whole stack is
    # held to token equality in test_torch_engine.py instead
    cfg = dataclasses.replace(jax_get_config("openpangu-7b", reduced=True),
                              num_layers=1)
    params, _ = split_params(
        jax_get_model(cfg).init_params(jax.random.PRNGKey(1), cfg))
    tparams = bridge.to_torch(jax.tree.map(np.asarray, params), device="cpu")
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, cfg.vocab_size, size=(B, S_P)).astype(np.int32)
    lengths = np.array([S_P, 5], np.int32)
    return cfg, params, tparams, tokens, lengths


def _unit0(params):
    return jax.tree.map(lambda x: x[0], params["units"]["pos0"])


def test_config_matches_reference():
    for reduced in (False, True):
        assert dataclasses.asdict(get_config("openpangu-7b", reduced)) == \
            dataclasses.asdict(jax_get_config("openpangu-7b", reduced))


def test_unsupported_branches_raise():
    cfg = get_config("openpangu-7b", reduced=True)
    # tensor parallelism is carried for the dense family and refused for
    # the others, whose mixers are not head-sharded
    from repro_torch.models import transformer
    assert get_model(dataclasses.replace(cfg, tp_axis="model")) \
        is transformer
    with pytest.raises(ValueError, match="dense family"):
        get_model(dataclasses.replace(cfg, family="moe", num_experts=4,
                                      tp_axis="model"))
    # the SSM and hybrid families are carried, and the encoder-decoder
    for change in ({"family": "ssm"}, {"family": "hybrid"}):
        get_model(dataclasses.replace(cfg, **change))
    from repro_torch.models import encdec
    assert get_model(dataclasses.replace(cfg, family="encdec")) is encdec


def test_rms_norm_and_rope(rng):
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    w = rng.standard_normal((16,)).astype(np.float32)
    _close(L.rms_norm(_t(x), _t(w)), JL.rms_norm(jnp.asarray(x), jnp.asarray(w)))
    pos = rng.integers(0, 4000, size=(2, 5)).astype(np.int32)
    cos, sin = L.rope_cos_sin(_t(pos), 16, 10000.0)
    jcos, jsin = JL.rope_cos_sin(jnp.asarray(pos), 16, 10000.0)
    _close(cos, jcos)
    _close(sin, jsin)
    _close(L.apply_rope(_t(x), cos[:, :, None], sin[:, :, None]),
           JL.apply_rope(jnp.asarray(x), jcos[:, :, None], jsin[:, :, None]))


def test_attention_full_and_mlp(stack, rng):
    cfg, params, tparams, _, _ = stack
    x = rng.standard_normal((B, S_P, cfg.d_model)).astype(np.float32)
    p, tp = _unit0(params), TT.unit_params(tparams, 0)["pos0"]
    y, (k, v) = L.attention_full(tp["attn"], _t(x), cfg, return_kv=True)
    jy, (jk, jv) = JL.attention_full(p["attn"], jnp.asarray(x), cfg,
                                     return_kv=True)
    for a, b in ((k, jk), (v, jv)):
        _close(a, b)
    # The reference's init scales wo by 1/sqrt(Hq) (its fan-in is the first
    # axis), so the output reaches |y| ~ 34 here, and an element near 0 is
    # the difference of terms that large: the JAX float32 output is itself
    # up to 3.3e-5 from the float64 answer.  The output is held to ATOL
    # measured in units of its own largest magnitude.
    scale = max(1.0, float(np.abs(np.asarray(jy)).max()))
    _close(y / scale, np.asarray(jy) / scale)
    _close(L.mlp(tp["ffn"], _t(x), cfg), JL.mlp(p["ffn"], jnp.asarray(x), cfg))


def test_blockwise_causal_matches_full_mask(rng):
    q = _t(rng.standard_normal((1, 32, 4, 8)).astype(np.float32))
    k = _t(rng.standard_normal((1, 32, 2, 8)).astype(np.float32))
    v = _t(rng.standard_normal((1, 32, 2, 8)).astype(np.float32))
    idx = torch.arange(32)
    full = L._gqa_scores_to_out(q, k, v, (idx[None] <= idx[:, None])[None], 0.3)
    jout = JL._blockwise_causal(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
                                jnp.asarray(v.numpy()), 0.3, block=8)
    _close(L._blockwise_causal(q, k, v, 0.3, block=8), jout)
    _close(full, jout)


def test_decode_mask_matches_reference():
    from repro.core.tree import medusa_63
    tb = medusa_63()
    mask = torch.from_numpy(tb.mask)
    lengths = torch.tensor([0, 5, 100, 190], dtype=torch.int32)
    got = L.decode_mask(mask, lengths, tb.T, 200)
    for b, n in enumerate(lengths.tolist()):
        ref = np.asarray(JL.decode_mask(jnp.asarray(tb.mask), n, tb.T, 200))
        np.testing.assert_array_equal(got[b].numpy(), ref)
        np.testing.assert_array_equal(
            L.decode_mask(mask, lengths[b], tb.T, 200).numpy(), ref)


def test_update_rows_drops_rows_past_the_end(rng):
    cache = rng.standard_normal((3, 16, 2, 4)).astype(np.float32)
    rows = rng.standard_normal((3, 5, 2, 4)).astype(np.float32)
    starts = np.array([0, 9, 14], np.int32)       # the last row overruns S
    got = _t(cache)
    TT._update_rows(got, _t(rows), _t(starts))
    ref = JT._update_rows(jnp.asarray(cache), jnp.asarray(rows),
                          jnp.asarray(starts))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("use_kernel", [False, True])
def test_prefill_decode_commit_match_reference(stack, use_kernel):
    from repro.core.tree import medusa_63
    cfg, params, tparams, tokens, lengths = stack
    jm, tm = jax_get_model(cfg), get_model(cfg)
    tb = medusa_63()
    jcache = jm.init_cache(cfg, B, S_MAX)
    tcache = tm.init_cache(cfg, B, S_MAX, device="cpu")
    jlast, jcache = jm.prefill(params, cfg, jnp.asarray(tokens),
                               jnp.asarray(lengths), jcache)
    tlast, tcache = tm.prefill(tparams, cfg, _t(tokens), _t(lengths), tcache)
    _close(tlast, jlast)
    for name in ("k", "v"):
        _close(tcache["pos0"][name], jcache["pos0"][name])

    cand = np.random.default_rng(3).integers(0, cfg.vocab_size,
                                             size=(B, tb.T)).astype(np.int32)
    jh, jspec = jm.decode(params, cfg, jcache, jnp.asarray(cand),
                          jnp.asarray(lengths), jnp.asarray(tb.mask),
                          jnp.asarray(tb.depths), use_kernel=use_kernel)
    th, tspec = tm.decode(tparams, cfg, tcache, _t(cand), _t(lengths),
                          torch.from_numpy(tb.mask),
                          torch.from_numpy(tb.depths), use_kernel=use_kernel)
    _close(th, jh)
    for name in ("k", "v"):
        _close(tspec["pos0"][name], jspec["pos0"][name])
    # decode hands commit each unit's in-flight rows unstacked, where its
    # layer left them; stacked, they are the reference's
    for name in ("k_new", "v_new"):
        rows = tspec["pos0"][name]
        assert isinstance(rows, tuple) and len(rows) == cfg.num_layers
        _close(torch.stack(rows), jspec["pos0"][name])
    _close(tm.unembed(tparams, cfg, th), jm.unembed(params, cfg, jh))

    path = np.stack([tb.retrieve[3], tb.retrieve[0]]).astype(np.int32)
    acc = np.array([2, 4], np.int32)
    jc, jlen = jm.commit(cfg, jspec, jnp.asarray(lengths), jnp.asarray(path),
                         jnp.asarray(acc))
    tc, tlen = tm.commit(cfg, tspec, _t(lengths), _t(path), _t(acc))
    np.testing.assert_array_equal(tlen.numpy(), np.asarray(jlen))
    for name in ("k", "v"):
        _close(tc["pos0"][name], jc["pos0"][name])
