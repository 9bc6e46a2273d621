"""An untied lm head laid out at a 16-byte row pitch, against the reference.

A [d, V] head whose V is not a multiple of 8 (granite-moe-1b-a400m's
49155, internvl2-26b's 92553, whisper-tiny's 51865) has rows TMA cannot
read; the port lays such a head out once, wherever it makes or moves one
(``init_params`` of both model modules, ``bridge.to_torch``, the
launcher's given weights, ``TPSpecEngine.shard_params``, a checkpoint's
restore), as the [:, :V] view of a zero-filled [d, ceil8(V)] allocation
(``kernels.tree_attention.pitch_lm_head``).  Held here on the CPU:

* ``init_params`` pitches the head of every untied registry config at a
  vocabulary of 259 and at the three real vocabularies (reduced widths),
  and the tree keeps the reference's names and shapes.
* ``bridge.to_torch`` pitches an ``lm_head`` leaf and nothing else;
  ``adamw_to_torch`` leaves the moments contiguous.
* Greedy Medusa tokens over the pitched head, unfused and fused, equal the
  live reference's on a reduced dense model and on whisper-tiny's
  encoder-decoder at V 259, the weights carried across by the bridge.
* One AdamW step (``lm_train_step``) keeps the head pitched, in place,
  and equal to the same step on a contiguous head.
* A checkpoint restores the head at its pitch; a TP rank's vocabulary
  slice is pitched anew (aligned start and pitch); the launcher pitches
  weights it is given.

The kernel over such a head runs only on the card
(``tests/test_torch_hopper.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.core import medusa as JM
from repro.core.engine import SpecEngine as JaxSpecEngine
from repro.core.engine import ar_generate as jax_ar_generate
from repro.core.tree import medusa_63 as jax_medusa_63
from repro.distributed.sharding import split_params
from repro.models import encdec as JE
from repro.models import frontends as JF
from repro.models.api import get_model as jax_get_model
from repro_torch import bridge
from repro_torch.configs.registry import ALL_ARCHS, get_config
from repro_torch.core import tree as TT
from repro_torch.core.engine import SpecEngine
from repro_torch.distributed import collectives as C
from repro_torch.distributed import tp as TP
from repro_torch.kernels import tree_attention as TA
from repro_torch.launch import serve
from repro_torch.models.api import get_model
from repro_torch.training import checkpoint as CK
from repro_torch.training import optimizer as O
from repro_torch.training import steps as ST

V259 = 259
B, S_P, MAX_NEW, S_MAX = 2, 8, 8, 96
TOL = 3e-5          # the training tests' float32 tolerance
UNTIED = [a for a in ALL_ARCHS if not get_config(a).tie_embeddings]
UNALIGNED = [a for a in ALL_ARCHS if get_config(a).vocab_size % 8]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module's torch work (the suite runs in
    several workers on a few cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _pitch(v):
    return -(-v // 8) * 8


def _check_pitched(w, d, v):
    """``w`` is the [d, V] view of a [d, ceil8(V)] allocation whose pad
    columns are zero and outside the view."""
    assert tuple(w.shape) == (d, v)
    assert w.stride() == (_pitch(v), 1) and w.storage_offset() == 0
    assert w.untyped_storage().nbytes() == d * _pitch(v) * w.element_size()
    full = w.as_strided((d, _pitch(v)), (_pitch(v), 1))
    assert not full[:, v:].any()
    assert TA.weight_layout(w) == "dv"


def _shapes(tree):
    return {k: _shapes(v) if isinstance(v, dict) else tuple(v.shape)
            for k, v in tree.items()}


def test_the_three_unaligned_vocabularies():
    assert {a: get_config(a).vocab_size for a in UNALIGNED} == {
        "granite-moe-1b-a400m": 49155, "internvl2-26b": 92553,
        "whisper-tiny": 51865}


@pytest.mark.parametrize("arch, v", [(a, V259) for a in UNTIED] + [
    (a, get_config(a).vocab_size) for a in UNALIGNED],
    ids=[f"{a}-{V259}" for a in UNTIED]
    + [f"{a}-{get_config(a).vocab_size}" for a in UNALIGNED])
def test_init_params_pitches_the_head(arch, v):
    """``init_params`` (reduced widths) gives a pitched head at an
    unaligned V, and at V 259 the tree keeps the reference's names and
    shapes (only the head's strides differ from a contiguous tree)."""
    cfg = dataclasses.replace(get_config(arch, reduced=True), vocab_size=v)
    params = get_model(cfg).init_params(torch.Generator().manual_seed(0),
                                        cfg)
    _check_pitched(params["lm_head"], cfg.d_model, v)
    w, layout = get_model(cfg).unembed_weight(params)
    assert w is params["lm_head"] and layout == "dv"
    assert TA.stats_operand(w)[0].data_ptr() == w.data_ptr()
    if v != V259:
        return
    jcfg = dataclasses.replace(jax_get_config(arch, reduced=True),
                               vocab_size=v)
    jparams, _ = split_params(jax.eval_shape(
        lambda k: jax_get_model(jcfg).init_params(k, jcfg),
        jax.random.PRNGKey(0)))
    assert _shapes(params) == _shapes(jparams)


def test_bridge_pitches_only_the_head():
    """``to_torch`` lays an ``lm_head`` leaf out at the pitch on its
    device, values unchanged; other leaves (the embedding, Medusa's
    ``lm``) stay contiguous; ``adamw_to_torch`` carries the moments'
    values."""
    rng = np.random.default_rng(0)
    tree = {"embed": rng.standard_normal((V259, 16)).astype(np.float32),
            "lm_head": rng.standard_normal((16, V259)).astype(np.float32),
            "heads": {"lm": rng.standard_normal((2, 16, V259))
                      .astype(np.float32)}}
    got = bridge.to_torch(tree, device="cpu")
    _check_pitched(got["lm_head"], 16, V259)
    np.testing.assert_array_equal(got["lm_head"].numpy(), tree["lm_head"])
    assert got["embed"].is_contiguous() and got["heads"]["lm"].is_contiguous()
    st = bridge.adamw_to_torch(np.asarray(3, np.int32), tree, tree,
                               device="cpu")
    for m in (st.mu, st.nu):
        np.testing.assert_array_equal(m["lm_head"].numpy(), tree["lm_head"])
        np.testing.assert_array_equal(m["embed"].numpy(), tree["embed"])
    assert int(st.step) == 3


def _medusa_tokens(tcfg, tparams, tmp, tokens, lengths, fused, frames=None):
    c = dataclasses.replace(tcfg, verify_fusion=fused)
    eng = SpecEngine(c, TT.medusa_63(), use_kernel=True, device="cpu")
    extra = {} if frames is None else {"extra_embeds": _t(frames)}
    out, n_out, _ = eng.generate(tparams, tmp, _t(tokens), _t(lengths),
                                 eng.init_cache(B, S_MAX), MAX_NEW, **extra)
    assert (n_out == MAX_NEW).all()
    return out.numpy()


@pytest.mark.parametrize("arch", ["openpangu-7b", "whisper-tiny"],
                         ids=["dense", "encdec"])
def test_greedy_medusa_over_a_pitched_head_equals_reference(arch):
    """Reduced ``arch`` at V 259: the reference's weights and Medusa heads
    through the bridge (the head pitched), greedy Medusa unfused and fused
    == the live reference's Medusa tokens == its AR."""
    jcfg = dataclasses.replace(jax_get_config(arch, reduced=True),
                               vocab_size=V259)
    tcfg = dataclasses.replace(get_config(arch, reduced=True),
                               vocab_size=V259)
    jm = jax_get_model(jcfg)
    params, _ = split_params(jm.init_params(jax.random.PRNGKey(1), jcfg))
    tb = jax_medusa_63()
    mp, _ = split_params(JM.init_medusa(jax.random.PRNGKey(2), jcfg, tb.K,
                                        base_lm_head=params["lm_head"]))
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, V259, size=(B, S_P)).astype(np.int32)
    lengths = np.array([S_P, 6], np.int32)
    frames, extra = None, {}
    if jcfg.family == "encdec":
        frames = np.asarray(JF.frontend_embeds(jcfg, B,
                                               key=jax.random.PRNGKey(3)))
        extra = {"extra_embeds": jnp.asarray(frames)}
    cache = (JE.init_cache if jcfg.family == "encdec"
             else jm.init_cache)(jcfg, B, S_MAX)
    jout, _, _ = JaxSpecEngine(jcfg, tb).generate(
        params, mp, jnp.asarray(tokens), jnp.asarray(lengths), cache,
        MAX_NEW, **extra)
    jar, _ = jax_ar_generate(jcfg, params, jnp.asarray(tokens),
                             jnp.asarray(lengths), cache, MAX_NEW, **extra)
    np.testing.assert_array_equal(np.asarray(jout), np.asarray(jar))
    tparams = bridge.to_torch(_np(params), device="cpu")
    _check_pitched(tparams["lm_head"], tcfg.d_model, V259)
    tmp = bridge.to_torch(_np(mp), device="cpu")
    for fused in (False, True):
        np.testing.assert_array_equal(
            _medusa_tokens(tcfg, tparams, tmp, tokens, lengths, fused,
                           frames), np.asarray(jout),
            err_msg=f"{arch} fused={fused}")


def test_adamw_step_keeps_the_pitch():
    """One ``lm_train_step`` over a pitched head writes it in place (the
    same storage and strides after the step) and equals, within the
    training tolerance, the same step over a contiguous copy of the
    head; the moments are contiguous (``zeros_like`` of a view that is
    not dense)."""
    cfg = dataclasses.replace(get_config("openpangu-7b", reduced=True),
                              num_layers=1, vocab_size=V259)
    params = get_model(cfg).init_params(torch.Generator().manual_seed(0),
                                        cfg)
    flat = dict(params, lm_head=params["lm_head"].contiguous())
    flat = {k: (v.clone() if torch.is_tensor(v) else v)
            for k, v in flat.items()}
    flat["units"] = O.tree_map(torch.clone, params["units"])
    flat["final_norm"] = O.tree_map(torch.clone, params["final_norm"])
    head, ptr = params["lm_head"], params["lm_head"].data_ptr()
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, V259, (4, 17)).astype(np.int32))
    opt = O.adamw_init(params)
    assert opt.mu["lm_head"].is_contiguous()
    got, _, gm = ST.lm_train_step(params, opt, cfg, toks[:, :-1],
                                  toks[:, 1:])
    want, _, wm = ST.lm_train_step(flat, O.adamw_init(flat), cfg,
                                   toks[:, :-1], toks[:, 1:])
    assert got["lm_head"] is head and head.data_ptr() == ptr
    _check_pitched(head, cfg.d_model, V259)
    np.testing.assert_allclose(float(gm["loss"]), float(wm["loss"]),
                               rtol=TOL)
    for g, w in zip(O.tree_leaves(got), O.tree_leaves(want)):
        scale = max(float(w.abs().max()), 1e-30)
        assert float((g - w).abs().max()) / scale <= TOL


def test_checkpoint_restores_the_pitch(tmp_path):
    cfg = dataclasses.replace(get_config("whisper-tiny", reduced=True),
                              vocab_size=V259)
    params = get_model(cfg).init_params(torch.Generator().manual_seed(0),
                                        cfg)
    path = CK.save(str(tmp_path), 1, params)
    template = get_model(cfg).init_params(torch.Generator().manual_seed(1),
                                          cfg)
    step, got, _ = CK.restore(path, template)
    assert step == 1
    _check_pitched(got["lm_head"], cfg.d_model, V259)
    assert torch.equal(got["lm_head"], params["lm_head"])
    assert got["embed"].is_contiguous()


@pytest.mark.parametrize("tp", [2, 1])
def test_tp_vocabulary_slice_is_pitched(tp):
    """Each rank's slice of a [d, 262] head (131 columns at tp 2) is a
    copy of its own at an aligned start and a pitch of 136 (at tp 1 the
    whole head, 262 columns at a pitch of 264)."""
    cfg = dataclasses.replace(get_config("openpangu-7b", reduced=True),
                              vocab_size=262)
    params = get_model(cfg).init_params(torch.Generator().manual_seed(0),
                                        cfg)
    piece = 262 // tp
    with C.planning():
        for rank in range(tp):
            eng = TP.build_tp_engine(cfg, TP.plan_tp_group(tp, rank=rank),
                                     "medusa", device="cpu")
            head = eng.shard_params(params)["lm_head"]
            _check_pitched(head, cfg.d_model, piece)
            assert head.data_ptr() % 16 == 0
            assert torch.equal(head, params["lm_head"][
                :, rank * piece:(rank + 1) * piece])


def test_launcher_pitches_given_weights(monkeypatch):
    """``serve.main(weights=...)`` serves a contiguous head of V 259 at the
    pitch, and answers as the same weights given pitched do."""
    cfg = dataclasses.replace(get_config("qwen1.5-0.5b", reduced=True),
                              vocab_size=V259)
    monkeypatch.setattr(serve, "get_config", lambda arch, reduced=False: cfg)
    params, mp = serve.build_model(cfg, 0, 4, torch.device("cpu"))
    _check_pitched(params["lm_head"], cfg.d_model, V259)
    flat = dict(params, lm_head=params["lm_head"].contiguous())
    argv = ["--static", "--reduced", "--device", "cpu", "--requests", "2",
            "--slots", "2", "--max-new", "6", "--verify-fusion"]
    runs = [serve.main(argv, weights=(p, mp)) for p in (flat, params)]
    _check_pitched(runs[0].params["lm_head"], cfg.d_model, V259)
    assert flat["lm_head"].is_contiguous()
    for a, b in zip(runs[0].results, runs[1].results):
        np.testing.assert_array_equal(a["output"], b["output"])
