"""Dense-family training in the port against the JAX reference on the CPU.

The same numpy inputs and weights (carried across with
``repro_torch.bridge``) go through both packages:

* the synthetic corpus, ``strip_special_tokens``, ``batches`` and
  ``lm_batches``: bit for bit;
* ``forward_train`` (with and without remat) and ``lm_loss`` on reduced
  openPangu-7B with one layer, and ``medusa_loss`` (with and without a
  pad id) over the four-layer stack, in float32, every gradient leaf
  against ``jax.value_and_grad``: losses to 3e-5 relative, logits and
  gradients to 3e-5 of each leaf's largest magnitude; through the
  four-layer stack, where the two frameworks' float32 gradients differ by
  more than that, the port's are held to be no farther from the float64
  gradients than the reference's;
* one ``adamw_update`` from a state the reference's first step left
  (carried across with ``bridge.adamw_to_torch``), with and without a
  ``decay_mask``, at a fixed rate and on ``warmup_cosine``;
  ``clip_by_global_norm`` clipping and not; ``warmup_cosine`` at steps 0,
  5, 10, 50 and 100; one whole ``lm_train_step`` and
  ``medusa_train_step`` (the updated parameters, the moments and the
  metrics): 3e-5 of each leaf's largest magnitude;
* the reference's own training cases on reduced qwen1.5-0.5b: Eq. 1's
  lambda weighting (exact to 1e-5) and ``test_medusa_heads_learn`` (40
  head steps: the loss falls below 0.8 of its start, head 1 above
  chance);
* ``self_distill`` token for token;
* checkpoints: the round trip (float32, bf16, int32 and an AdamW state),
  retention and resume from the newest, the template key check, the
  async writer (its snapshot taken before the step updates the tensors in
  place), a float32 checkpoint the reference wrote restored here, and one
  written here restored by the reference;
* the launcher, on the CPU: it trains, checkpoints and resumes.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.core import medusa as JM
from repro.distributed.sharding import split_params
from repro.models.api import get_model as jax_get_model
from repro.training import checkpoint as JC
from repro.training import data as JD
from repro.training import optimizer as JO
from repro.training import steps as JS
from repro_torch import bridge
from repro_torch.core import medusa as M
from repro_torch.launch import train as launch_train
from repro_torch.models import transformer as TT
from repro_torch.training import checkpoint as C
from repro_torch.training import data as D
from repro_torch.training import optimizer as O
from repro_torch.training import steps as S

TOL = 3e-5


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


def _tt(tree):
    return bridge.to_torch(_np(tree), device="cpu")


def _leaf_close(got, ref, tol=TOL):
    """Within ``tol`` of the reference leaf's largest magnitude."""
    ref = np.asarray(ref, np.float32)
    got = got.detach().float().numpy()
    assert got.shape == ref.shape
    scale = max(float(np.abs(ref).max()), 1e-30)
    np.testing.assert_allclose(got / scale, ref / scale, atol=tol, rtol=0)


def _tree_close(got, ref, tol=TOL):
    flat_ref = jax.tree_util.tree_leaves_with_path(ref)
    for path, r in flat_ref:
        g = got
        for k in path:
            g = g[k.key]
        _leaf_close(g, r, tol)


def _pangu(num_layers):
    cfg = dataclasses.replace(jax_get_config("openpangu-7b", reduced=True),
                              num_layers=num_layers)
    params, _ = split_params(
        jax_get_model(cfg).init_params(jax.random.PRNGKey(1), cfg))
    corpus = JD.synthetic_chat(JD.SyntheticChatConfig(
        vocab_size=cfg.vocab_size, seq_len=33, n_samples=8, noise=0.05))
    return cfg, params, _tt(params), corpus


@pytest.fixture(scope="module")
def pangu():
    """Reduced openPangu-7B with one layer, where the layer-level float32
    tolerance holds (as in ``test_torch_layers.py``); the four-layer stack
    is held against float64 instead."""
    return _pangu(1)


@pytest.fixture(scope="module")
def pangu4():
    return _pangu(4)


@pytest.fixture(scope="module")
def qwen():
    cfg = jax_get_config("qwen1.5-0.5b", reduced=True)
    params, _ = split_params(
        jax_get_model(cfg).init_params(jax.random.PRNGKey(0), cfg))
    return cfg, params, _tt(params)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vocab,seq,n,noise,seed", [
    (256, 65, 64, 0.05, 0), (153376, 129, 8, 0.25, 3)])
def test_corpus_and_batches_bitwise(vocab, seq, n, noise, seed):
    kw = dict(vocab_size=vocab, seq_len=seq, n_samples=n, noise=noise,
              seed=seed)
    data = D.synthetic_chat(D.SyntheticChatConfig(**kw))
    ref = JD.synthetic_chat(JD.SyntheticChatConfig(**kw))
    assert data.dtype == ref.dtype == np.int32
    np.testing.assert_array_equal(data, ref)
    np.testing.assert_array_equal(D.strip_special_tokens(data, vocab),
                                  JD.strip_special_tokens(ref, vocab))
    assert D.special_id(vocab, D.PAD) == JD.special_id(vocab, JD.PAD)
    got = D.batches(data, 4, seed=seed + 1, epochs=2)
    for a, b in zip(got, JD.batches(ref, 4, seed=seed + 1, epochs=2)):
        np.testing.assert_array_equal(a, b)
    assert next(got, None) is None
    for (x, y), (jx, jy), _ in zip(D.lm_batches(vocab, 4, 16, seed),
                                   JD.lm_batches(vocab, 4, 16, seed),
                                   range(20)):
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(y, jy)


# ---------------------------------------------------------------------------
# forward, losses and gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("remat", [False, True])
def test_forward_train_and_lm_loss_grads(pangu, remat):
    cfg, params, tparams, corpus = pangu
    toks, tgts = corpus[:, :-1], corpus[:, 1:]
    jlog, jaux = jax_get_model(cfg).forward_train(params, cfg,
                                                  jnp.asarray(toks))
    log, aux = TT.forward_train(tparams, cfg, torch.from_numpy(toks),
                                remat=remat)
    _leaf_close(log, jlog)
    assert float(aux) == float(jaux) == 0.0
    (jtot, (jloss, _)), jg = jax.value_and_grad(JS.lm_loss, has_aux=True)(
        params, cfg, jnp.asarray(toks), jnp.asarray(tgts))

    def loss_fn(p, x, y):
        """``lm_loss`` (whose forward remats) with ``remat`` chosen."""
        logits, aux = TT.forward_train(p, cfg, x, remat=remat)
        loss = S.cross_entropy(logits, y)
        return loss + 0.01 * aux, (loss, aux)

    x, y = torch.from_numpy(toks), torch.from_numpy(tgts)
    (tot, (loss, _)), g = S.value_and_grad(loss_fn, tparams, x, y)
    np.testing.assert_allclose(float(tot), float(jtot), rtol=TOL)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=TOL)
    assert float(S.lm_loss(tparams, cfg, x, y)[0]) == float(tot)
    _tree_close(g, jg)


def test_stack_grads_against_float64(pangu4, monkeypatch):
    """Through the four-layer stack the two frameworks' float32 gradients
    differ by up to ~5e-4 of a leaf's largest magnitude, more than the
    layer-level 3e-5: the reduced model is ill-conditioned (its attention
    output reaches |y| ~ 34, ROADMAP queue 3).  Each is as far from the
    float64 gradients: the port's float32 gradient of every leaf must be no
    farther from them than the reference's (or within 3e-5), and its loss
    within 3e-5."""
    cfg, params, tparams, corpus = pangu4
    x, y = (torch.from_numpy(a) for a in (corpus[:, :-1], corpus[:, 1:]))
    (jtot, _), jg = jax.value_and_grad(JS.lm_loss, has_aux=True)(
        params, cfg, jnp.asarray(x.numpy()), jnp.asarray(y.numpy()))
    (tot, _), g = S.value_and_grad(S.lm_loss, tparams, cfg, x, y)
    f64 = {"float64": torch.float64}
    dtype_of = TT.torch_dtype
    for mod in (TT, TT.L):
        monkeypatch.setattr(mod, "torch_dtype",
                            lambda n: f64.get(n) or dtype_of(n))
    (t64, _), g64 = S.value_and_grad(
        S.lm_loss, O.tree_map(lambda t: t.double(), tparams),
        dataclasses.replace(cfg, dtype="float64", param_dtype="float64"),
        x, y)
    np.testing.assert_allclose(float(tot), float(t64), rtol=TOL)
    np.testing.assert_allclose(float(jtot), float(t64), rtol=TOL)
    for path, r in jax.tree_util.tree_leaves_with_path(jg):
        t, e = g, g64
        for k in path:
            t, e = t[k.key], e[k.key]
        e = e.numpy()
        scale = np.abs(e).max()
        port = np.abs(t.numpy() - e).max() / scale
        ref = np.abs(np.asarray(r) - e).max() / scale
        assert port <= max(ref, TOL), (jax.tree_util.keystr(path), port, ref)


@pytest.mark.parametrize("pad", [False, True])
def test_medusa_loss_and_grads(pangu4, pad):
    """On the four-layer stack: the backbone is frozen, and the heads'
    gradients hold to 3e-5."""
    cfg, params, tparams, corpus = pangu4
    K = 3
    mp, _ = split_params(JM.init_medusa(jax.random.PRNGKey(4), cfg, K))
    # a trained-looking residual block: the zero init would leave w1's
    # gradient path untested
    mp = dict(mp, w1=0.05 * jax.random.normal(jax.random.PRNGKey(5),
                                              mp["w1"].shape),
              b1=0.05 * jax.random.normal(jax.random.PRNGKey(6),
                                          mp["b1"].shape))
    pad_id = JD.special_id(cfg.vocab_size, JD.PAD) if pad else None
    (jl, jacc), jg = jax.value_and_grad(JS.medusa_loss, has_aux=True)(
        mp, params, cfg, jnp.asarray(corpus), K, pad_id=pad_id)
    (tl, tacc), g = S.value_and_grad(S.medusa_loss, _tt(mp), tparams, cfg,
                                     torch.from_numpy(corpus), K,
                                     pad_id=pad_id)
    np.testing.assert_allclose(float(tl), float(jl), rtol=TOL)
    np.testing.assert_array_equal(tacc.numpy(), np.asarray(jacc))
    _tree_close(g, jg)
    np.testing.assert_array_equal(
        S.eval_head_accuracy(_tt(mp), tparams, cfg, torch.from_numpy(corpus),
                             K, pad_id=pad_id).numpy(),
        np.asarray(JS.eval_head_accuracy(mp, params, cfg,
                                         jnp.asarray(corpus), K,
                                         pad_id=pad_id)))


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------

def _opt_inputs():
    rng = np.random.default_rng(0)
    params = {"w": rng.standard_normal((6, 5)).astype(np.float32),
              "n": {"b": rng.standard_normal((7,)).astype(np.float32),
                    "s": rng.standard_normal((2, 3, 4)).astype(np.float32)}}
    grads = [jax.tree.map(lambda p: (rng.standard_normal(p.shape) * 3)
                          .astype(np.float32), params) for _ in range(2)]
    return params, grads


@pytest.mark.parametrize("masked,sched", [(False, False), (True, True)])
def test_adamw_update_matches_reference(masked, sched):
    """The second step, from the moments the reference's first left."""
    params, (g1, g2) = _opt_inputs()
    mask = {"w": True, "n": {"b": False, "s": True}} if masked else None
    lr = (JO.warmup_cosine(0.1, 1, 10), O.warmup_cosine(0.1, 1, 10)) \
        if sched else (0.05, 0.05)
    kw = dict(weight_decay=0.1, decay_mask=mask)
    jp, js = JO.adamw_update(g1, JO.adamw_init(params), params, lr=lr[0],
                             **kw)
    jp2, js2 = JO.adamw_update(g2, js, jp, lr=lr[0], **kw)
    state = bridge.adamw_to_torch(js.step, _np(js.mu), _np(js.nu),
                                  device="cpu")
    tp = _tt(jp)
    tp2, ts2 = O.adamw_update(_tt(g2), state, tp, lr=lr[1], **kw)
    assert tp2 is tp and ts2.mu is state.mu      # updated in place
    assert int(ts2.step) == int(js2.step) == 2
    for got, ref in ((tp2, jp2), (ts2.mu, js2.mu), (ts2.nu, js2.nu)):
        _tree_close(got, ref)


def test_adamw_init_and_pieces():
    """Moments in each parameter's dtype; a leaf larger than ``PIECE`` is
    updated in pieces exactly as in one."""
    params = {"a": torch.randn(3, 5, dtype=torch.bfloat16),
              "b": torch.randn(4, 300)}
    st = O.adamw_init(params)
    assert st.mu["a"].dtype == torch.bfloat16 and int(st.step) == 0
    grads = {k: torch.randn_like(v) for k, v in params.items()}
    whole = O.adamw_update(grads, st, {k: v.clone() for k, v in
                                       params.items()}, lr=0.1)[0]
    st = O.adamw_init(params)
    old, O.PIECE = O.PIECE, 7
    try:
        pieces = O.adamw_update(grads, st, params, lr=0.1)[0]
    finally:
        O.PIECE = old
    for k in params:
        assert torch.equal(whole[k], pieces[k])


@pytest.mark.parametrize("max_norm", [1.0, 1e4])
def test_clip_by_global_norm_matches_reference(max_norm):
    _, (g, _) = _opt_inputs()
    jc, jn = JO.clip_by_global_norm(g, max_norm)
    tc, tn = O.clip_by_global_norm(_tt(g), max_norm)
    np.testing.assert_allclose(float(tn), float(jn), rtol=TOL)
    _tree_close(tc, jc)


def test_warmup_cosine_matches_reference():
    j, t = JO.warmup_cosine(1.0, 10, 100), O.warmup_cosine(1.0, 10, 100)
    for step in (0, 5, 10, 50, 100):
        np.testing.assert_allclose(float(t(torch.tensor(step))),
                                   float(j(jnp.asarray(step))), rtol=1e-6)
    assert float(t(5)) == pytest.approx(0.5)
    assert float(t(100)) == pytest.approx(0.1, rel=1e-3)


def test_data_parallel_options_raise(pangu):
    """The data-parallel paths need a process group for their axis (the
    ranks and their all-reduce are ``tests/test_torch_tp.py``'s), and
    compression needs the data axis."""
    cfg, _, tparams, corpus = pangu
    toks = torch.from_numpy(corpus[:2, :-1])
    tgts = torch.from_numpy(corpus[:2, 1:])
    with pytest.raises(ValueError, match="no process group"):
        O.compressed_psum({"g": torch.ones(3)}, "dp")
    params = {k: v for k, v in tparams.items()}
    with pytest.raises(ValueError, match="no process group"):
        S.lm_train_step(params, O.adamw_init(params), cfg, toks, tgts,
                        dp_axis="dp")
    with pytest.raises(ValueError, match="dp_axis"):
        S.lm_train_step(params, O.adamw_init(params), cfg, toks, tgts,
                        compress_grads=True)


def test_lm_train_step_matches_reference(pangu):
    cfg, params, tparams, corpus = pangu
    toks, tgts = corpus[:, :-1], corpus[:, 1:]
    jp, jo, jm = JS.lm_train_step(params, JO.adamw_init(params), cfg,
                                  jnp.asarray(toks), jnp.asarray(tgts))
    tp = {k: v for k, v in _tt(params).items()}
    tp, to, tm = S.lm_train_step(tp, O.adamw_init(tp), cfg,
                                 torch.from_numpy(toks),
                                 torch.from_numpy(tgts))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=TOL)
    np.testing.assert_allclose(float(tm["gnorm"]), float(jm["gnorm"]),
                               rtol=TOL)
    for got, ref in ((tp, jp), (to.mu, jo.mu), (to.nu, jo.nu)):
        _tree_close(got, ref)


def test_medusa_train_step_matches_reference(pangu):
    cfg, params, tparams, corpus = pangu
    K = 2
    mp, _ = split_params(JM.init_medusa(jax.random.PRNGKey(7), cfg, K,
                                        base_lm_head=params["lm_head"]))
    pad = JD.special_id(cfg.vocab_size, JD.PAD)
    jp, jo, jm = JS.medusa_train_step(mp, JO.adamw_init(mp), params, cfg,
                                      jnp.asarray(corpus), K, pad_id=pad)
    tmp = _tt(mp)
    tp, to, tm = S.medusa_train_step(tmp, O.adamw_init(tmp), tparams, cfg,
                                     torch.from_numpy(corpus), K, pad_id=pad)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=TOL)
    np.testing.assert_array_equal(tm["head_acc"].numpy(),
                                  np.asarray(jm["head_acc"]))
    for got, ref in ((tp, jp), (to.mu, jo.mu), (to.nu, jo.nu)):
        _tree_close(got, ref)


# ---------------------------------------------------------------------------
# the reference's training cases
# ---------------------------------------------------------------------------

def test_eq1_lambda_weighting(qwen):
    """Eq. 1: L = sum_k lambda_k CE_k with lambda_k = decay^k (exact)."""
    cfg, params, tparams = qwen
    mp2 = _tt(split_params(JM.init_medusa(jax.random.PRNGKey(2), cfg, 2))[0])
    mp1 = {k: v[:1] for k, v in mp2.items()}
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, size=(2, 32)).astype(np.int32))
    ce1 = float(S.medusa_loss(mp1, tparams, cfg, toks, 1, lam_decay=1.0)[0])
    ce12 = float(S.medusa_loss(mp2, tparams, cfg, toks, 2, lam_decay=1.0)[0])
    l_half = float(S.medusa_loss(mp2, tparams, cfg, toks, 2,
                                 lam_decay=0.5)[0])
    np.testing.assert_allclose(l_half, 0.5 * ce1 + 0.25 * (ce12 - ce1),
                               rtol=1e-5)


def test_medusa_heads_learn(qwen):
    cfg, _, tparams = qwen
    K = 3
    mp = M.init_medusa(torch.Generator().manual_seed(1), cfg, K)
    opt = O.adamw_init(mp)
    corpus = D.synthetic_chat(D.SyntheticChatConfig(
        vocab_size=cfg.vocab_size, seq_len=64, n_samples=128, noise=0.05))
    it = D.batches(corpus, 16, seed=2)
    losses = []
    for _ in range(40):
        mp, opt, met = S.medusa_train_step(
            mp, opt, tparams, cfg, torch.from_numpy(next(it)), K,
            pad_id=D.special_id(cfg.vocab_size, D.PAD))
        losses.append(float(met["loss"]))
    assert losses[-1] < losses[0] * 0.8
    accs = met["head_acc"].numpy()
    assert accs.shape == (K,)
    assert accs[0] > 1.5 / 256  # clearly above chance


def test_self_distill_matches_reference(qwen):
    cfg, params, tparams = qwen
    prompts = JD.synthetic_chat(JD.SyntheticChatConfig(
        vocab_size=cfg.vocab_size, seq_len=24, n_samples=9, noise=0.05))
    ref = JD.self_distill(params, jax_get_model(cfg), cfg, prompts, 6,
                          batch=4)
    got = D.self_distill(tparams, TT, cfg, prompts, 6, batch=4, device="cpu")
    assert got.shape == ref.shape == (8, 18)
    np.testing.assert_array_equal(got, ref)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _ckpt_tree():
    p = {"w": torch.randn(3, 4), "h": {"b": torch.randn(5).bfloat16()},
         "i": torch.arange(6, dtype=torch.int32).reshape(2, 3)}
    return {"params": p, "opt": O.adamw_init(p)}


def _equal_trees(a, b):
    fa, fb = C._flatten(a), C._flatten(b)
    assert [k for k, _ in fa] == [k for k, _ in fb]
    for (_, x), (_, y) in zip(fa, fb):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_checkpoint_roundtrip_retain_and_latest(tmp_path):
    tree = _ckpt_tree()
    path = C.save(str(tmp_path), 7, tree, meta={"note": "x"})
    step, restored, meta = C.restore(path, tree)
    assert step == 7 and meta == {"note": "x"}
    assert isinstance(restored["opt"], O.AdamWState)
    _equal_trees(restored, tree)
    _, flat, _ = C.restore(path)
    assert set(flat) == {k for k, _ in C._flatten(tree)}
    assert flat["params/h/b"].dtype == torch.bfloat16
    for s in (9, 11):
        C.save(str(tmp_path), s, tree)
    C.retain(str(tmp_path), keep=2)
    assert [s for s, _ in C.list_checkpoints(str(tmp_path))] == [9, 11]
    assert C.restore_latest(str(tmp_path), tree)[0] == 11
    assert C.restore_latest(str(tmp_path / "none")) is None


def test_checkpoint_template_mismatch_detected(tmp_path):
    path = C.save(str(tmp_path), 1, {"a": torch.zeros(3)})
    with pytest.raises(ValueError, match="key mismatch"):
        C.restore(path, {"b": torch.zeros(3)})


def test_async_checkpointer_snapshots_before_the_update(tmp_path):
    ck = C.AsyncCheckpointer(str(tmp_path), keep=1)
    w = torch.ones(8)
    ck.save(1, {"w": w})
    w.mul_(5)                      # an in-place step right after the save
    ck.save(2, {"w": w})
    w.add_(1)
    ck.wait()
    assert [s for s, _ in C.list_checkpoints(str(tmp_path))] == [2]
    step, tree, _ = C.restore_latest(str(tmp_path), {"w": w})
    assert step == 2 and torch.equal(tree["w"], torch.full((8,), 5.0))


def test_checkpoints_cross_between_the_packages(tmp_path, pangu):
    """A float32 checkpoint of the reference's (params and an AdamW state,
    the launcher's tree) restores here, and one written here restores in
    the reference, every leaf equal."""
    _, params, tparams, _ = pangu
    jtree = {"params": params, "opt": JO.adamw_init(params)}
    JC.save(str(tmp_path / "jax"), 3, jtree)
    template = {"params": tparams, "opt": O.adamw_init(tparams)}
    step, got, _ = C.restore_latest(str(tmp_path / "jax"), template)
    assert step == 3 and isinstance(got["opt"], O.AdamWState)
    jkeys, jvals, _ = JC._flatten(jtree)
    flat = C._flatten(got)
    assert [k for k, _ in flat] == jkeys
    for (k, a), b in zip(flat, jvals):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=k)
    C.save(str(tmp_path / "torch"), 4, template)
    step, back, _ = JC.restore_latest(str(tmp_path / "torch"), jtree)
    assert step == 4
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jtree)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_train_launcher_trains_checkpoints_and_resumes(tmp_path, capsys):
    argv = ["--reduced", "--device", "cpu", "--arch", "qwen1.5-0.5b",
            "--mode", "lm", "--batch", "4", "--seq", "16", "--ckpt-dir",
            str(tmp_path), "--ckpt-every", "3"]
    first = launch_train.main(argv + ["--steps", "6"])
    assert first["start"] == 0 and len(first["losses"]) == 6
    assert all(np.isfinite(first["losses"]))
    assert [s for s, _ in C.list_checkpoints(str(tmp_path))] == [3, 6]
    again = launch_train.main(argv + ["--steps", "8", "--resume"])
    assert again["start"] == 6 and len(again["losses"]) == 2
    assert "[resume] step 6" in capsys.readouterr().out
    heads = launch_train.main(["--reduced", "--device", "cpu", "--steps",
                               "3", "--batch", "4", "--seq", "16",
                               "--ckpt-dir", str(tmp_path / "h")])
    assert heads["state"]["params"]["lm"].shape[0] == 3
