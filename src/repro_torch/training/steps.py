"""Training steps in PyTorch (counterpart of ``repro.training.steps``):
full-model LM training and Medusa-head training by the paper's Eq. 1.

Plain PyTorch with autograd: the model's ``forward_train`` /
``forward_hidden`` (full causal attention through ``layers.attention_full``,
the products ``torch.einsum``), gradients from ``torch.autograd.grad``
(``value_and_grad``), the step from ``optimizer``.  Precision is the
reference's: master weights in ``cfg.param_dtype`` (float32), each
product in ``cfg.dtype`` (the weights cast on the way in, the gradient
cast back through the same cast), the loss in float32.  TF32 stays off
for float32 products: PyTorch's default for matrix products, which
``runtime.resolve_device`` pins on every entry point.  The step functions
update the parameters and the optimizer state in place (``optimizer``).
Under data parallelism (one process a rank, ``distributed.collectives``)
each step sums its gradients over the ranks of ``dp_axis`` first.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import medusa as M
from repro_torch.distributed import collectives as C
from repro_torch.models.api import get_model
from repro_torch.training import optimizer as O


def all_reduce_grads(grads, dp_axis, compress_grads: bool = False):
    """The data-parallel gradient all-reduce: every leaf **summed** over
    the ranks of ``dp_axis`` (the reference's ``psum`` sums, it does not
    average), in place, or int8-compressed
    (``optimizer.compressed_psum``).  ``dp_axis`` None: ``grads`` as they
    are (``compress_grads`` then has nothing to compress and raises)."""
    if dp_axis is None:
        if compress_grads:
            raise ValueError("compress_grads compresses the data-parallel "
                             "all-reduce: pass dp_axis")
        return grads
    if compress_grads:
        return O.compressed_psum(grads, dp_axis)
    return O.tree_map(lambda g: C.psum_(g, dp_axis), grads)


def value_and_grad(loss_fn, params, *args, **kwargs):
    """``jax.value_and_grad(loss_fn, has_aux=True)(params, *args)``:
    ``loss_fn(params, ...)`` -> (value, aux) is differentiated with respect
    to every tensor of the nested dict ``params``, through views of them
    (the caller's tensors are not marked).  Returns ((value, aux), grads),
    detached (``aux`` a tensor or a tuple of them); a parameter the loss
    does not reach gets a zero gradient."""
    views = O.tree_map(lambda p: p.detach().requires_grad_(), params)
    leaves = O.tree_leaves(views)
    with torch.enable_grad():
        value, aux = loss_fn(views, *args, **kwargs)
        grads = torch.autograd.grad(value, leaves, allow_unused=True)
    it = iter([torch.zeros_like(p) if g is None else g
               for p, g in zip(leaves, grads)])
    grads = O.tree_map(lambda _: next(it), views)
    aux = (tuple(a.detach() for a in aux) if isinstance(aux, tuple)
           else aux.detach())
    return (value.detach(), aux), grads


def cross_entropy(logits, targets, valid=None):
    """Mean cross-entropy in float32.  logits [..., V], targets [...] int.

    The gold logit is taken with a one-hot select over the vocabulary, as
    the reference takes it (its reason: with vocabulary-sharded logits a
    gather would all-gather them)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    V = logits.shape[-1]
    oh = targets[..., None] == torch.arange(V, device=logits.device)
    gold = torch.sum(torch.where(oh, logits, 0.0), dim=-1)
    ce = lse - gold
    if valid is None:
        return torch.mean(ce)
    w = valid.float()
    return torch.sum(ce * w) / torch.clamp(torch.sum(w), min=1.0)


# ---------------------------------------------------------------------------
# full-model LM training
# ---------------------------------------------------------------------------

def lm_loss(params, cfg: ModelConfig, tokens, targets, extra_embeds=None,
            aux_weight: float = 0.01):
    """-> (loss + aux_weight * aux, (loss, aux)).  ``extra_embeds``: a
    VLM's prefix (whose positions' logits are dropped) or the
    encoder-decoder's frames (which its encoder reads)."""
    model = get_model(cfg)
    logits, aux = model.forward_train(params, cfg, tokens,
                                      extra_embeds=extra_embeds)
    logits = logits[:, -targets.shape[1]:]
    loss = cross_entropy(logits, targets)
    return loss + aux_weight * aux, (loss, aux)


def lm_train_step(params, opt_state, cfg: ModelConfig, tokens, targets,
                  extra_embeds=None, lr=3e-4, clip: float = 1.0,
                  weight_decay: float = 0.1, dp_axis: str | None = None,
                  compress_grads: bool = False):
    """One AdamW step of the whole model (in place).  On the ranks of a
    data axis ``dp_axis`` (each with its own batch) the gradients are
    summed over the axis before clipping, int8-compressed with
    ``compress_grads``.  Returns (params, opt_state, {"loss", "aux",
    "gnorm"}), the metrics as device tensors (the loss the rank's
    own)."""
    (_, (loss, aux)), grads = value_and_grad(lm_loss, params, cfg, tokens,
                                             targets, extra_embeds)
    grads = all_reduce_grads(grads, dp_axis, compress_grads)
    grads, gnorm = O.clip_by_global_norm(grads, clip)
    params, opt_state = O.adamw_update(grads, opt_state, params, lr=lr,
                                       weight_decay=weight_decay)
    return params, opt_state, {"loss": loss, "aux": aux, "gnorm": gnorm}


# ---------------------------------------------------------------------------
# Medusa-head training (paper §3.1 Eq. 1)
# ---------------------------------------------------------------------------

def medusa_loss(medusa_params, backbone_params, cfg: ModelConfig, tokens,
                K: int, lam_decay: float = 0.8, pad_id: int | None = None):
    """L = sum_k lambda_k * CE(p_k(h_t), x_{t+k+2}), lambda_k =
    lam_decay ** (k + 1), over the frozen backbone's hidden states (no
    graph is kept for it).  Head k (0-indexed) predicts x_{t+k+2}: the
    backbone itself emits x_{t+1}.  Returns (L, per-head top-1 accuracy
    [K]).  The encoder-decoder raises, as in the reference: head
    training targets the decoder-only families."""
    model = get_model(cfg)
    if cfg.family == "encdec":
        raise NotImplementedError("head training targets LM families")
    with torch.no_grad():
        hidden, _ = model.forward_hidden(backbone_params, cfg, tokens,
                                         remat=False)
    logits = M.medusa_logits(medusa_params, hidden)           # [K, B, S, V]
    B, S = tokens.shape
    total = 0.0
    accs = []
    for k in range(K):
        n_valid = S - (k + 2)
        lg = logits[k, :, :n_valid]
        tg = tokens[:, k + 2:]
        valid = (torch.ones((B, n_valid), dtype=torch.bool,
                            device=tokens.device)
                 if pad_id is None else tg != pad_id)
        total = total + lam_decay ** (k + 1) * cross_entropy(lg, tg, valid)
        pred = torch.argmax(lg, dim=-1)
        accs.append(torch.sum((pred == tg) & valid)
                    / torch.clamp(torch.sum(valid), min=1))
    return total, torch.stack(accs)


def medusa_train_step(medusa_params, opt_state, backbone_params,
                      cfg: ModelConfig, tokens, K: int, lr=1e-3,
                      lam_decay: float = 0.8, clip: float = 1.0,
                      pad_id: int | None = None, dp_axis: str | None = None,
                      compress_grads: bool = False):
    """One AdamW step of the heads (in place; no weight decay, as in the
    reference); ``dp_axis`` / ``compress_grads`` as ``lm_train_step``.
    Returns (medusa_params, opt_state, {"loss", "head_acc",
    "gnorm"})."""
    (loss, accs), grads = value_and_grad(
        medusa_loss, medusa_params, backbone_params, cfg, tokens, K,
        lam_decay=lam_decay, pad_id=pad_id)
    grads = all_reduce_grads(grads, dp_axis, compress_grads)
    grads, gnorm = O.clip_by_global_norm(grads, clip)
    medusa_params, opt_state = O.adamw_update(grads, opt_state, medusa_params,
                                              lr=lr)
    return medusa_params, opt_state, {"loss": loss, "head_acc": accs,
                                      "gnorm": gnorm}


@torch.no_grad()
def eval_head_accuracy(medusa_params, backbone_params, cfg: ModelConfig,
                       tokens, K: int, pad_id: int | None = None):
    """Top-1 accuracy per head [K] (the Table 2 metric)."""
    return medusa_loss(medusa_params, backbone_params, cfg, tokens, K,
                       pad_id=pad_id)[1]
