"""Data pipeline: the synthetic ShareGPT-like corpus and self-distillation
(paper §4.2, Table 2); counterpart of ``repro.training.data``.

The corpus, its control tokens and the batch order are numpy, copied from
the reference so that the port imports nothing of it: the same
configuration gives the same arrays, bit for bit.  ``self_distill`` runs
the backbone's greedy continuations through the port's ``ar_generate``
(a captured CUDA graph on the card).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np
import torch

from repro_torch.runtime import StepGraphs, resolve_device

# reserved control-token slots at the top of the vocab
N_SPECIAL = 8
BOS, EOS, USER, ASSISTANT, THINK_ON, THINK_OFF, PAD, SEP = range(8)


def special_id(vocab_size: int, which: int) -> int:
    return vocab_size - N_SPECIAL + which


@dataclass
class SyntheticChatConfig:
    vocab_size: int
    seq_len: int = 128
    n_samples: int = 2048
    seed: int = 0
    # synthetic grammar: x_{t+1} = (a*x_t + b) % V_body with prob (1-noise)
    a: int = 31
    b: int = 7
    noise: float = 0.25
    turn_len: tuple = (8, 24)


def _body_vocab(vocab_size: int) -> int:
    return vocab_size - N_SPECIAL


def synthetic_chat(cfg: SyntheticChatConfig) -> np.ndarray:
    """[n_samples, seq_len] int32 ShareGPT-like turns with control tokens."""
    rng = np.random.default_rng(cfg.seed)
    V = _body_vocab(cfg.vocab_size)
    sp = lambda w: special_id(cfg.vocab_size, w)  # noqa: E731
    out = np.full((cfg.n_samples, cfg.seq_len), sp(PAD), np.int32)
    for i in range(cfg.n_samples):
        toks = [sp(BOS)]
        role = USER
        while len(toks) < cfg.seq_len - 1:
            toks.append(sp(role))
            if role == ASSISTANT and rng.random() < 0.3:
                toks.append(sp(THINK_ON))
            t = int(rng.integers(0, V))
            for _ in range(int(rng.integers(*cfg.turn_len))):
                if len(toks) >= cfg.seq_len - 1:
                    break
                toks.append(t)
                if rng.random() < cfg.noise:
                    t = int(rng.integers(0, V))
                else:
                    t = (cfg.a * t + cfg.b) % V
            if role == ASSISTANT and toks.count(sp(THINK_ON)) > toks.count(sp(THINK_OFF)):
                toks.append(sp(THINK_OFF))
            role = ASSISTANT if role == USER else USER
        toks.append(sp(EOS))
        out[i, : len(toks)] = toks[: cfg.seq_len]
    return out


def strip_special_tokens(data: np.ndarray, vocab_size: int) -> np.ndarray:
    """Replace control tokens with body tokens (the paper's *initial*,
    flawed distillation recipe — heads never learn formatting norms)."""
    V = _body_vocab(vocab_size)
    out = data.copy()
    mask = out >= V
    out[mask] = out[mask] % V
    return out


def self_distill(params, model, cfg, prompts: np.ndarray, gen_len: int,
                 batch: int = 16, device="cuda") -> np.ndarray:
    """Run the backbone greedily on the first half of each prompt and append
    its own ``gen_len`` tokens (the paper's self-distillation set).
    ``params`` live on ``device``; every batch decodes on one cache, zeroed
    in place, through one captured AR step of ``ar_generate`` on its plain
    attention path, as the reference's calls it.  Returns
    [n', S_p + gen_len] int32 for the first n' = n - n % batch prompts."""
    from repro_torch.core.engine import ar_generate
    dev = resolve_device(device)
    graphs = StepGraphs(dev)
    n = prompts.shape[0]
    S_p = prompts.shape[1] // 2
    cache = model.init_cache(cfg, batch, S_p + gen_len + 8, device=dev)
    outs = []
    lengths = torch.full((batch,), S_p, dtype=torch.int32, device=dev)
    for i in range(0, n - n % batch, batch):
        chunk = np.ascontiguousarray(prompts[i:i + batch, :S_p])
        for pos, entry in cache.items():
            for t in entry.values():
                if pos != model.PAGES_KEY:         # keep the block table
                    t.zero_()
        gen, _ = ar_generate(cfg, params, torch.from_numpy(chunk).to(dev),
                             lengths, cache, gen_len, graphs=graphs)
        outs.append(np.concatenate([chunk, gen.cpu().numpy()], axis=1))
    return np.concatenate(outs, axis=0)


def batches(data: np.ndarray, batch_size: int, seed: int = 0,
            epochs: Optional[int] = None) -> Iterator[np.ndarray]:
    rng = np.random.default_rng(seed)
    ep = 0
    while epochs is None or ep < epochs:
        idx = rng.permutation(data.shape[0])
        for i in range(0, len(idx) - batch_size + 1, batch_size):
            yield data[idx[i:i + batch_size]]
        ep += 1


def lm_batches(vocab_size: int, batch: int, seq: int, seed: int = 0):
    """Infinite synthetic LM pretraining stream."""
    cfg = SyntheticChatConfig(vocab_size=vocab_size, seq_len=seq + 1,
                              n_samples=max(batch * 4, 64), seed=seed)
    data = synthetic_chat(cfg)
    for b in batches(data, batch, seed=seed + 1):
        yield b[:, :-1], b[:, 1:]
