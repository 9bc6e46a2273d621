"""Draft proposers for the speculative-decoding core (counterpart of
``repro.core.proposers``).

A ``Proposer`` produces the candidate tree (and the draft distribution q
the stochastic verifier needs) from whatever signal it owns; the generic
``core.engine.SpecEngine`` owns everything else.  Three implementations:

* ``MedusaProposer``     — the paper's trained multi-head proposer (§3.1);
* ``DraftModelProposer`` — classic two-model chain speculation
  (Leviathan/Chen), the draft's KV cache riding along as proposer state;
* ``NgramProposer``      — train-free prompt-lookup decoding: the token
  history is the draft model.

Static-shape contract: the candidate topology is fixed at construction,
``init_state`` allocates every tensor the proposer will own (sized by
batch and capacity alone), and ``propose``/``observe`` change values
only, never shapes, so they run inside the engine's captured step.  A
state is a dict of tensors, possibly nested (the draft's cache);
``state_axes`` gives each leaf's batch axis.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import medusa as M
from repro_torch.core import sampling as S
from repro_torch.core import verify as V
from repro_torch.core.tree import TreeBuffers, chain_tree, default_tree
from repro_torch.models import api as model_api
from repro_torch.runtime import tree_map


def _along(mask, x, ax: int):
    """``mask`` [B] bool shaped to broadcast along axis ``ax`` of ``x``."""
    shp = [1] * x.dim()
    shp[ax] = -1
    return mask.reshape(shp)


class Proposer:
    """Protocol for candidate proposers.

    Subclasses set ``tb``/``dtree`` in ``__init__`` and implement
    ``init_state`` / ``prime`` / ``propose`` / ``observe``.  Class
    attributes describe the contract to the engine:

    * ``consumes_key``  — propose() draws randomness from the ``key`` it is
      given (the engine's ``torch.Generator``), before the engine draws
      the verify noise from it.
    * ``q_kind``        — the draft distribution's form, "mprob" (per-node
      head probabilities, verified by ``sample_verify_tree``) or "logits"
      (per-position draft logits, verified by ``sample_verify_chain``).
    * ``supports_prefix`` — the proposer can be primed from a prompt
      suffix.  False for the draft model, whose own cache cannot map
      shared prefix blocks.
    * ``primes_from_tokens`` — the proposer can rebuild a row's state
      from token ids alone (``prime_tokens``), as a lookup proposer can.
    """

    tb: TreeBuffers
    dtree: V.DeviceTree
    consumes_key: bool = False
    q_kind: str = "mprob"
    supports_prefix: bool = True
    primes_from_tokens: bool = False

    def init_state(self, batch: int, capacity: int):
        """Allocate the proposer's device state for ``batch`` rows holding
        up to ``capacity`` tokens each (history buffers, draft caches);
        shape-free proposers ignore ``capacity``."""
        raise NotImplementedError

    def state_axes(self, state):
        """Nested dicts of ints, the structure of ``state``: the batch axis
        of each leaf."""
        return tree_map(lambda _: 0, state)

    def prime_tokens(self, state, tokens, tok_lens, base, mask):
        """Re-prime the ``mask`` [B] rows of ``state`` from token ids alone
        (tokens [B, W] right-padded, tok_lens [B] true counts, base [B] the
        current base token).  Only meaningful when the subclass declares
        ``primes_from_tokens``; the default keeps the state unchanged."""
        return state

    def prime(self, pp, state, tokens, lengths, tok_lens, hidden, base,
              extra_embeds=None):
        """(Re)initialise ``state`` after a target prefill: tokens [B, S_p]
        right-padded prompt, lengths [B] the cache lengths the target
        prefilled at, tok_lens [B] the true token counts inside ``tokens``
        (the lengths minus any frontend prefix), hidden [B, d] the
        target's last hidden state, base [B] the first emitted token,
        ``extra_embeds`` the frontend prefix the target prefilled (or
        None)."""
        raise NotImplementedError

    def propose(self, pp, state, base, key=None, temperature=1.0,
                top_k: int = 0, top_p=1.0, stochastic: bool = False,
                dtree=None):
        """-> (candidates [B, T] int32, q, state').  ``key`` is the
        generator a proposer that ``consumes_key`` draws from;
        ``temperature``/``top_k``/``top_p`` the warp its draws use
        (per-row [B] tensors allowed) and ``stochastic`` whether the
        engine verifies by sampling (a sampling proposer then draws its
        chain, so q is the proposal's distribution).  ``dtree``, if given,
        is a smaller topology than the proposer's own to propose on."""
        raise NotImplementedError

    def observe(self, pp, state, verdict, hidden, lengths):
        """Fold the verification outcome back into the state: ``hidden``
        [B, d] is the target hidden at the last accepted node, ``lengths``
        the post-commit cache lengths.  Updates are sized from the
        ``verdict``'s shapes, not ``self.dtree``."""
        raise NotImplementedError

    def reset_rows(self, state, keep):
        """Zero the state rows of slots where ``keep`` [B] bool is False,
        along each leaf's declared batch axis: what ``init_state`` gives
        those rows, so a slot's next tenant sees nothing of the last."""
        return tree_map(
            lambda x, ax: torch.where(_along(keep, x, ax), x,
                                      torch.zeros_like(x)),
            state, self.state_axes(state))


class MedusaProposer(Proposer):
    """The paper's trained K-head proposer (§3.1).

    State is the pair (mtok, mprob) [B, K, max_topk]: the head top-k
    computed from the target hidden at the previous step's last accepted
    node.  ``propose`` is a pure gather.
    """

    consumes_key = False
    q_kind = "mprob"
    supports_prefix = True

    def __init__(self, cfg: ModelConfig, device,
                 tb: Optional[TreeBuffers] = None):
        self.cfg = cfg
        self.device = torch.device(device)
        self.tb = tb if tb is not None else default_tree(cfg.spec_mode)
        self.dtree = V.device_tree(self.tb, self.device)

    def _heads(self, pp, hidden):
        if self.dtree.K == 0 or pp is None:
            return self.init_state(hidden.shape[0], 0)
        mtok, mprob = M.medusa_topk(pp, hidden, self.dtree.max_topk)
        return {"mtok": mtok.permute(1, 0, 2), "mprob": mprob.permute(1, 0, 2)}

    def init_state(self, batch: int, capacity: int):
        z = torch.zeros((batch, max(self.dtree.K, 1), self.dtree.max_topk),
                        dtype=torch.int32, device=self.device)
        return {"mtok": z, "mprob": z.float()}

    def prime(self, pp, state, tokens, lengths, tok_lens, hidden, base,
              extra_embeds=None):
        return self._heads(pp, hidden)

    def propose(self, pp, state, base, key=None, temperature=1.0,
                top_k: int = 0, top_p=1.0, stochastic: bool = False,
                dtree=None):
        # a smaller tree gathers from the same full-size head tensors
        dt = self.dtree if dtree is None else dtree
        cand = V.generate_candidates(base, state["mtok"], dt)
        return cand, state["mprob"], state

    def observe(self, pp, state, verdict, hidden, lengths):
        return self._heads(pp, hidden)


def draft_config(cfg: ModelConfig, draft_cfg: Optional[ModelConfig] = None,
                 layers: int = 2) -> ModelConfig:
    """The draft model's config for target ``cfg``: ``draft_cfg`` if given,
    else a ``layers``-layer sibling of ``cfg`` named ``<name>-draft`` (the
    reference's classic small-draft setup: a MoE target's draft is a MoE
    sibling, a VLM's a VLM with a ``frontend_proj`` of its own).  Either
    way it takes the
    target's ``verify_fusion``, so the draft's T=1 steps take the write
    side the engine's steps take (the fused one on an fp cache with
    ``use_kernel``)."""
    if draft_cfg is None:
        return dataclasses.replace(cfg, num_layers=min(layers, cfg.num_layers),
                                   name=cfg.name + "-draft")
    return dataclasses.replace(draft_cfg, verify_fusion=cfg.verify_fusion)


class DraftModelProposer(Proposer):
    """Classic two-model chain speculation (Leviathan/Chen 2023): a small
    draft model autoregressively proposes a γ-token chain; its KV cache and
    write position are the proposer state, ``{"cache": <the draft's dense
    cache>, "len": [B] int32}``.

    ``propose`` runs γ+1 T=1 decode steps (the extra step writes the last
    proposal's KV row, so a full accept leaves no stale row), drawing each
    proposal from the draft's warped logits with Gumbel noise from the
    engine's generator under ``stochastic`` (one draw per position), else
    taking the argmax; ``observe`` rolls the draft length back to the
    target's post-commit length: the accepted prefix stays, rejected rows
    are dead and are overwritten next round.

    The draft's config is the reference's: the target's vocabulary (a
    different one raises), and a dense cache whatever the target's layout
    (the state is merged per slot along its batch axis, which a pool has
    not).  Its decode steps take ``use_kernel``: on the card they run
    through ``flash_decode`` (and ``fused_qkv_rope_commit`` when the
    draft's config has verify fusion on an fp cache), as ``ar_generate``'s
    steps do, where the reference's draft decodes on the plain path.  That
    changes no greedy token: verification is lossless for any proposal.
    """

    consumes_key = True
    q_kind = "logits"
    supports_prefix = False

    def __init__(self, target_cfg: ModelConfig, draft_cfg: ModelConfig,
                 gamma: int = 4, device="cuda", use_kernel: bool = False):
        if target_cfg.vocab_size != draft_cfg.vocab_size:
            raise ValueError(
                f"tokenizer alignment: the draft's vocabulary "
                f"({draft_cfg.vocab_size}) is not the target's "
                f"({target_cfg.vocab_size})")
        if draft_cfg.paged:
            draft_cfg = dataclasses.replace(draft_cfg, cache_layout="dense")
        self.tc, self.dc = target_cfg, draft_cfg
        self.dm = model_api.get_model(draft_cfg)
        self.device = torch.device(device)
        self.use_kernel = use_kernel
        self.gamma = gamma
        self.tb = chain_tree(gamma)
        self.dtree = V.device_tree(self.tb, self.device)

    def init_state(self, batch: int, capacity: int):
        return {"cache": model_api.init_cache(self.dc, batch, capacity,
                                              device=self.device),
                "len": torch.zeros((batch,), dtype=torch.int32,
                                   device=self.device)}

    def state_axes(self, state):
        return {"cache": tree_map(lambda _: 1, state["cache"]), "len": 0}

    def prime(self, pp, state, tokens, lengths, tok_lens, hidden, base,
              extra_embeds=None):
        # a VLM's draft is a VLM sibling: it prefills the same prefix
        # through its own frontend_proj
        _, dcache = self.dm.prefill(pp, self.dc, tokens, lengths,
                                    state["cache"],
                                    extra_embeds=extra_embeds)
        return {"cache": dcache, "len": lengths}

    def propose(self, pp, state, base, key=None, temperature=1.0,
                top_k: int = 0, top_p=1.0, stochastic: bool = False,
                dtree=None):
        from repro_torch.core.engine import _squeeze_spec

        # a smaller chain really runs fewer draft decode steps
        dt = self.dtree if dtree is None else dtree
        gamma = dt.K
        dev = base.device
        chain1 = torch.ones((1, 1), dtype=torch.bool, device=dev)
        depth0 = torch.zeros((1,), dtype=torch.int32, device=dev)
        dcache, dlen, tok = state["cache"], state["len"], base
        toks, qlog = [], []
        for i in range(gamma + 1):
            hid, spec = self.dm.decode(pp, self.dc, dcache, tok[:, None],
                                       dlen, chain1, depth0,
                                       use_kernel=self.use_kernel)
            dcache = _squeeze_spec(spec)
            dlen = dlen + 1
            if i == gamma:          # the γ+1'th step only writes its KV row
                break
            logits = self.dm.unembed(pp, self.dc, hid[:, 0])
            if stochastic:
                tok = S.sample(S.gumbel(tuple(logits.shape), key), logits,
                               temperature, top_k, top_p)
            else:
                tok = torch.argmax(logits, dim=-1).to(torch.int32)
            toks.append(tok)
            qlog.append(logits.float())
        cand = V.generate_candidates(base, torch.stack(toks, 1)[:, :, None],
                                     dt)
        return cand, torch.stack(qlog, 1), {"cache": dcache, "len": dlen - 1}

    def observe(self, pp, state, verdict, hidden, lengths):
        # the draft wrote γ rows past the old length; the accepted prefix
        # stays, the rest is dead: roll the length back to the target's
        return {"cache": state["cache"], "len": lengths}


_MASK32 = 0xFFFFFFFF


class NgramProposer(Proposer):
    """Train-free prompt-lookup decoding: the history itself is the draft.

    State per row is an append-only token history ``hist`` [B, H] int32
    whose valid prefix ``hist[:hlen]`` is the prompt and every committed
    token including the current base; ``propose`` matches the history's
    n-token suffix (n = ``max_n`` .. ``min_n``, the longest match wins,
    then the most recent occurrence) against every earlier window and
    proposes the γ tokens that followed it as a chain.  Rows with no match
    (or a continuation running past the history) propose token 0, which
    verification rejects.  q is a point mass (all ones, [B, γ, 1]), so
    ``accept="sample"`` verifies with ``sample_verify_tree``'s residual
    rule.

    Two matchers share the state contract:

    * ``"scan"``      — the O(max_n · H) window compare;
    * ``"automaton"`` — per n a hash table ``tab[:, n - min_n, :]`` maps
      the rolling hash of each completed window (its content and first
      continuation token present) to ``start + 1`` (0: empty bucket);
      ``prime`` builds it in one pass, ``observe`` inserts the windows
      each commit completes by a scatter-max (the largest start, the most
      recent, wins whatever the order), and ``propose`` looks up max_n
      hashes and re-verifies the stored window's tokens, so a collision
      costs a missed proposal, never a wrong one;
    * ``"auto"``      — ``automaton`` iff ``init_state``'s capacity >=
      ``AUTO_THRESHOLD``.

    The hash is the reference's wrapping uint32 ``h * 1000003 + tok``,
    computed in int64 masked to 32 bits after every step, so every bucket
    (and so every table) is bitwise the reference's.
    """

    consumes_key = False
    q_kind = "mprob"
    supports_prefix = True
    primes_from_tokens = True

    AUTO_THRESHOLD = 8192     # capacity at which "auto" switches matcher
    _MUL = 1000003            # rolling-hash multiplier (uint32, wraps)

    def __init__(self, cfg: ModelConfig, gamma: int = 4, max_n: int = 3,
                 min_n: int = 1, matcher: str = "scan",
                 table_bits: int = 14, device="cuda"):
        if not (1 <= min_n <= max_n):
            raise ValueError(f"need 1 <= min_n <= max_n, got "
                             f"({min_n}, {max_n})")
        if matcher not in ("scan", "automaton", "auto"):
            raise ValueError(f"matcher must be scan | automaton | auto, "
                             f"got {matcher!r}")
        self.cfg = cfg
        self.gamma = gamma
        self.max_n, self.min_n = max_n, min_n
        self.matcher = matcher
        self.nb = 1 << table_bits
        self.device = torch.device(device)
        self.tb = chain_tree(gamma)
        self.dtree = V.device_tree(self.tb, self.device)

    def _use_tab(self, capacity: int) -> bool:
        if self.matcher == "auto":
            return capacity >= self.AUTO_THRESHOLD
        return self.matcher == "automaton"

    def init_state(self, batch: int, capacity: int):
        i32 = dict(dtype=torch.int32, device=self.device)
        state = {"hist": torch.zeros((batch, capacity), **i32),
                 "hlen": torch.zeros((batch,), **i32)}
        if self._use_tab(capacity):
            ns = self.max_n - self.min_n + 1
            state["tab"] = torch.zeros((batch, ns, self.nb), **i32)
        return state

    # ------------------------------------------------- automaton index

    def _hash(self, toks):
        """Rolling uint32 hash of the windows ``toks`` [..., n] -> int64
        values in [0, 2^32)."""
        h = torch.zeros(toks.shape[:-1], dtype=torch.int64,
                        device=toks.device)
        for k in range(toks.shape[-1]):
            h = (h * self._MUL + (toks[..., k].long() & _MASK32)) & _MASK32
        return h

    def _tab_insert(self, tab, hist, hlen, n, starts):
        """Scatter-max ``starts`` [B, W] (window starts for size ``n``) into
        the n-table, a window only once its content and first continuation
        token exist (``s + n <= hlen - 1``).  Invalid windows go to an
        extra bucket ``nb`` that is cut off (the reference's dropped
        out-of-range update)."""
        H = hist.shape[1]
        idx = torch.stack([torch.clamp(starts + k, 0, H - 1)
                           for k in range(n)], -1)
        h = self._hash(torch.gather(hist, 1, idx.reshape(idx.shape[0], -1))
                       .reshape(idx.shape))
        valid = (starts >= 0) & (starts + n <= hlen[:, None] - 1)
        bucket = torch.where(valid, h & (self.nb - 1), self.nb)
        j = n - self.min_n
        row = torch.cat([tab[:, j], torch.zeros_like(tab[:, j, :1])], 1)
        row = torch.scatter_reduce(row, 1, bucket,
                                   (starts + 1).to(torch.int32), "amax")
        return torch.cat([tab[:, :j], row[:, None, :self.nb],
                          tab[:, j + 1:]], 1)

    def _tab_build(self, hist, hlen):
        """Index every eligible window of ``hist``: one vectorised pass per
        n, paid once at prime instead of every step."""
        B, H = hist.shape
        ns = self.max_n - self.min_n + 1
        tab = torch.zeros((B, ns, self.nb), dtype=torch.int32,
                          device=hist.device)
        all_s = torch.arange(H, device=hist.device)[None, :].expand(B, H)
        for n in range(self.min_n, self.max_n + 1):
            tab = self._tab_insert(tab, hist, hlen, n, all_s)
        return tab

    def prime(self, pp, state, tokens, lengths, tok_lens, hidden, base,
              extra_embeds=None):
        B, Sp = tokens.shape
        H = state["hist"].shape[1]
        rows = torch.arange(B, device=tokens.device)
        hist = torch.zeros_like(state["hist"])
        hist[:, :Sp] = tokens.to(torch.int32)
        hist[rows, torch.clamp(tok_lens, 0, H - 1).long()] = \
            base.to(torch.int32)
        hlen = torch.clamp(tok_lens + 1, 0, H).to(torch.int32)
        out = {"hist": hist, "hlen": hlen}
        if "tab" in state:
            out["tab"] = self._tab_build(hist, hlen)
        return out

    def prime_tokens(self, state, tokens, tok_lens, base, mask):
        """History is the state, so token ids alone rebuild it: ``prime``
        on the full prompt, merged into the ``mask`` rows along each leaf's
        batch axis."""
        primed = self.prime(None, state, tokens, None, tok_lens, None, base)
        return tree_map(lambda new, old, ax: torch.where(
            _along(mask, new, ax), new, old), primed, state,
            self.state_axes(state))

    def _pattern(self, hist, hlen, n):
        """The last n valid history tokens [B, n] (ending at the base)."""
        H = hist.shape[1]
        pidx = hlen[:, None].long() - n + torch.arange(n, device=hist.device)
        return torch.gather(hist, 1, torch.clamp(pidx, 0, H - 1))

    def _match_scan(self, hist, hlen):
        """-> (found [B] bool, cstart [B] int32): the continuation start of
        the longest-n, most recent matching window, by brute compare."""
        B, H = hist.shape
        dev = hist.device
        pos = torch.arange(H, device=dev)
        found = torch.zeros((B,), dtype=torch.bool, device=dev)
        cstart = torch.zeros((B,), dtype=torch.int32, device=dev)
        for n in range(self.max_n, self.min_n - 1, -1):  # longest wins
            pat = self._pattern(hist, hlen, n)
            # window s matches iff hist[s:s+n] == pattern; s + n <= hlen-1
            # excludes the suffix itself and leaves >= 1 continuation token
            ok = pos[None, :] + n <= hlen[:, None] - 1
            for k in range(n):
                sh = hist[:, torch.clamp(pos + k, max=H - 1)]
                ok = ok & (sh == pat[:, k:k + 1])
            has = torch.any(ok, dim=1)
            last = (H - 1) - torch.argmax(torch.flip(ok, [1]).to(torch.int32),
                                          dim=1)
            take = has & ~found
            cstart = torch.where(take, (last + n).to(torch.int32), cstart)
            found = found | take
        return found, cstart

    def _match_tab(self, tab, hist, hlen):
        """Automaton lookup: O(max_n) hashes, the stored start re-verified
        token by token against the pattern."""
        B, H = hist.shape
        dev = hist.device
        rows = torch.arange(B, device=dev)
        found = torch.zeros((B,), dtype=torch.bool, device=dev)
        cstart = torch.zeros((B,), dtype=torch.int32, device=dev)
        for n in range(self.max_n, self.min_n - 1, -1):  # longest wins
            pat = self._pattern(hist, hlen, n)
            bucket = self._hash(pat) & (self.nb - 1)
            entry = tab[rows, n - self.min_n, bucket]
            s = entry - 1
            ok = (entry > 0) & (s + n <= hlen - 1) & (hlen >= n + 1)
            for k in range(n):
                sv = hist[rows, torch.clamp(s + k, 0, H - 1).long()]
                ok = ok & (sv == pat[:, k])
            take = ok & ~found
            cstart = torch.where(take, (s + n).to(torch.int32), cstart)
            found = found | take
        return found, cstart

    def propose(self, pp, state, base, key=None, temperature=1.0,
                top_k: int = 0, top_p=1.0, stochastic: bool = False,
                dtree=None):
        dt = self.dtree if dtree is None else dtree
        hist, hlen = state["hist"], state["hlen"]
        B, H = hist.shape
        if "tab" in state:
            found, cstart = self._match_tab(state["tab"], hist, hlen)
        else:
            found, cstart = self._match_scan(hist, hlen)
        cidx = cstart[:, None].long() + torch.arange(self.gamma,
                                                     device=hist.device)
        cont = torch.gather(hist, 1, torch.clamp(cidx, 0, H - 1))
        cont = torch.where(found[:, None] & (cidx < hlen[:, None]), cont, 0)
        # a shorter chain's node_head gathers a prefix of the continuation
        cand = V.generate_candidates(base, cont[:, :, None], dt)
        q = torch.ones((B, self.gamma, 1), dtype=torch.float32,
                       device=hist.device)             # point mass
        return cand, q, state

    def observe(self, pp, state, verdict, hidden, lengths):
        hist, hlen = state["hist"], state["hlen"]
        B, H = hist.shape
        dev = hist.device
        # sized from the verdict: a step may verify a shorter chain
        K1 = verdict.path_tokens.shape[1]
        # new tokens: path_tokens[1:acc] (slot 0, the base, is recorded)
        # then next_token at offset acc - 1; slots >= acc land past the
        # claimed prefix, where the next append overwrites them
        vec = torch.nn.functional.pad(verdict.path_tokens[:, 1:].to(
            torch.int32), (0, 1))
        vec = vec.scatter(1, (verdict.acc.long() - 1)[:, None],
                          verdict.next_token.to(torch.int32)[:, None])
        start = torch.clamp(hlen, 0, H - K1).long()
        hist = hist.scatter(1, start[:, None] + torch.arange(K1, device=dev),
                            vec)
        new_hlen = torch.clamp(hlen + verdict.acc, 0, H).to(torch.int32)
        out = {"hist": hist, "hlen": new_hlen}
        if "tab" in state:
            # the commit completed <= K1 windows per n (their first
            # continuation token just landed): starts hlen_old - n + j;
            # the validity mask drops the j >= acc tail
            tab = state["tab"]
            for n in range(self.min_n, self.max_n + 1):
                starts = (hlen[:, None].long() - n
                          + torch.arange(K1, device=dev))
                tab = self._tab_insert(tab, hist, new_hlen, n, starts)
            out["tab"] = tab
        return out


def make_proposer(kind: str, cfg: ModelConfig, *, device="cuda", tb=None,
                  draft_cfg=None, gamma: int = 4, max_n: int = 3,
                  min_n: int = 1, matcher: str = "auto",
                  use_kernel: bool = False) -> Proposer:
    """Build a proposer by name on ``device``: the ``--proposer
    {medusa,draft,ngram}`` dispatch point of ``build_engine`` and the
    launcher.  ``matcher`` picks the n-gram lookup (scan | automaton |
    auto, by history capacity); ``use_kernel`` is the draft model's decode
    path.  An unknown name raises."""
    if kind == "medusa":
        return MedusaProposer(cfg, device, tb)
    if kind == "draft":
        if draft_cfg is None:
            raise ValueError("proposer='draft' needs draft_cfg")
        return DraftModelProposer(cfg, draft_cfg, gamma=gamma, device=device,
                                  use_kernel=use_kernel)
    if kind == "ngram":
        return NgramProposer(cfg, gamma=gamma, max_n=max_n, min_n=min_n,
                             matcher=matcher, device=device)
    raise ValueError(f"unknown proposer {kind!r} "
                     "(expected medusa | draft | ngram)")
