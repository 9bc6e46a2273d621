#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA GPU.

  python3 chip_smoke.py

Run from the repo root of a checkout.  It imports nothing of JAX or of the
JAX package.  Every phase must pass, and any failure ends the run with a
non-zero exit:

1. print the card's name and power limit; build every CUDA kernel of the
   port from the checkout's sources (one nvcc per source, in parallel);
2. hold the ``flash_decode`` kernel (K1) against ``flash_decode_plain`` on
   the card (the reference's kernel-test shape sweep plus the main path's
   shapes, f32 and bf16, and at R 8 rows short enough that most of the
   32 splits start past the length), and ``ops.tree_attention`` against
   the ``tree_attention_ref`` oracle; then K1's int8, paged and int8 +
   paged variants the same way, on pools of page size 16, 64 and 128 read
   through a shuffled block table, with an idle slot (zero table, length
   0); every paged run must also be bitwise the dense kernel's run on the
   same logical rows; every K1 case logs its route ("single" or "split"),
   which must be the one ``decode_plan`` gives its shapes; all of it
   also at the dense family's new shapes (``FAMILY_K1``: gemma-2b's one
   kv head, D 256, R 512 / 8; qwen1.5-0.5b's 16 kv heads, D 64, R 64 / 8)
   and at the chain proposers' verify step (T 5 folded to R 24 over 2048
   rows: the "split" route), dense, int8, paged and int8 + paged; and at
   the MoE and VLM families' folds (``MOE_VLM_K1``: internvl2-26b's GQA
   group of 6, R 384 / 24 at D 128; granite-moe-1b-a400m's group of 2,
   R 128 / 8 at D 64), jamba's (R 40 / 8) and whisper-tiny's
   (``WHISPER_K1``: group 1, R 64 / 8 / 1 at D 64), every variant;
3. hold the verify-fusion kernels against their plain versions on the
   card, f32 and bf16: ``unembed_verify_stats`` (K2) at the spec step's
   shape (B 4, T 64, d 4096, V 153376, which is not a multiple of the
   kernel's 128-column tile), with a candidate in the last partial tile,
   and with tied lm-head columns in different tiles (first index wins),
   plus a vocabulary whose rows are not 16-byte aligned, and at N 512
   (B 8, T 64) and N 64, and at the sampled step's per-row temperatures
   ``TMAX_ROWS`` (1e-6 standing for temperature 0; m and cand_w held in
   the logits' units, finite, argm the tmax 1 argm) on both routes;
   and at the chain proposers' verify step (N 20: B 4, T 5, [4, 5, 5]
   candidate weights, at tmax 1 and at ``TMAX_ROWS``);
   ``fused_qkv_rope_commit`` (K3) at the spec (T 64), chain (T 5, M 20,
   dense and paged) and AR (T 1) shapes of openPangu-7B's attention, with
   biases, with rows past the cache's
   end (dropped; the rest of the cache unchanged bit for bit), at row
   counts that fit no tile (B 3, T 64 and B 4, T 7), at head_dim 64, and
   its paged variant with rows past the table (sent to trash block 0,
   which is not compared); K3-dense and K3-paged must give bitwise equal
   q, k and v on the same inputs, and so must a second run.  Every K2 and
   K3 case logs the route its launch took, which must be the ``wgmma``
   route for bf16 with aligned rows and the ``tile`` route for f32 and
   the unaligned vocabulary; then the commit kernels, K4
   (``commit_rows_stacked``) and K5 (``commit_rows_paged_stacked``), over
   three units and over one, for int8, bf16 and f32 rows and f32 scales,
   rows past the end included: the copies exact, the rest of the cache
   (block 0 of a pool excepted) unchanged bit for bit; then the
   one-launch commit of a spec step (``commit_path_stacked``, counted
   under K4 dense and K5 paged), reading 34 units' in-flight k and v
   where decode leaves them, bitwise its plain version (the gather,
   ``quantize_rows``, the rows-given writes) in bf16, f32 and int8 (bf16
   and f32 rows), dense and paged, with casts, stacked sources, and at
   the dense family's widths (gemma-2b's one kv head of 256,
   qwen1.5-0.5b's 16 of 64, qwen1.5-4b's 40 units of 20); and
   ``quantize_rows`` on the card bitwise its CPU run.  Then K2 over
   gemma-2b's tied [256000, 2048] embedding table passed as ``embed.T``
   (read in place: the call must allocate less than the table), on both
   routes, at tmax 1 and at ``TMAX_ROWS``; K3 at gemma-2b's head_dim 256
   (8 + 1 + 1 heads), dense and paged, T 64 and T 1, with and without
   biases, both routes, dense == paged bitwise; K3 at qwen1.5-0.5b's and
   qwen1.5-4b's widths with biases; K2 over the MoE and VLM families'
   heads (granite-moe d 1024 x V 49155 and internvl2 d 6144 x V 92553,
   laid out at a 16-byte row pitch as the models lay them out, wgmma in
   bf16, asserted, also with the pad poisoned and with every logit
   negative, and contiguous on the tile route; phi3.5-moe d 4096 x V
   32064), f32 and bf16 (a row whose top
   logit the two products round to neighbouring bf16 steps has m one
   step apart, and its l is then held to the sum-exp of the plain logits
   against the kernel's m); K3 at internvl2's and granite-moe's widths,
   spec and AR, dense and paged; the one-launch commit over
   granite-moe's 24 units of [8, 64] (dense, paged, int8 paged) and
   internvl2's 48 of [8, 128];
   K2 over whisper-tiny's [384, 51865] head (pitched, the same cases;
   contiguous on the tile route at ``TMAX_ROWS``), and the commit over its 4 decoder units of [6, 64] on every layout;
4. float32 openPangu-7B at full width, 2 layers: speculative ``generate``
   == ``ar_generate`` token for token, dense, with verify fusion, paged,
   paged with verify fusion, int8, int8 paged and int8 with verify fusion
   (K2 on the unfused int8 write side, no K3), each through the captured
   steps (CUDA graphs, the default), again on the engine's reused cache
   (every step replayed, no new capture) and through the eager steps
   (``graphs=False``): graph tokens == eager tokens == AR tokens; the fp
   variants all give the dense tokens and the int8 variants the int8
   ones; every run launches K1-K5 exactly as ``expected_counts`` says,
   and K1 takes the routes ``decode_plan`` gives the spec step (R 256:
   "single") and the AR step (R 8: "split", with a merge launch each).
   Before them, a captured step that draws from a generator registered
   with its capture must draw the eager draws, fresh at every replay, and
   one that draws from an unregistered generator must fail to capture.
   On every layout ``accept="sample"`` at temperature 0 gives the AR
   tokens (launches exact); dense and fused, at temperature 0.7 the
   captured sampled step gives the eager step's tokens from the same
   seed, and a second run at 0.9 replays the same graph (no new capture)
   and again gives the eager tokens;
4d. the deferred tree-row write (``deferred=True``: decode writes no
   tree row, commit is the only cache write) on phase 4's weights and its
   seven layout / fusion combinations: deferred spec == phase 4's spec
   (== AR) token for token, through the captured step, a second run
   replayed with no new capture, and the eager step; launches exact: K1
   once a layer and step, K2 once a fused step, the commit once a step,
   K3 never;
4e. the chain proposers (``build_engine(cfg, "draft" | "ngram")``, gamma
   4) on phase 4's weights and prompts: a 1-layer draft (the target's
   first layer) and the n-gram lookup, on the dense, int8, paged and
   int8 + paged caches, unfused and fused, greedy and sampled at
   temperature 0, and deferred on the dense cache: spec == phase 4's AR
   tokens through the captured step, launches exact (the target's T 5
   chain, the draft's gamma + 1 T=1 decodes a step on K1, and on K3 when
   fused on an fp cache), K1 on its routes (R 24, and R 8 for the
   draft); a self-draft (the target as its own draft) accepts every
   proposal: steps <= ceil(32 / 5) + 1;
4b. the sampled distribution gate: float32 at full width, 2 layers, a
   16-token vocabulary, 1024 rows of one prompt, 5 tokens at temperature
   0.9: sampled speculative tokens (unfused and fused, through K1-K4) of
   the Medusa tree walk (untrained heads on a cartesian (2, 2) tree) and
   of the draft's chain walk (a 1-layer draft of other random weights)
   against ``ar_generate_sampled``, max marginal TVD <= 1.5 * floor +
   0.05;
4c. the dense family (``FAMILY``: granite-8b, qwen1.5-0.5b, qwen1.5-4b,
   gemma-2b) in float32 at full width, 2 layers: spec == AR token for
   token through the captured steps, unfused and fused, launches exact;
   for qwen1.5-0.5b and gemma-2b also on the int8, paged and int8 + paged
   caches (fp layouts give the dense tokens, int8 ones the int8 tokens);
4m. the MoE and VLM families (``MOE_VLM``: granite-moe-1b-a400m,
   phi3.5-moe-42b-a6.6b, internvl2-26b) in float32 at full width, 2
   layers, at the no-drop capacity factor E / K (``no_drop``): spec == AR
   token for token through the captured steps, unfused and fused,
   launches exact, K1 on its routes; granite-moe also on int8 + paged;
   internvl2 with a 256-row frontend prefix ahead of every prompt;
5. the launcher (``repro_torch.launch.serve.main``) serves 8 requests on
   bf16 openPangu-7B at full width and depth through the captured step
   (one eager warm-up step, then replays of one graph for both groups,
   the capture's seconds logged); every request must finish, the kernels
   launch exactly as expected (K1 per layer and step, on its "single"
   route in phases 5-7, K4 once per spec step), and each answer
   matches ``ar_generate`` (its step captured too) up to its
   first divergence, where AR's logit for the token the speculative path
   emitted must lie within ``MARGIN_BOUND`` of AR's top logit;
6. the launcher with ``--verify-fusion`` answers the same 8 requests on
   the same weights, through K1, K2, K3 and K4 (counts exact), each answer
   held to ``ar_generate`` on the fused config under the same rule; it
   prints how many answers are token-identical to phase 5's and the
   tokens/s of both; every K2 and K3 launch must take the ``wgmma`` route,
   and the tensor maps encoded for weights over the run must be at most
   one per weight tensor (3 per layer for K3, 1 for K2); then (6b) the
   same configuration once more through the eager step (``graphs=False``,
   launches exact), logging the tokens/s of graph and eager, how many of
   the 8 answers are token-identical (expected 8), the capture's
   seconds, wall against device ms per step of the captured fused step,
   and the peak memory with the graph pools;
7. the same weights under the other cache layouts: (a) ``--cache-layout
   paged --verify-fusion`` (K1-paged, K3-paged, K2, K5) must give all 8
   answers of phase 6 token for token, every K2 and K3 launch on the
   ``wgmma`` route; (b) ``--cache-dtype int8``
   (K1-int8, K4) is held to ``ar_generate`` on the int8 config under
   ``MARGIN_BOUND``; (c) ``--cache-dtype int8 --cache-layout paged
   --page-size 16`` (K1-int8+paged, K5) must give all 8 answers of (b);
   7s: ``--accept sample --temperature 0.7``, unfused and fused (K2 at
   per-row temperatures), launches exact, tokens/s, steps, accepted
   length, capture seconds and the replayed step's wall and device ms
   logged beside greedy's, with the peak memory; at ``LOW_TEMPERATURE``
   (where candidates are accepted), unfused and fused, the same readings
   and how many answers the eager step (``graphs=False``, same seed)
   gives token for token; at temperature 0 all 8 answers must equal
   greedy's (phase 5);
9. (run before 8) the launcher with ``--arch`` on each of the dense
   family at full width and depth in bf16: the 8 requests unfused and
   with ``--verify-fusion`` on the same weights, launches exact, every K2
   and K3 launch on the wgmma route, each answer held to ``ar_generate``
   up to its first divergence under ``near_tie`` (the margin rule at the
   model's own top-logit magnitude); gemma-2b also sampled at temperature
   0 with verify fusion, 8 of 8 answers equal to fused greedy's; each
   run's tokens/s, steps, accepted length, capture seconds and peak
   memory logged;
10. (run after 7) the launcher with ``--deferred`` on phase 5's weights
   and requests: unfused (all 8 answers phase 5's), ``--verify-fusion``
   (K3 never launched; held to ``ar_generate`` under ``MARGIN_BOUND``)
   and ``--cache-dtype int8`` (all 8 answers 7b's), launches exact; each
   run's tokens/s, capture seconds and replayed step's wall and device ms
   beside the non-deferred run's;
12. (run after 7s) the launcher with ``--proposer draft`` (its 2-layer
   sibling, weights from ``--seed``) unfused, ``--verify-fusion``,
   ``--cache-layout paged --verify-fusion`` (all 8 answers the fused
   dense run's) and ``--cache-dtype int8``, and ``--proposer ngram``, on
   phase 5's weights and requests: launches exact, each answer held to
   ``ar_generate`` under ``MARGIN_BOUND``; tokens/s, tokens a step,
   capture seconds and the replayed step's wall and device ms logged
   beside phase 5's Medusa run, under the card's name and power limit;
11. training: (ii, run before 9) at full width, self-distillation of 8
   synthetic-corpus prompts (64 + 64 tokens) with ``ar_generate`` on
   phase 5's bf16 openPangu-7B, 20 ``medusa_train_step``s of K 4 float32
   heads on that set (loss finite and lower at the end), the heads
   through ``checkpoint.save`` / ``restore`` bit for bit, 10
   ``lm_train_step``s of qwen1.5-0.5b on one batch of 8 x 512 (the loss
   falls), ms per step and peak memory of each; (i) one ``lm_train_step``
   and one ``medusa_train_step`` on reduced float32 openPangu-7B on the
   card and on the CPU: loss, gradients and updated parameters within
   ``TRAIN_TOL`` (see ``phase_train_parity``); (iii) the reference's
   ``trained_stack`` (150 LM steps, self-distillation of 256 x 32, 120
   head steps, K 3) and ``bench_fig34_speedup.py`` on reduced
   openPangu-7B: head top-1 accuracy, mean accepted length, spec/AR step
   ratio and speedup at its four cache lengths, trained heads against the
   untrained ones (which must accept fewer), greedy spec == AR;
13. (run after 4e) the continuous-batching server
   (``serving.scheduler.SpecServer``) on phase 4's float32 openPangu-7B
   (full width, 2 layers), 4 slots, max_len 512: every answer equals
   ``ar_generate`` token for token on each run: dense with batched and
   serial admission, int8, paged with a pool tight enough to defer,
   paged with the prefix cache and a copy on write, chunked prefill
   (chunk 32), paged with optimistic allocation and preemption, adaptive
   gamma (the n-gram lookup, whose low acceptance lowers the level),
   ``--verify-fusion``, deferred, a ``FamilySpecServer`` with medusa,
   ngram and draft lanes, a sample engine at 0.8 with temperature-0
   requests mixed in (those equal AR), and a decode step that fails after
   running, recovered; each run's stats show its mechanism fired; the
   launches are exact (``serve_expected``: one commit, K4 or K5, a decode
   step and a ``suffix_prefill`` call; K1 a layer for both; K2 and K3
   under fusion); each level's serve step is one captured graph,
   replayed at every step after its first, never recaptured on
   admission, reap or recovery;
13b. (run after 12) the launcher's server (the default: no ``--static``)
   on phase 5's bf16 weights at full width and depth: 16 requests (phase
   5's 8 prompts and 8 more from the same generator), 4 slots, max_len
   2048, max_new drawn from 16..64; unfused, ``--verify-fusion``, and
   ``--cache-layout paged --page-size 64 --prefix-cache --preemption``,
   unfused and with ``--verify-fusion``,
   over 4 shared bases of 224 tokens (3.5 pages) plus 16..64-token
   suffixes in a pool of 3/4 of four requests' worst case: every request
   finishes, launches exact, one graph per level, each answer held to
   ``ar_generate`` under ``MARGIN_BOUND`` (the unfused paged run with
   ``ServedLogits``, its own top-two logits for every delivered token,
   logged at each divergence: an AR gap of exactly ``MARGIN_BOUND``
   passes only where the served logits tie the two tokens); each paged
   run preempts and copies on write at least once and peaks below the
   dense layout's worst case; logged: tok/s, latency and time-to-first-token p50/p99,
   scheduler iterations, host ms an iteration outside the step, the
   replayed step's device ms (CUDA events around each replay), capture
   seconds by level, the stats, and phase 5's static tok/s beside them;
14. (run after 9) the MoE and VLM families in bf16 at full width:
   granite-moe-1b-a400m at full depth through the launcher at the no-drop
   capacity factor (``--static`` unfused and fused, and the server's 16
   requests unfused and fused; launches exact, K2 on the wgmma route),
   every answer held to ``ar_generate`` under ``near_tie``, then the same
   four runs at the config's 1.25, reported and not held: answers equal
   to AR, the share of (token, expert) assignments dropped per step
   shape (``DropMeter``, counted on the card inside the graphs), tok/s,
   accepted length; internvl2-26b at full depth (~40 GB) through
   ``SpecEngine.generate`` with a 256-row prefix per request, unfused and
   fused, held to AR, and through the launcher with text only, fused;
   phi3.5-moe-42b-a6.6b at ``PHI_LAYERS`` (16) of its 32 layers (all 32
   do not fit one card) through ``build_engine``: no drop unfused and
   fused, held to AR, and 1.25 fused, reported.  A MoE's divergence from
   AR logs ``router_gap``, the f32 router's smallest top-K gap over the
   layers at the parting token; 11 (iv), after it: 8 ``lm_train_step``s
   of granite-moe at full width and depth on 8 x 512 (the loss falls, the
   aux loss finite and > 0);
4s, 15, 11 (v). the SSM and hybrid families (chain mode, T 5): f32 spec
   == AR (mamba2-2.7b at 2 layers, jamba-1.5-large-398b cut to one
   4-position unit), bf16 at full width through the launcher, the server
   and ``build_engine``, held to AR under ``near_tie`` and the measured
   drift (``step_drift``); mamba2-2.7b LM steps;
4w. the encoder-decoder: whisper-tiny in float32 at full width and depth
   (4 + 4 layers, 1500 frames a request): spec == AR with frames on the
   dense, int8, paged and int8 + paged caches, Medusa unfused, fused and
   sampled at temperature 0 and the n-gram lookup, graph == eager on the
   dense cache, launches exact (no K3: its decode keeps the unfused write
   side, as the reference's does);
16. (run after 15) whisper-tiny in bf16 at full width through the
   launcher with 1500 random frames a request: ``--static`` unfused and
   fused, the server dense unfused and fused and paged with
   ``--preemption`` (which must fire), launches exact, every answer held
   to ``ar_generate`` on its frames under ``near_tie``; tok/s, latency and
   time to first token p50/p99, the replayed step's device ms; 11 (vi),
   after 11 (v): reduced whisper LM steps on the card against the CPU
   within ``TRAIN_TOL`` (the key biases' gradients, which the softmax
   cancels, held to rounding), then 8 steps at full width;
8. time every kernel and variant, its plain version, and one PyTorch call
   as a yardstick the port never calls where one computes the same
   function (``scaled_dot_product_attention`` for K1, its backend pinned
   with ``torch.nn.attention.sdpa_kernel`` and named in the log, over the
   dense bf16 view the cache holds: gathered from the pool for K1-paged,
   dequantized to bf16 for K1-int8, neither step timed; for K2 and K3 one
   ``torch.matmul`` of the same product, which does only the product;
   ``index_put_`` of the pre-gathered rows into each leaf for K4 and K5)
   at the main path's shapes: for K1, K2 and K3, whose wrappers' host
   cost is near or above the kernel's time, CUDA events around launches
   queued behind a spin kernel so the card runs them back to back (the
   unqueued reading logged beside it); for the commit (K4 dense, K5
   paged, each in bf16 and int8) the one launch's device time from
   ``torch.profiler``, beside an empty kernel's (``torch.cuda._sleep(0)``:
   a launch's fixed device cost), the old per-step sequence it replaced
   (the stacks of the in-flight rows, the gathers, ``quantize_rows``
   under int8, one rows-given launch per leaf) and one rows-given launch
   of one leaf (what earlier slices timed).  K1's rows carry the AR step's (R 8)
   numbers beside the spec step's, K3's the AR step's (T 1); K1's, K2's
   and K3's rows carry the wrapper's host ms per call, and K2's its time
   at ``TMAX_ROWS`` (``tmax_ms``).  Then the same for the dense family's
   new shapes: K1 at ``FAMILY_K1``, K2 over gemma-2b's tied table, K3 at
   its head_dim 256 (with the plan's block count and shared memory); and
   the chain proposers' verify step (rows named ``@chain``): K1 at R 24
   (dense, int8, paged; the draft's R 8 beside it), K2 at N 20, K3 at
   M 20 (the draft's T 1 beside it), their launches from phase 12; and
   the MoE and VLM families' shapes (rows named ``@<arch>``): K1 at their
   folds, K2 over their heads (granite-moe's and internvl2's pitched,
   with ``torch.matmul`` also on the contiguous head and on the whole
   padded allocation, and the earlier ``tile`` route on the contiguous
   head), K3 at their widths, the commit over their
   units, their launches from phase 14's fused no-drop runs; the SSM
   and hybrid families' (``@<arch>``, phase 15's fused static runs); and
   whisper-tiny's (``@whisper-tiny``: K1 at R 64 / 8 over 6 kv heads of
   64, K2 over its [384, 51865] head, pitched, the commit over
   4 units of [6, 64]; launches from phase 16's fused static run); and
   tensor parallelism's (``@tp2``: K1 in its four variants at a tp-2
   rank's 4 kv heads, R 256 / 8, and the commit over 34 units of [4,
   128] on every layout, by CUDA events queued behind a spin kernel; the
   dense rows' launches from phase 17 (b)'s rank 0, the others' from
   phase 17 (a)'s).
17. tensor parallelism (``distributed/``: ``TPSpecEngine`` on
   ``torch.distributed``, one process a rank; nccl when every rank has a
   card, else gloo passed explicitly, the ranks sharing the card; the
   backend is logged).  Phases 2 and 3 check K1 (four variants) and the
   commit at a rank's kv heads (``TP_K1``: 4 at tp 2, 2 at tp 4, and 1).
   (a) (run after 13) float32 at full width, 2 layers, tp 2: on every
   rank, ``TPSpecEngine.generate`` on the dense, int8, paged and int8 +
   paged caches, Medusa and n-gram, greedy and sampled at temperature 0,
   == phase 4's single-device spec and AR tokens; K1 and K4 / K5
   launched exactly as ``expected_counts`` says at the local head count,
   K1 on its routes; under gloo the ranks first check gloo's CUDA path
   (``collectives.probe_gloo_cuda``: which collectives run natively,
   which are staged through pinned host memory).  (b) (run after 11
   (ii)) the launcher at ``--tp 2`` on bf16 openPangu-7B at full width
   and depth (8 requests, 4 slots, 64 new, ``--profile-steps 2``): every
   rank's answers rank 0's, launches exact, tokens/s, wall and device ms
   a step, the collectives' ms a step and peak memory per rank beside
   phase 5's single-card figures, then each answer held to single-device
   AR under ``MARGIN_BOUND`` on the same weights (card 0, after the ranks
   are gone).  ``python3 chip_smoke.py --tp-cards`` runs phase 17 alone on
   four cards over NCCL: (a) at tp 2 and tp 4, then the launcher at
   ``--tp 4`` and at ``--tp 2 --mesh-shape 2x2``.
18. (run after 17 (b)) the dry-run planner (``launch/dryrun.py``): (a)
   its CLI on three production cells (openpangu-7b ``decode_32k``,
   qwen1.5-0.5b ``train_4k`` and ``prefill_32k`` on the 16 x 16 mesh),
   each in its own process, started after phase 1's build so that they
   trace while the card runs the other phases, the records printed; (b) on one card, bf16
   openPangu-7B at full depth at phase 5's shape and a qwen1.5-0.5b
   ``lm_train_step`` at phase 11 (ii)'s, each planned on a one-device
   mesh: the growth of ``memory_allocated`` over allocating the same
   arguments equals the plan's argument bytes up to ``ALLOC_ROUND`` a
   tensor, the card's peak over one eager plain-path step lies within
   ``PLAN_PEAK_TOL`` of the planned peak and that step's own growth
   within ``PLAN_TEMP_TOL`` of the planned temp (the kernel path's peak
   logged); (c) the planned tp-2 decode cell at 17 (b)'s shape gives
   every rank's metered collectives (count and bytes by kind, a step)
   and step-argument bytes.  ``--tp-cards`` runs (c) after each of its
   launcher runs.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent

# bf16 keeps 8 significant bits.  The top logit of a 153,376-way vocabulary
# with unit-variance logits lies in [4, 8), where one bf16 step is 1/32.
# The speculative step runs 64 tree rows per sequence through each matrix
# product where the AR step runs one, so the two sum in different orders
# and may round a logit to a neighbouring step.  A divergence is accepted
# as a near tie only where AR ranks the speculative path's token less than
# two such steps below its own: a gap of 0 (an exact tie) or one step.
MARGIN_BOUND = 0.0625
H100_BYTES_PER_S = 3.35e12       # HBM3, H100 SXM data sheet
H100_BF16_FLOPS = 989e12         # dense bf16 tensor-core peak
H100_F32_FLOPS = 67e12           # f32 outside the tensor cores

# tests/test_kernels.py::CASES of the reference: B, S, Hq, Hkv, D, tree, dtype
REF_CASES = [
    (2, 1024, 8, 2, 64, "medusa", "float32"),
    (1, 512, 4, 4, 128, "chain", "float32"),
    (3, 2048, 8, 1, 128, "medusa", "bfloat16"),
    (2, 640, 6, 2, 64, "chain", "float32"),
    (1, 256, 2, 2, 256, "chain", "bfloat16"),
    (2, 512, 16, 8, 64, "medusa", "float32"),
]
TOL = {"float32": 3e-5, "bfloat16": 2e-2}
TMAX_ROWS = [0.7, 1.0, 1e-6, 2.0]   # K2's per-row warp temperatures
# the reference registry's other dense decoders, served at full width
FAMILY = ["granite-8b", "qwen1.5-0.5b", "qwen1.5-4b", "gemma-2b"]
# the two of them whose serving examples and equivalence tests the
# reference runs on every cache layout
ALL_LAYOUTS_FAMILY = ("qwen1.5-0.5b", "gemma-2b")
# K1 at their new shapes: (name, Hkv, D, (spec R, AR R)) over B 4
FAMILY_K1 = [("gemma-2b", 1, 256, (512, 8)),
             ("qwen1.5-0.5b", 16, 64, (64, 8))]
# the chain proposers (draft model, n-gram): gamma 4, a chain of T 5 rows
# a verify step; on openPangu-7B (G 4) K1 folds T 5, padded to 6, into R 24
GAMMA = 4
CHAIN_T = GAMMA + 1
CHAIN_R = 24
# the serving scheduler's suffix_prefill (prefix-cache admission, chunked
# prefill): a causal block of a prompt bucket's T rows
SUFFIX_T = (128, 512)
# the MoE and VLM families; phi3.5-moe serves in bf16 at 16 of its 32
# layers (~43 GB with the heads: all 32, ~84 GB, do not fit the card)
MOE_VLM = ["granite-moe-1b-a400m", "phi3.5-moe-42b-a6.6b", "internvl2-26b"]
PHI_LAYERS = 16
# K1 at their new folds (name, Hkv, D, (spec R, AR R)): internvl2's GQA
# group of 6 folds T 64 into R 384 and the AR step's one row, padded to 4
# (6 x 4 = 24, the first multiple of 8), into R 24; granite-moe's group of
# 2 at head_dim 64 gives R 128 and R 8 (phi3.5-moe's G 4, D 128 is
# openPangu-7B's fold)
MOE_VLM_K1 = [("internvl2-26b", 8, 128, (384, 24)),
              ("granite-moe-1b-a400m", 8, 64, (128, 8))]
# the SSM and hybrid families, chain-mode (Medusa heads on chain_tree(4),
# T 5): mamba2-2.7b has no attention (K2 alone on its path); jamba's
# attention position folds its G 8 x T 5 into R 40, the AR step's one row
# into R 8, at head_dim 128.  Jamba runs at full width cut to one
# 4-position unit (``ONE_UNIT``); the f32 phase also cuts its 16 experts
# to 4 (top-2), since sixteen f32 experts of d_ff 24576 at d 8192 (~77 GB
# a MoE layer) do not fit the card
SSM_HYBRID = ["mamba2-2.7b", "jamba-1.5-large-398b"]
JAMBA_K1 = [("jamba-1.5-large-398b", 8, 128, (40, 8))]
JAMBA_F32_EXPERTS = 4
# the encoder-decoder, whisper-tiny (4 encoder and 4 decoder layers, d 384,
# 6 heads of 64, group 1, 1500 frames a request): K1 at the tree step's
# R 64 (T 64 x 1), the AR step's one row padded to R 8, and one unpadded
# row (R 1); K2 over its [384, 51865] lm head, pitched (V is odd); the
# commit over its 4 decoder units of [6, 64] (the cross
# k/v is written at admission, never committed); no K3 (the reference's
# encdec decode keeps the unfused write side)
WHISPER = "whisper-tiny"
WHISPER_K1 = [(WHISPER, 6, 64, (64, 8, 1))]
# tensor parallelism: openPangu-7B's 8 kv heads at tp 2 and tp 4 (the
# group of 4 stays, so R stays 256 / 8), and one kv head a rank (the
# reduced config's at tp 2), at D 128
TP = 2
TP_K1 = [("openpangu-7b@tp2", 4, 128, (256, 8)),
         ("openpangu-7b@tp4", 2, 128, (256, 8)),
         ("hkv1@tp", 1, 128, (256, 8))]
TP_LAYOUTS = [("dense", "", "dense", 64), ("int8", "int8", "dense", 64),
              ("paged", "", "paged", 64), ("int8+paged", "int8", "paged", 16)]


def no_drop(cfg):
    """``cfg`` at the least capacity factor that drops nothing, E / K: the
    capacity C then covers a whole group (the reference's equivalence
    test raises it to 8.0 for the same reason: a token dropped in the
    verify forward but not in AR changes the logits).  A config without
    experts is returned as it is."""
    if not cfg.num_experts:
        return cfg
    return dataclasses.replace(
        cfg, capacity_factor=cfg.num_experts / cfg.experts_per_tok)


def log(msg: str):
    print(msg, flush=True)


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def smi_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True, timeout=60)
    return r.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` in ms over ``iters`` back-to-back runs
    (CUDA events; the inputs stay in L2 between runs)."""
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def queued_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` in ms over ``iters`` back-to-back runs,
    the runs queued behind a spin kernel long enough for the host to issue
    them all, so that the card runs them back to back however long the
    host takes per call (CUDA events; for wrappers whose host cost is near
    or above their kernel's time)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    per_call = (time.perf_counter() - t0) / warmup   # host and device
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(int((1.5 * per_call * iters + 2e-3) * 2e9))  # cycles
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean host time of one ``fn()`` call in ms: what the wrapper costs
    the host to issue its launch (no synchronise inside the window; the
    device queue stays far from full)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t * 1e3 / iters


def device_profile(fn, iters: int, warmup: int = 3, expect=None):
    """(mean device ms, mean kernel launches) of one ``fn()`` call: the
    CUDA kernels' own time and count under ``torch.profiler`` over
    ``iters`` runs (a replayed graph's kernels each count).  The profiler
    can drop records, more often the longer a run of big captured graphs
    has gone: a session may record a part of its kernels or none.  A session that records none, or fewer than ``expect``
    kernels a call where the caller knows its count, is run again; after
    three, the time comes from CUDA events around the calls queued
    behind a spin kernel (``queued_ms``, logged) and the count is
    None."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        n = sum(e.count for e in kernels)
        if n and (expect is None or n >= expect * iters):
            us = sum(getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0.0))
                     for e in kernels)
            return us / 1e3 / iters, n / iters
    log(f"    (the profiler recorded {n} kernels for {iters} calls three "
        f"times; CUDA events around the calls queued behind a spin kernel "
        f"instead)")
    return queued_ms(fn, iters, warmup=1), None


def device_ms(fn, iters: int, warmup: int = 3, expect=None) -> float:
    """Mean device time of ``fn()`` in ms: the CUDA kernels' own time
    under ``torch.profiler`` over ``iters`` runs (``device_profile``).
    For work shorter than the host's cost of issuing it, where CUDA
    events around back-to-back runs time the host instead of the card."""
    return device_profile(fn, iters, warmup, expect)[0]


def scaled_err(got, ref) -> float:
    """max |got - ref| / max(1, |ref|): the absolute error for values below
    1 in magnitude, the relative error above (one bf16 step is 1/32 at
    magnitudes in [4, 8), so a bf16 tolerance of 2e-2 is relative there)."""
    g, r = got.float(), ref.float()
    return ((g - r).abs() / r.abs().clamp(min=1.0)).max().item()


def _wrappers():
    """{kernel: the wrapper whose ``.launches`` counts its main-path
    launches}: K1 (every variant), K2, K3 (dense and paged), K4 (the
    dense commit, ``commit_rows_stacked``) and K5 (the paged commit,
    ``commit_rows_paged_stacked``)."""
    from repro_torch.kernels import cache_update as CU
    from repro_torch.kernels.tree_attention import (flash_decode,
                                                    unembed_verify_stats)
    return {"K1": flash_decode, "K2": unembed_verify_stats,
            "K3": CU.fused_qkv_rope_commit, "K4": CU.commit_rows_stacked,
            "K5": CU.commit_rows_paged_stacked}


def reset_counts():
    for f in _wrappers().values():
        f.launches = 0
        if hasattr(f, "launches_by_route"):
            f.launches_by_route.update(dict.fromkeys(f.launches_by_route, 0))


def read_routes():
    """{kernel: {route: launches}} since ``reset_counts``, for the kernels
    that count their routes (K1, K2 and K3)."""
    return {k: dict(f.launches_by_route) for k, f in _wrappers().items()
            if hasattr(f, "launches_by_route")}


def folded_rows(G, T):
    """K1's query rows for T tree rows and G q heads per kv head: T padded
    until G * T is a multiple of 8, as ``ops.tree_attention`` folds."""
    while (G * T) % 8:
        T += 1
    return G * T


def draft_t1_launches(proposer, steps: int) -> int:
    """Per-layer T=1 decodes the draft model of ``proposer`` runs in
    ``steps`` spec steps (gamma + 1 a step on each of its layers); 0 for
    a proposer without a draft model."""
    from repro_torch.core.proposers import DraftModelProposer

    if not isinstance(proposer, DraftModelProposer):
        return 0
    return steps * (proposer.dtree.K + 1) * proposer.dc.num_attn_layers


def k1_routes(cfg, B, S, steps, ar_steps=0, T=64, proposer=None):
    """K1's launches by route that ``decode_plan`` gives ``steps`` spec
    steps (T tree rows) and ``ar_steps`` AR steps on ``cfg``, B slots and
    S cache rows: one per layer and step, and a merge per split launch;
    with a draft-model ``proposer``, its T=1 decodes over a cache of the
    same S rows too."""
    from repro_torch.kernels.tree_attention import decode_plan
    from repro_torch.runtime import torch_dtype

    want = {"single": 0, "split": 0, "merge": 0}
    if not cfg.num_attn_layers:           # a pure SSM stack launches none
        return want
    G = cfg.num_heads // cfg.num_kv_heads
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    for t, n in ((T, steps * cfg.num_attn_layers),
                 (1, ar_steps * cfg.num_attn_layers
                  + draft_t1_launches(proposer, steps))):
        route = decode_plan(B, cfg.num_kv_heads, folded_rows(G, t), S,
                            torch_dtype(cfg.dtype), n_sm).route
        want[route] += n
        if route == "split":
            want["merge"] += n
    return want


def stats_route(cfg) -> str:
    """The route ``stats_plan`` gives K2 over ``cfg``'s bf16 unembedding
    weight as the port lays it out (a tied model's ``embed.T``; an untied
    [d, V] head through ``pitch_lm_head``, which puts a head whose V is
    not a multiple of 8 at a 16-byte row pitch): ``wgmma`` for every
    registry model.  Any other route fails: there is no fallback."""
    from repro_torch.kernels.tree_attention import (pitch_lm_head,
                                                    stats_plan,
                                                    stats_operand)

    d, V = cfg.d_model, cfg.vocab_size
    meta = dict(dtype=torch.bfloat16, device="meta")
    w = (torch.empty((V, d), **meta).T if cfg.tie_embeddings
         else pitch_lm_head(torch.empty((d, V), **meta)))
    table, layout = stats_operand(w)
    route = stats_plan(256, d, V, torch.bfloat16, layout=layout,
                       ldw=table.stride(0))[0]
    if route != "wgmma":
        fail(f"{cfg.name}: K2 over its {layout} head (row pitch "
             f"{table.stride(0)}) would take the {route} route")
    return route


def check_routes(label, counts, k1_want=None, k2_route="wgmma"):
    """K1's launches took the routes ``decode_plan`` gives the run
    (``k1_want``, from ``k1_routes``); with ``counts`` given, every K3
    launch of a bf16 main-path run took the wgmma route and every K2
    launch ``k2_route`` (``stats_route`` of the served config)."""
    routes = read_routes()
    log(f"  routes {routes}")
    if k1_want is not None and routes["K1"] != k1_want:
        fail(f"{label}: K1 launches by route {routes['K1']}, expected "
             f"{k1_want}")
    if counts is None:
        return
    for k, want in (("K2", k2_route), ("K3", "wgmma")):
        by = routes[k]
        if by[want] != counts[k] or sum(by.values()) != counts[k]:
            fail(f"{label}: {k} launches by route {by}, expected all "
                 f"{counts[k]} on the {want} route")


def read_counts():
    """{kernel: launches} since ``reset_counts``, after the device is
    done."""
    torch.cuda.synchronize()
    return {k: f.launches for k, f in _wrappers().items()}


def uncounted(fn, *args, **kwargs):
    """Call a kernel wrapper without counting its launches (every
    kernel's counters are restored after it; ``commit_path_stacked``
    counts in K4's or K5's): comparison and timing launches are not
    main-path launches."""
    saved = {f: (f.launches, dict(getattr(f, "launches_by_route", {})))
             for f in _wrappers().values()}
    out = fn(*args, **kwargs)
    for f, (n, routes) in saved.items():
        f.launches = n
        if routes:
            f.launches_by_route.update(routes)
    return out


def routed(fn, *args, **kwargs):
    """``uncounted`` call of a wrapper that counts its routes; returns (its
    result, the route its launch took: for K1 "single" or "split", whose
    merge launch is not returned)."""
    before = dict(fn.launches_by_route)
    out = fn(*args, **kwargs)
    took = [r for r, n in fn.launches_by_route.items() if n != before[r]]
    fn.launches -= 1
    fn.launches_by_route.update(before)
    return out, took[0]


def want_k1_route(name, route, B, Hkv, R, S, dt):
    """K1 takes the route ``decode_plan`` gives the launch's shapes."""
    from repro_torch.kernels.tree_attention import decode_plan

    want = decode_plan(B, Hkv, R, S, dt,
                       torch.cuda.get_device_properties(0)
                       .multi_processor_count).route
    if route != want:
        fail(f"{name}: took the {route} route, expected {want}")


def want_route(name, route, dt, aligned=True):
    """K2 and K3 take the wgmma route for bf16 with aligned rows, else the
    tile route."""
    want = "wgmma" if dt == torch.bfloat16 and aligned else "tile"
    if route != want:
        fail(f"{name}: took the {route} route, expected {want}")


def padded_batch(prompts, rows):
    """Right-padded [B, S] int32 tokens and [B] lengths for ``rows``
    (indices into ``prompts``), exactly as the launcher pads a group."""
    S = max(len(prompts[i]) for i in rows)
    tok = np.zeros((len(rows), S), np.int32)
    plen = np.zeros((len(rows),), np.int32)
    for j, i in enumerate(rows):
        tok[j, :len(prompts[i])] = prompts[i]
        plen[j] = len(prompts[i])
    return tok, plen


# ---------------------------------------------------------------------------
# phase 2: the kernel against its plain version
# ---------------------------------------------------------------------------

def stats_errors(got, ref):
    """Max errors of (acc, m, l) against the plain version: the normalised
    output acc / l (what the merge consumes), m, and l relative."""
    acc, m, l = got
    racc, rm, rl = ref
    out = (acc / l - racc / rl).abs().max().item()
    em = (m - rm).abs().max().item()
    el = (l / rl - 1).abs().max().item()
    return max(out, em, el), out


def phase_kernels(dev):
    from repro_torch.core.tree import chain_tree, medusa_63
    from repro_torch.kernels.ops import tree_attention
    from repro_torch.kernels.ref import tree_attention_ref
    from repro_torch.kernels.tree_attention import (flash_decode,
                                                    flash_decode_plain)
    from repro_torch.runtime import torch_dtype

    rng = np.random.default_rng(0)
    errs = {}

    def folded_case(name, B, S, Hkv, R, D, dt, lengths, key=None):
        q = torch.from_numpy(rng.standard_normal((B, Hkv, R, D))).to(dev, dt)
        q = q * (1.0 / np.sqrt(D))
        k = torch.from_numpy(rng.standard_normal((B, S, Hkv, D))).to(dev, dt)
        v = torch.from_numpy(rng.standard_normal((B, S, Hkv, D))).to(dev, dt)
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        got, route = routed(flash_decode, q, k, v, lens)
        want_k1_route(f"flash_decode {name}", route, B, Hkv, R, S, dt)
        ref = flash_decode_plain(q, k, v, lens)
        torch.cuda.synchronize()
        err, out_err = stats_errors(got, ref)
        tol = TOL["bfloat16" if dt == torch.bfloat16 else "float32"]
        log(f"  flash_decode {name}: B={B} S={S} Hkv={Hkv} R={R} D={D} "
            f"{dt} lengths={lengths}, {route} route: max err {err:.3e} "
            f"(tol {tol})")
        if not err < tol:
            fail(f"flash_decode {name} disagrees with its plain version: "
                 f"{err} >= {tol}")
        if key is not None and dt == torch.bfloat16:
            errs[key] = out_err

    for B, S, Hq, Hkv, D, tree, dname in REF_CASES:
        tb = medusa_63() if tree == "medusa" else chain_tree(4)
        T, G = tb.T, Hq // Hkv
        T_pad = T
        while (G * T_pad) % 8:
            T_pad += 1
        dt = torch_dtype(dname)
        lengths = rng.integers(1, S - T - 1, size=(B,)).tolist()
        folded_case(f"ref sweep {tree}", B, S, Hkv, G * T_pad, D, dt, lengths)
        # the whole tree attention, kernel path, against the oracle
        q = torch.from_numpy(rng.standard_normal((B, T, Hq, D))).to(dev, dt)
        k = torch.from_numpy(rng.standard_normal((B, S, Hkv, D))).to(dev, dt)
        v = torch.from_numpy(rng.standard_normal((B, S, Hkv, D))).to(dev, dt)
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        mask = torch.from_numpy(tb.mask).to(dev)
        scale = 1.0 / np.sqrt(D)
        out_k = tree_attention(q, k, v, mask, lens, scale)
        out_r = tree_attention_ref(q, k, v, mask, lens, scale)
        err = (out_k.float() - out_r.float()).abs().max().item()
        log(f"  tree_attention vs oracle: B={B} S={S} Hq={Hq} Hkv={Hkv} D={D} "
            f"{tree} {dname}: max err {err:.3e} (tol {TOL[dname]})")
        if not err < TOL[dname]:
            fail(f"tree_attention disagrees with the oracle: {err}")
    # the main path's shapes: 4 rows, 8 kv heads, head_dim 128, 2048 rows
    ragged = [1, 517, 1300, 2048]
    for dt in (torch.float32, torch.bfloat16):
        folded_case("main R=256", 4, 2048, 8, 256, 128, dt, ragged,
                    key="main")
        folded_case("main R=8", 4, 2048, 8, 8, 128, dt, ragged)
        # short rows: most of the 32 splits start past the length
        folded_case("main R=8 short", 4, 2048, 8, 8, 128, dt,
                    [1, 64, 65, 190])
        # the chain proposers' verify step: T 5 rows padded to 6, G 4
        folded_case(f"chain R={CHAIN_R}", 4, 2048, 8, CHAIN_R, 128, dt,
                    ragged, key="chain")
        # the server's suffix_prefill: a causal T 128 or 512 block (prompt
        # buckets and chunks), R = 4 T; the slots outside its mask run at
        # length = capacity (2048: the whole cache)
        for T in SUFFIX_T:
            folded_case(f"suffix_prefill T={T} R={4 * T}", 4, 2048, 8, 4 * T,
                        128, dt, ragged, key=f"suffix{T}")
        # the dense family's shapes: gemma-2b (one kv head, D 256, 8 q heads
        # a kv head: R 512 / 8) and qwen1.5-0.5b (16 kv heads, D 64, R 64 /
        # 8, the AR step's one row padded to 8)
        for name, Hkv, D, rows in (FAMILY_K1 + MOE_VLM_K1 + JAMBA_K1
                                   + WHISPER_K1 + TP_K1):
            for R in rows:
                folded_case(f"{name} R={R}", 4, 2048, Hkv, R, D, dt, ragged,
                            key=name if R == rows[0] else None)
    return errs


def shuffled_table(B, mb, dev, seed):
    """[B, mb] int32 on ``dev``: a random permutation of blocks
    1 .. B * mb (block 0 is the trash block)."""
    perm = np.random.default_rng(seed).permutation(B * mb) + 1
    return torch.from_numpy(perm.reshape(B, mb).astype(np.int32)).to(dev)


def to_pool(dense, table, ps, gen):
    """Pool [1 + B*mb, ps, ...] holding ``dense`` [B, mb*ps, ...] through
    ``table``; block 0 and the blocks of idle slots hold noise."""
    B, mb = table.shape
    pool = torch.randn((1 + B * mb, ps) + tuple(dense.shape[2:]),
                       generator=gen, device=dense.device).to(dense.dtype)
    pool[table.long()] = dense.reshape((B, mb, ps) + tuple(dense.shape[2:]))
    return pool


def variant_case(dev, name, B, S, Hkv, R, D, dt, lengths, quantized, ps,
                 seed):
    """K1's int8 / paged / int8 + paged variant against its plain version,
    on a shuffled table; a paged slot of length 0 gets a zero table (an
    idle slot).  A paged run must also be bitwise the dense kernel's run
    on the same logical rows.  Returns the max error of the live rows."""
    from repro_torch.kernels.quant import quantize_rows
    from repro_torch.kernels.tree_attention import (flash_decode,
                                                    flash_decode_plain)

    gen = torch.Generator(device=dev).manual_seed(seed)
    q = (torch.randn((B, Hkv, R, D), generator=gen, device=dev)
         * D ** -0.5).to(dt)
    kd = torch.randn((B, S, Hkv, D), generator=gen, device=dev).to(dt)
    vd = torch.randn((B, S, Hkv, D), generator=gen, device=dev).to(dt)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    leaves = {"k": kd, "v": vd}
    if quantized:
        (k8, ks), (v8, vs) = quantize_rows(kd), quantize_rows(vd)
        leaves = {"k": k8, "v": v8, "k_scale": ks, "v_scale": vs}
    dense_kw = {n: leaves[n] for n in ("k_scale", "v_scale") if n in leaves}
    kw = dict(dense_kw)
    k, v = leaves["k"], leaves["v"]
    if ps:
        table = shuffled_table(B, S // ps, dev, seed)
        table[lens == 0] = 0
        pools = {n: to_pool(t, table, ps, gen) for n, t in leaves.items()}
        k, v = pools["k"], pools["v"]
        kw = {n: pools[n] for n in dense_kw}
        kw["block_tables"] = table
    got, route = routed(flash_decode, q, k, v, lens, **kw)
    what = ("int8" if quantized else "fp") + (f" paged ps={ps}" if ps else "")
    want_k1_route(f"flash_decode {what} {name}", route, B, Hkv, R, S, dt)
    ref = flash_decode_plain(q, k, v, lens, **kw)
    torch.cuda.synchronize()
    live = lens > 0
    err, out_err = stats_errors([x[live] for x in got],
                                [x[live] for x in ref])
    idle_ok = ((got[0][~live] == 0).all() and (got[2][~live] == 0).all()
               and (got[1][~live] == -1e30).all())
    same = True
    if ps:
        dense = uncounted(flash_decode, q, leaves["k"], leaves["v"], lens,
                          **dense_kw)
        same = all(torch.equal(a, b) for a, b in zip(got, dense))
    tol = TOL["bfloat16" if dt == torch.bfloat16 else "float32"]
    log(f"  flash_decode {what} {name}: B={B} S={S} Hkv={Hkv} R={R} D={D} "
        f"{dt} lengths={lengths}, {route} route: max err {err:.3e} "
        f"(tol {tol})"
        + ("; bitwise equal to the dense kernel" if ps else ""))
    if not err < tol:
        fail(f"flash_decode {what} {name} disagrees with its plain version: "
             f"{err} >= {tol}")
    if not idle_ok:
        fail(f"flash_decode {what} {name}: an idle slot's statistics are "
             f"not empty")
    if not same:
        fail(f"flash_decode {what} {name}: the paged run differs from the "
             f"dense run on the same rows")
    return out_err


def phase_kernel_variants(dev):
    """K1-int8, K1-paged and K1-int8+paged at the reference sweep and the
    main path's shapes, page sizes 16, 64 and 128, and at the chain
    proposers' verify step (R 24).  Returns the max error of the
    normalised output of each variant at the bf16 main shape (R 256,
    page size 64) and at the chain's ("chain int8", "chain paged",
    "chain int8+paged")."""
    from repro_torch.core.tree import chain_tree, medusa_63
    from repro_torch.runtime import torch_dtype

    rng = np.random.default_rng(5)
    sizes = (16, 64, 128)
    for i, (B, S, Hq, Hkv, D, tree, dname) in enumerate(REF_CASES):
        T, G = (medusa_63() if tree == "medusa" else chain_tree(4)).T, \
            Hq // Hkv
        T_pad = T
        while (G * T_pad) % 8:
            T_pad += 1
        dt = torch_dtype(dname)
        lengths = rng.integers(1, S + 1, size=(B,)).tolist()
        if B > 1:
            lengths[0] = 0                       # an idle slot
        args = (dev, "ref sweep", B, S, Hkv, G * T_pad, D, dt, lengths)
        variant_case(*args, True, 0, i)
        variant_case(*args, False, sizes[i % 3], i)
        variant_case(*args, True, sizes[(i + 1) % 3], i)
    main = {}
    for dt in (torch.float32, torch.bfloat16):
        for R in (256, 8):
            args = (dev, f"main R={R}", 4, 2048, 8, R, 128, dt)
            err = variant_case(*args, [1, 517, 1300, 2048], True, 0, R)
            if dt == torch.bfloat16 and R == 256:
                main["int8"] = err
            for ps in sizes:
                for quantized in (False, True):
                    err = variant_case(*args, [0, 517, 1300, 2048],
                                       quantized, ps, R + ps)
                    if dt == torch.bfloat16 and R == 256 and ps == 64:
                        main["int8+paged" if quantized else "paged"] = err
        # the chain proposers' verify step (R 24), every variant
        args = (dev, f"chain R={CHAIN_R}", 4, 2048, 8, CHAIN_R, 128, dt)
        err = variant_case(*args, [1, 517, 1300, 2048], True, 0, 24)
        if dt == torch.bfloat16:
            main["chain int8"] = err
        for ps, quantized, name in ((64, False, "chain paged"),
                                    (16, True, "chain int8+paged")):
            err = variant_case(*args, [0, 517, 1300, 2048], quantized, ps,
                               24 + ps)
            if dt == torch.bfloat16:
                main[name] = err
        # R 8 with short rows and an idle slot: most splits start past the
        # length, and the idle slot's are all empty
        args = (dev, "main R=8 short", 4, 2048, 8, 8, 128, dt,
                [0, 64, 65, 190])
        variant_case(*args, True, 0, 3)
        for ps in sizes:
            for quantized in (False, True):
                variant_case(*args, quantized, ps, 4 + ps)
        # the dense family's shapes, every variant: int8, paged (page size
        # 64) and int8 + paged (16), an idle slot on the pools
        for name, Hkv, D, rows in (FAMILY_K1 + MOE_VLM_K1 + JAMBA_K1
                                   + WHISPER_K1 + TP_K1):
            for R in rows:
                args = (dev, f"{name} R={R}", 4, 2048, Hkv, R, D, dt)
                err = variant_case(*args, [1, 517, 1300, 2048], True, 0, R)
                if dt == torch.bfloat16 and R == rows[0]:
                    main[f"{name} int8"] = err
                err = variant_case(*args, [0, 517, 1300, 2048], False, 64,
                                   R + 1)
                if dt == torch.bfloat16 and R == rows[0]:
                    main[f"{name} paged"] = err
                err = variant_case(*args, [0, 517, 1300, 2048], True, 16,
                                   R + 2)
                if dt == torch.bfloat16 and R == rows[0]:
                    main[f"{name} int8+paged"] = err
    return main


# ---------------------------------------------------------------------------
# phase 3: the verify-fusion kernels against their plain versions
# ---------------------------------------------------------------------------

def bf16_step(x):
    """One bf16 step (8 significant bits) at the magnitude of ``x``."""
    return 2.0 ** (np.floor(np.log2(max(abs(x), 1e-30))) - 7)


def stats_case(dev, name, B, T, d, V, dt, tied=False, tmax=None,
               table=False, pitched=False, pad=None, negative=False):
    """K2 against its plain version; returns the max abs error of m and
    cand_w.  V not a multiple of 8 leaves rows TMA cannot take (tile
    route) unless ``pitched``: then the [d, V] head is laid out as the
    model lays it out (``pitch_lm_head``: rows ceil8(V) apart), and bf16
    takes the wgmma route.  ``pad``: a value written into the pitched
    head's pad columns (poison: were a pad column read, it would win every
    row).  ``negative``: every real logit is below -20 (column 0 of the
    head -4 against hidden's 8), so a pad column read as 0 would win the
    argmax.  ``table``: the head is a tied model's [V, d] embedding table,
    passed as its transposed view ``embed.T``; the launch must read it in
    place (the memory the call allocates stays below the table's size).
    ``tmax`` (one per row; default ones) are the rows' warp temperatures:
    then m, l and cand_w must also be finite, l at least 1, and argm
    exactly the kernel's own at tmax 1 on the same inputs (dividing a row
    by a positive temperature cannot move its argmax).
    The returned error is in the divided logits' units."""
    from repro_torch.kernels.tree_attention import (
        pitch_lm_head, unembed_verify_stats, unembed_verify_stats_plain)

    gen = torch.Generator(device=dev).manual_seed(1)
    h = torch.randn((B, T, d), generator=gen, device=dev).to(dt)
    if table:
        w = (torch.randn((V, d), generator=gen, device=dev)
             * d ** -0.5).to(dt).T
    else:
        w = (torch.randn((d, V), generator=gen, device=dev)
             * d ** -0.5).to(dt)
    cand = torch.randint(0, V, (B, T), generator=gen, device=dev,
                         dtype=torch.int32)
    cand[:, -1] = V - 1                       # in the last, partial tile
    tied_cols = [V // 8 + 8, V // 2 + 1, V - 3] if tied else []
    if tied:
        # equal columns in three tiles: logit 4 * 8 = 32 in every row,
        # above every other logit, so all three tie for the max exactly
        h[..., 0] = 8.0
        w[:, tied_cols] = 0.0
        w[0, tied_cols] = 4.0
        cand[:, :3] = torch.tensor(tied_cols, device=dev)
    if negative:
        h[..., 0] = 8.0
        w[0, :] = -4.0
    if pitched:
        w = pitch_lm_head(w)
        ldw = w.stride(0)
        if ldw % 8 or ldw < V:
            fail(f"unembed_verify_stats {name}: pitch_lm_head gave rows "
                 f"{ldw} apart at V {V}")
        if pad is not None:
            w.as_strided((d, ldw), (ldw, 1))[:, V:] = pad
    ones = torch.ones((B,), device=dev)
    tmax = ones if tmax is None else torch.tensor(tmax, dtype=torch.float32,
                                                  device=dev)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    (argm, m, l, cw), route = routed(unembed_verify_stats, h, w, cand, tmax)
    torch.cuda.synchronize()
    grew = torch.cuda.max_memory_allocated() - held
    if table and grew >= w.numel() * w.element_size():
        fail(f"unembed_verify_stats {name}: the call allocated {grew} bytes, "
             f"as much as the [V, d] table: it was copied")
    want_route(f"unembed_verify_stats {name}", route, dt,
               V % 8 == 0 or table or pitched)
    rargm, rm, rl, rcw = unembed_verify_stats_plain(h, w, cand, tmax)
    torch.cuda.synchronize()
    if bool(((argm < 0) | (argm >= V)).any()):
        fail(f"unembed_verify_stats {name}: argm outside [0, {V}): "
             f"{argm[(argm < 0) | (argm >= V)].unique().tolist()[:8]}")
    if tmax is not ones:
        argm1 = uncounted(unembed_verify_stats, h, w, cand, ones)[0]
        finite = all(bool(torch.isfinite(x).all()) for x in (m, l, cw))
        if not finite or bool((l < 1).any()) \
                or not torch.equal(argm, argm1):
            fail(f"unembed_verify_stats {name}: at tmax {tmax.tolist()} "
                 f"finite {finite}, min l {l.min().item()}, argm equal to "
                 f"tmax 1's {torch.equal(argm, argm1)}")
    # m and cand_w are the logits divided by the row's tmax: compared in
    # the logits' own units (times tmax), where the tmax 1 tolerance holds
    # (divided by 1e-6, a logit's f32 rounding grows a millionfold)
    t2, t3 = tmax[:, None], tmax[:, None, None]
    # l is the sum of exp(logit - m) against the kernel's own m.  Where
    # the two products round a row's top logit to neighbouring bf16 steps
    # (m one step apart, which the m check allows), the kernel's l is the
    # sum against its own m, e^(-step) times the plain version's when many
    # logits share the mass (3.2 % at logits in [4, 8)).  So each row's l
    # is held to the plain version's l, or to the sum-exp of the plain
    # logits taken against the kernel's m: the value the kernel computes
    # by definition; with the two m equal the two agree
    logits = torch.matmul(h, w).float() / tmax[:, None, None]
    l_own = torch.exp(logits - m[..., None]).sum(-1)
    l_err = torch.minimum((l / rl - 1).abs(), (l / l_own - 1).abs())
    err = max(scaled_err(m * t2, rm * t2), scaled_err(cw * t3, rcw * t3),
              l_err.max().item())
    abs_err = max((m - rm).abs().max().item(), (cw - rcw).abs().max().item())
    differ = (argm != rargm).nonzero().tolist()
    worst = 0.0
    if differ and dt == torch.float32:
        fail(f"unembed_verify_stats {name}: argm differs from the plain "
             f"version in f32 at {differ[:8]}")
    if differ:
        # bf16: the two products may round a logit to a neighbouring step;
        # the plain logit at the kernel's argm must lie within one bf16
        # step of the plain max (both divided by the row's tmax)
        for b, t in differ:
            gap = (rm[b, t] - logits[b, t, argm[b, t]]).item()
            worst = max(worst, gap / bf16_step(rm[b, t].item()))
            if gap > bf16_step(rm[b, t].item()):
                fail(f"unembed_verify_stats {name}: argm {argm[b, t]} at "
                     f"({b}, {t}) is {gap} below the plain max")
    if tied and not ((argm == tied_cols[0]).all()
                     and (rargm == tied_cols[0]).all()):
        fail(f"unembed_verify_stats {name}: tied columns {tied_cols}, argm "
             f"{argm.unique().tolist()} (plain {rargm.unique().tolist()})")
    tol = TOL["bfloat16" if dt == torch.bfloat16 else "float32"]
    at = "" if tmax is ones else f" at tmax {tmax.tolist()}"
    over = (f" over the [V, d] table in place ({grew} bytes allocated by "
            f"the call)" if table else
            f" over the head at row pitch {w.stride(0)}" if pitched else "")
    if pitched and pad is not None:
        over += f", pad columns {pad}"
    if negative:
        over += f", every logit negative (plain max {rm.max().item():.3f})"
        if not bool((rm < 0).all()):
            fail(f"unembed_verify_stats {name}: a real logit is not "
                 f"negative: plain max {rm.max().item()}")
    log(f"  unembed_verify_stats {name}: B={B} T={T} d={d} V={V} {dt}{at}"
        f"{over}, {route} route: "
        f"max err {err:.3e} (tol {tol}; abs {abs_err:.3e}); m differs in "
        f"{int((m != rm).sum())} rows; argm differs in "
        f"{len(differ)} of {B * T} rows (largest gap {worst:.2f} bf16 steps)")
    if not err < tol:
        fail(f"unembed_verify_stats {name} disagrees with its plain version: "
             f"{err} >= {tol}")
    return abs_err


def qkv_inputs(dev, cfg, T, dt, lengths, S=2048, bias=False, ps=0):
    """K3's inputs at ``cfg``'s attention widths: (x, p, lens, kc, vc,
    cos, sin, table); with ``ps`` the caches are pools of that page size
    read through a shuffled table, else None."""
    from repro_torch.models.layers import rope_cos_sin

    B, d, Hq, Hkv, hd = (len(lengths), cfg.d_model, cfg.num_heads,
                         cfg.num_kv_heads, cfg.resolved_head_dim)
    gen = torch.Generator(device=dev).manual_seed(2)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dt)

    x = rnd(B, T, d)
    p = {"wq": rnd(d, Hq, hd, scale=d ** -0.5),
         "wk": rnd(d, Hkv, hd, scale=d ** -0.5),
         "wv": rnd(d, Hkv, hd, scale=d ** -0.5)}
    if bias:
        p |= {"bq": rnd(Hq, hd, scale=0.1), "bk": rnd(Hkv, hd, scale=0.1),
              "bv": rnd(Hkv, hd, scale=0.1)}
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    table = None
    if ps:
        table = shuffled_table(B, S // ps, dev, T)
        kc, vc = rnd(1 + B * S // ps, ps, Hkv, hd), rnd(1 + B * S // ps, ps,
                                                         Hkv, hd)
    else:
        kc, vc = rnd(B, S, Hkv, hd), rnd(B, S, Hkv, hd)
    cos, sin = rope_cos_sin(lens[:, None] + torch.arange(T, device=dev), hd,
                            cfg.rope_theta)
    return x, p, lens, kc, vc, cos, sin, table


def qkv_case(dev, cfg, name, T, dt, lengths, S=2048, bias=False, ps=0):
    """K3 against its plain version at ``cfg``'s attention widths; with
    ``ps`` the caches are pools of that page size read through a shuffled
    table (rows past it go to trash block 0, which is not compared).
    Returns the max abs error."""
    from repro_torch.kernels import paging as P
    from repro_torch.kernels.cache_update import (
        fused_qkv_rope_commit, fused_qkv_rope_commit_plain)

    B, d, Hq, Hkv, hd = (len(lengths), cfg.d_model, cfg.num_heads,
                         cfg.num_kv_heads, cfg.resolved_head_dim)
    x, p, lens, kc, vc, cos, sin, table = qkv_inputs(dev, cfg, T, dt, lengths,
                                                     S, bias, ps)
    k0, v0 = kc.clone(), vc.clone()
    k1, v1 = kc.clone(), vc.clone()
    got, route = routed(fused_qkv_rope_commit, x, p, lens, kc, vc, cos=cos,
                        sin=sin, table=table)
    where = f" paged ps={ps}" if ps else ""
    want_route(f"fused_qkv_rope_commit{where} {name}", route, dt)
    ref = fused_qkv_rope_commit_plain(x, p, lens, k1, v1, cos=cos, sin=sin,
                                      table=table)
    torch.cuda.synchronize()
    if ps:
        # compare the pools without trash block 0
        kc, vc, k0, v0, k1, v1 = (t[1:] for t in (kc, vc, k0, v0, k1, v1))
    pairs = list(zip((*got, kc, vc), (*ref, k1, v1)))
    err = max(scaled_err(g, r) for g, r in pairs)
    abs_err = max((g.float() - r.float()).abs().max().item() for g, r in pairs)
    if ps:
        rows = P.phys_rows(table, lens, T, ps).reshape(-1)
        written = torch.zeros(kc.shape[0] * ps + ps, dtype=torch.bool,
                              device=dev)
        written[rows] = True
        kept = ~written[ps:].reshape(kc.shape[0], ps)
    else:
        pos = torch.arange(S, device=dev)[None, :]
        kept = ~((pos >= lens[:, None]) & (pos < lens[:, None] + T))
    if not (torch.equal(kc[kept], k0[kept]) and torch.equal(vc[kept],
                                                           v0[kept])):
        fail(f"fused_qkv_rope_commit {name}: cache rows outside "
             f"[lengths, lengths + T) changed")
    tol = TOL["bfloat16" if dt == torch.bfloat16 else "float32"]
    log(f"  fused_qkv_rope_commit{where} {name}: B={B} T={T} d={d} Hq={Hq} "
        f"Hkv={Hkv} hd={hd} S={S} {dt}, {route} route, lengths={lengths}: "
        f"max err "
        f"{err:.3e} (tol {tol}; abs {abs_err:.3e}); rest of the cache "
        f"unchanged")
    if not err < tol:
        fail(f"fused_qkv_rope_commit{where} {name} disagrees with its plain "
             f"version: {err} >= {tol}")
    return abs_err


def qkv_same_case(dev, cfg, T, dt, lengths, ps=64):
    """K3-dense and K3-paged on the same inputs give bitwise equal q, k and
    v, and a second run of each gives them again: no step of the sum
    depends on timing or on the cache layout."""
    from repro_torch.kernels.cache_update import fused_qkv_rope_commit

    x, p, lens, kc, vc, cos, sin, _ = qkv_inputs(dev, cfg, T, dt, lengths)
    _, _, _, pk, pv, _, _, table = qkv_inputs(dev, cfg, T, dt, lengths,
                                              ps=ps)
    runs = [uncounted(fused_qkv_rope_commit, x, p, lens, kc, vc, cos=cos,
                      sin=sin, table=t) if t is None else
            uncounted(fused_qkv_rope_commit, x, p, lens, pk, pv, cos=cos,
                      sin=sin, table=t)
            for t in (None, table, None, table)]
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for run in runs[1:]
               for a, b in zip(runs[0], run))
    log(f"  fused_qkv_rope_commit {cfg.name} dense vs paged ps={ps}: T={T} "
        f"{dt} "
        f"lengths={lengths}: q, k, v bitwise equal over 2 runs of each: "
        f"{same}")
    if not same:
        fail(f"fused_qkv_rope_commit T={T} {dt}: dense and paged (or two "
             f"runs) differ")


def commit_case(dev, name, dtype, width, paged, nu=3, S=2048, ps=64):
    """K4 (``commit_rows_stacked``) or K5 (``commit_rows_paged_stacked``)
    against its plain version: 5 rows per slot of 4 slots in every one of
    ``nu`` units, and in one cache (``nu`` 1, the reference's one-cache
    form), rows of [8, width] ``dtype`` elements, starts in range,
    straddling and past the end.  Copies must be exact and the rest of the
    cache (block 0 of a pool excepted) unchanged bit for bit."""
    from repro_torch.kernels import cache_update as CU

    gen = torch.Generator(device=dev).manual_seed(6)

    def rnd(*shape):
        if dtype == torch.int8:
            return torch.randint(-127, 128, shape, generator=gen, device=dev,
                                 dtype=torch.int8)
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    B, K1, H = 4, 5, 8
    lens = torch.tensor([0, 517, S - 2, S], dtype=torch.int32, device=dev)
    rows = rnd(nu, B, K1, H, width)
    if paged:
        table = shuffled_table(B, S // ps, dev, 7)
        cache = rnd(nu, 1 + B * S // ps, ps, H, width)
        fn, plain, extra = (CU.commit_rows_paged_stacked,
                            CU.commit_rows_paged_stacked_plain, (table,))
    else:
        cache = rnd(nu, B, S, H, width)
        fn, plain, extra = (CU.commit_rows_stacked,
                            CU.commit_rows_stacked_plain, ())

    def body(t):                          # a pool without trash block 0
        return t[:, 1:] if paged else t

    refs = []
    for c, r in ((cache, rows), (cache[:1], rows[:1])):
        got, ref = c.clone(), c.clone()
        uncounted(fn, got, *extra, r, lens)
        plain(ref, *extra, r, lens)
        torch.cuda.synchronize()
        if not torch.equal(body(got), body(ref)):
            fail(f"{fn.__name__} {name} ({c.shape[0]} units): the kernel's "
                 f"write differs from its plain version")
        refs.append(ref)
    # the plain version writes exactly the rows (and only them): check it
    # against a row-by-row copy
    want = cache.clone()
    for b, n in enumerate(lens.tolist()):
        for j in range(K1):
            pos = n + j
            if paged:
                blk = table[b, pos // ps].item() if pos // ps < S // ps else 0
                if blk:
                    want[:, blk, pos % ps] = rows[:, b, j]
            elif pos < S:
                want[:, b, pos] = rows[:, b, j]
    if not torch.equal(body(refs[0]), body(want)):
        fail(f"commit {name}: rows misplaced or the rest of the cache "
             f"changed")
    log(f"  {fn.__name__} {name}: nu={nu} and 1, B={B} K1={K1} rows "
        f"[{H}, {width}] {dtype}, lengths {lens.tolist()}"
        + (f", page size {ps}" if paged else f", S={S}")
        + ": exact, the rest unchanged")


def phase_fusion_kernels(dev):
    """K2 and K3 (dense and paged) at openPangu-7B's widths (B 4, T 64: the
    spec step; T 1: the AR step); then K2 over gemma-2b's tied table, K3
    at its head_dim 256 and at qwen1.5's widths with biases; K2 and K3
    at the chain proposers' verify step (N 20, M 20).  Returns their max
    abs errors at the bf16 spec-step shapes: {"K2", "K3", "K3-paged",
    "K2 table", "K3 hd256", "K2 chain", "K3 chain"}."""
    from repro_torch.configs.registry import get_config

    cfg = get_config("openpangu-7b")
    cfg64 = dataclasses.replace(cfg, head_dim=64)
    d, V = cfg.d_model, cfg.vocab_size
    errs = {}
    for dt in (torch.float32, torch.bfloat16):
        errs["K2", dt] = stats_case(dev, "main", 4, 64, d, V, dt)
        # the sampled step's per-row temperatures; 1e-6 is temperature 0
        stats_case(dev, "per-row tmax", 4, 64, d, V, dt, tmax=TMAX_ROWS)
        stats_case(dev, "tied columns", 4, 64, d, V, dt, tied=True)
        stats_case(dev, "V 4099 (unaligned rows)", 2, 64, 512, 4099, dt)
        pitched_cases(dev, "V 4099", 4, 64, 512, 4099, dt)
        # the chain proposers' verify step: N 20 rows, [4, 5, 5] weights
        errs["K2 chain", dt] = stats_case(dev, f"chain N {4 * CHAIN_T}", 4,
                                          CHAIN_T, d, V, dt)
        stats_case(dev, f"chain N {4 * CHAIN_T}, per-row tmax", 4, CHAIN_T,
                   d, V, dt, tmax=TMAX_ROWS)
        if dt == torch.bfloat16:
            # the wgmma route's row tiling: two row tiles, and one mostly
            # padding (f32 takes the tile route, checked above)
            stats_case(dev, "N 512", 8, 64, d, V, dt)
            stats_case(dev, "N 64", 1, 64, d, V, dt)
        ragged = [1, 517, 1300, 1984]
        errs["K3", dt] = qkv_case(dev, cfg, "spec", 64, dt, ragged)
        qkv_case(dev, cfg, "AR", 1, dt, ragged)
        qkv_case(dev, cfg, "spec with biases", 64, dt, ragged, bias=True)
        qkv_case(dev, cfg, "rows past S", 64, dt, [2040, 0, 2047, 100])
        qkv_case(dev, cfg, "B 3 (M 192)", 64, dt, [1, 517, 1300])
        qkv_case(dev, cfg, "T 7 (M 28)", 7, dt, ragged)
        errs["K3 chain", dt] = qkv_case(dev, cfg,
                                        f"chain T={CHAIN_T} (M 20)",
                                        CHAIN_T, dt, ragged)
        qkv_case(dev, cfg, f"chain T={CHAIN_T} (M 20)", CHAIN_T, dt, ragged,
                 ps=64)
        qkv_case(dev, cfg64, "head_dim 64, spec", 64, dt, ragged)
        qkv_case(dev, cfg64, "head_dim 64, AR", 1, dt, ragged, ps=16)
        for T in (64, 1):
            qkv_same_case(dev, cfg, T, dt, ragged)
        errs["K3-paged", dt] = qkv_case(dev, cfg, "spec", 64, dt, ragged,
                                        ps=64)
        # the server's suffix_prefill under fusion: M = 4 T rows, one slot
        # at capacity (its rows dropped), paged with one past the table
        for T in SUFFIX_T:
            errs[f"K3 suffix{T}", dt] = qkv_case(
                dev, cfg, f"suffix_prefill T={T} (M {4 * T})", T, dt,
                [0, 517, 1300, 2048])
            qkv_case(dev, cfg, f"suffix_prefill T={T} (M {4 * T})", T, dt,
                     [0, 517, 1300, 2048], ps=64)
        if dt == torch.bfloat16:
            errs |= {k: errs[k, dt] for k in (
                "K2", "K3", "K3-paged", "K2 chain", "K3 chain",
                *(f"K3 suffix{T}" for T in SUFFIX_T))}
        qkv_case(dev, cfg, "AR", 1, dt, ragged, ps=16)
        qkv_case(dev, cfg, "rows past the table", 64, dt,
                 [2040, 0, 2047, 100], ps=128)
        qkv_case(dev, cfg, "AR past the table", 1, dt, [2048, 5, 2047, 63],
                 ps=64)
    gemma = get_config("gemma-2b")
    for dt in (torch.float32, torch.bfloat16):
        # K2 over gemma-2b's tied [256000, 2048] table read in place
        err = stats_case(dev, "gemma-2b tied table", 4, 64, gemma.d_model,
                         gemma.vocab_size, dt, table=True)
        if dt == torch.bfloat16:
            errs["K2 table"] = err
        stats_case(dev, "gemma-2b tied table, per-row tmax", 4, 64,
                   gemma.d_model, gemma.vocab_size, dt, tmax=TMAX_ROWS,
                   table=True)
        # K3 at head_dim 256 (8 + 1 + 1 heads), dense and paged, T 64 and
        # T 1, with and without biases
        ragged = [1, 517, 1300, 1984]
        for bias in (False, True):
            with_b = ", biases" if bias else ""
            err = qkv_case(dev, gemma, f"gemma-2b spec{with_b}", 64, dt,
                           ragged, bias=bias)
            if dt == torch.bfloat16 and not bias:
                errs["K3 hd256"] = err
            qkv_case(dev, gemma, f"gemma-2b AR{with_b}", 1, dt, ragged,
                     bias=bias)
            qkv_case(dev, gemma, f"gemma-2b spec{with_b}", 64, dt, ragged,
                     bias=bias, ps=64)
            qkv_case(dev, gemma, f"gemma-2b AR{with_b}", 1, dt, ragged,
                     bias=bias, ps=16)
        qkv_case(dev, gemma, "gemma-2b rows past the table", 64, dt,
                 [2040, 0, 2047, 100], ps=128)
        for T in (64, 1):
            qkv_same_case(dev, gemma, T, dt, ragged)
        # qwen's widths with their biases
        for arch in ("qwen1.5-0.5b", "qwen1.5-4b"):
            qcfg = get_config(arch)
            for T in (64, 1):
                qkv_case(dev, qcfg, f"{arch} T={T}, biases", T, dt, ragged,
                         bias=True)
            qkv_case(dev, qcfg, f"{arch} spec, biases", 64, dt, ragged,
                     bias=True, ps=64)
    # the MoE and VLM families: K2 over each lm head at the spec step
    # (granite-moe's V 49155 and internvl2's 92553 are not multiples of 8:
    # their heads are pitched as the model lays them out, and take the
    # wgmma route in bf16, asserted, with the pad poisoned and with every
    # logit negative; phi3.5-moe's 32064 needs no pitch); K3 at
    # internvl2's (d 6144, 48 + 8 + 8 heads) and granite-moe's (d 1024,
    # 16 + 8 + 8 heads of 64) widths, spec and AR, dense and paged
    # (phi3.5-moe's are openPangu-7B's)
    ragged = [1, 517, 1300, 1984]
    for arch in MOE_VLM:
        mcfg = get_config(arch)
        for dt in (torch.float32, torch.bfloat16):
            err = stats_case(dev, arch, 4, 64, mcfg.d_model,
                             mcfg.vocab_size, dt, pitched=True)
            if dt == torch.bfloat16:
                errs[f"K2 {arch}"] = err
            if mcfg.vocab_size % 8:
                # the contiguous head as well (bf16 on the tile route)
                stats_case(dev, f"{arch} contiguous", 4, 64, mcfg.d_model,
                           mcfg.vocab_size, dt)
                pitched_cases(dev, arch, 4, 64, mcfg.d_model,
                              mcfg.vocab_size, dt)
            if arch == "phi3.5-moe-42b-a6.6b":
                continue
            err = qkv_case(dev, mcfg, f"{arch} spec", 64, dt, ragged)
            if dt == torch.bfloat16:
                errs[f"K3 {arch}"] = err
            qkv_case(dev, mcfg, f"{arch} AR", 1, dt, ragged)
            qkv_case(dev, mcfg, f"{arch} spec", 64, dt, ragged, ps=64)
            qkv_case(dev, mcfg, f"{arch} AR", 1, dt, ragged, ps=16)
        torch.cuda.empty_cache()
    # the SSM and hybrid families' chain step (T 5, N 20): K2 over
    # mamba2-2.7b's [2560, 50280] head and jamba's [8192, 65536]; K3 at
    # jamba's attention widths (d 8192, 64 + 8 + 8 heads of 128), the spec
    # step's M 20 and the AR step's M 4, dense and paged
    for arch in SSM_HYBRID:
        mcfg = get_config(arch)
        for dt in (torch.float32, torch.bfloat16):
            err = stats_case(dev, f"{arch} chain N {4 * CHAIN_T}", 4,
                             CHAIN_T, mcfg.d_model, mcfg.vocab_size, dt)
            if dt == torch.bfloat16:
                errs[f"K2 {arch}"] = err
            if not mcfg.num_attn_layers:
                continue
            err = qkv_case(dev, mcfg, f"{arch} chain T={CHAIN_T} (M 20)",
                           CHAIN_T, dt, ragged)
            if dt == torch.bfloat16:
                errs[f"K3 {arch}"] = err
            qkv_case(dev, mcfg, f"{arch} AR", 1, dt, ragged)
            qkv_case(dev, mcfg, f"{arch} chain T={CHAIN_T} (M 20)", CHAIN_T,
                     dt, ragged, ps=64)
            qkv_case(dev, mcfg, f"{arch} AR", 1, dt, ragged, ps=16)
        torch.cuda.empty_cache()
    # the encoder-decoder: K2 over whisper-tiny's [384, 51865] lm head at
    # the tree step, pitched (bf16 on the wgmma route, asserted), greedy,
    # at the sampled step's per-row temperatures, poisoned, all negative;
    # and the contiguous head (bf16 on the tile route) at the per-row
    # temperatures
    wcfg = get_config(WHISPER)
    for dt in (torch.float32, torch.bfloat16):
        err = stats_case(dev, WHISPER, 4, 64, wcfg.d_model, wcfg.vocab_size,
                         dt, pitched=True)
        if dt == torch.bfloat16:
            errs[f"K2 {WHISPER}"] = err
        stats_case(dev, f"{WHISPER}, per-row tmax", 4, 64, wcfg.d_model,
                   wcfg.vocab_size, dt, tmax=TMAX_ROWS)
        pitched_cases(dev, WHISPER, 4, 64, wcfg.d_model, wcfg.vocab_size, dt)
    return errs


def pitched_cases(dev, name, B, T, d, V, dt):
    """K2 over a [d, V] head at the row pitch ``pitch_lm_head`` gives it
    (V not a multiple of 8): at the sampled step's per-row temperatures,
    with 1e4 in every pad column, and with every real logit negative."""
    stats_case(dev, f"{name} pitched, per-row tmax", B, T, d, V, dt,
               tmax=TMAX_ROWS, pitched=True)
    stats_case(dev, f"{name} pitched, poisoned pad", B, T, d, V, dt,
               pitched=True, pad=1e4)
    stats_case(dev, f"{name} pitched, negative logits", B, T, d, V, dt,
               pitched=True, negative=True)


def path_inputs(dev, nu, H, D, src_dt, quantized=False, ps=0,
                cache_dt=None, B=4, T=64, K1=5, S=2048, stacked=False,
                seed=13):
    """The commit's inputs at one step: nu units' in-flight k and v
    [B, T, H, D] of ``src_dt`` (a tuple of per-unit tensors, as decode
    hands them, or one stacked tensor), best paths [B, K1] int64 over the T
    rows, lengths [0, 517, S - 2, S] (rows in range, straddling and past
    the end), and the leaves: a dense cache [nu, B, S, H, D] or, with
    ``ps``, a pool [nu, 1 + B * S / ps, ps, H, D] through a shuffled
    table, of ``cache_dt`` (default ``src_dt``) or int8 values with f32
    scales.  Returns (leaves, sources, path, lengths, table)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    src = {n: tuple(torch.randn((B, T, H, D), generator=gen,
                                device=dev).to(src_dt) for _ in range(nu))
           for n in "kv"}
    if stacked:
        src = {n: torch.stack(t) for n, t in src.items()}
    path = torch.randint(0, T, (B, K1), generator=gen, device=dev)
    lens = torch.tensor([0, S // 4 + 5, S - 2, S][:B], dtype=torch.int32,
                        device=dev)
    table = shuffled_table(B, S // ps, dev, seed) if ps else None
    lead = (nu, 1 + B * S // ps, ps) if ps else (nu, B, S)
    leaves = {}
    for n in "kv":
        if quantized:
            leaves[n] = torch.randint(-127, 128, lead + (H, D),
                                      generator=gen, device=dev,
                                      dtype=torch.int8)
            leaves[n + "_scale"] = torch.rand(lead + (H, 1), generator=gen,
                                              device=dev)
        else:
            leaves[n] = torch.randn(lead + (H, D), generator=gen,
                                    device=dev).to(cache_dt or src_dt)
    return leaves, src, path, lens, table


def path_case(dev, name, nu, H, D, src_dt, quantized=False, ps=0, **kw):
    """The one-launch commit (``commit_path_stacked``: K4 dense, K5 paged)
    against its plain version (the gather, ``quantize_rows`` under int8
    and the rows-given plain writes) on the same inputs (``path_inputs``):
    every leaf after the launch must be bitwise the plain version's (pools
    without trash block 0), the rows past S dropped and the rest of the
    cache unchanged.  Returns the max abs difference (0.0)."""
    from repro_torch.kernels import cache_update as CU

    leaves, src, path, lens, table = path_inputs(dev, nu, H, D, src_dt,
                                                 quantized, ps, **kw)
    got = {n: t.clone() for n, t in leaves.items()}
    ref = {n: t.clone() for n, t in leaves.items()}
    wrapper = CU.commit_rows_paged_stacked if ps else CU.commit_rows_stacked
    before = wrapper.launches
    uncounted(CU.commit_path_stacked, got, src, path, lens, table)
    CU.commit_path_stacked_plain(ref, src, path, lens, table)
    torch.cuda.synchronize()
    err = 0.0
    for n in leaves:
        g, r = (t[:, 1:] if ps else t for t in (got[n], ref[n]))
        if not torch.equal(g, r):
            fail(f"commit_path_stacked {name}: leaf {n} differs from the "
                 f"plain version")
        err = max(err, (g.float() - r.float()).abs().max().item())
    if wrapper.launches != before:
        fail(f"commit_path_stacked {name}: an uncounted call counted")
    cache = "int8 + f32 scales" if quantized else \
        str(kw.get("cache_dt") or src_dt)
    log(f"  commit_path_stacked {name}: nu={nu} B=4 T=64 K1=5 rows "
        f"[{H}, {D}] {src_dt} -> {cache}"
        + (f", page size {ps}" if ps else "")
        + (", stacked sources" if kw.get("stacked") else "")
        + f": bitwise the plain version (max abs err {err})")
    return err


def quant_case(dev):
    """``quantize_rows`` on the card against its CPU run (the reference's
    rounding): values and scales bitwise equal over 8192 rows of 8 heads
    of 128.  Logs how many scales a division by the Python float 127.0
    on the card (a product with its reciprocal) would change."""
    from repro_torch.kernels.quant import _EPS, INT8_MAX, quantize_rows

    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((8192, 8, 128), generator=gen, device=dev) * 3
    q, s = quantize_rows(x)
    q_cpu, s_cpu = quantize_rows(x.cpu())
    if not (torch.equal(q.cpu(), q_cpu) and torch.equal(s.cpu(), s_cpu)):
        fail("quantize_rows on the card differs from its CPU run")
    amax = torch.amax(x.abs(), dim=-1, keepdim=True).clamp(min=_EPS)
    off = ((amax / INT8_MAX).cpu() != s_cpu).sum().item()
    log(f"  quantize_rows: card == CPU bitwise over {s.numel()} scales; a "
        f"division by the Python float {INT8_MAX} on the card would change "
        f"{off} of them")


def phase_commit_kernels(dev):
    """K4 and K5 for int8 values, bf16 and f32 rows and the int8 layout's
    f32 scales, with rows past the end (the rows-given wrappers); then
    the one-launch commit of a spec step at openPangu-7B's widths (34
    units) in bf16, f32 and int8, dense and paged, and at the dense
    family's (gemma-2b's one kv head of 256, qwen1.5-0.5b's 16 of 64,
    qwen1.5-4b's 40 units of 20 heads).  Returns the one-launch commit's
    max abs errors {"dense", "paged", "int8", "int8+paged"} (bf16 rows at
    openPangu-7B's widths)."""
    for paged in (False, True):
        for dtype, width in ((torch.int8, 128), (torch.bfloat16, 128),
                             (torch.float32, 128), (torch.float32, 1)):
            commit_case(dev, f"{dtype} x {width}", dtype, width, paged)
        if paged:
            commit_case(dev, "page size 16, bf16", torch.bfloat16, 128, paged,
                        ps=16)
    quant_case(dev)
    bf, f32 = torch.bfloat16, torch.float32
    errs = {"dense": path_case(dev, "bf16", 34, 8, 128, bf),
            "paged": path_case(dev, "bf16 paged", 34, 8, 128, bf, ps=64),
            "int8": path_case(dev, "int8", 34, 8, 128, bf, True),
            "int8+paged": path_case(dev, "int8 paged", 34, 8, 128, bf, True,
                                    ps=16)}
    path_case(dev, "stacked", 34, 8, 128, bf, stacked=True)
    path_case(dev, "f32", 34, 8, 128, f32)
    path_case(dev, "f32 int8 paged", 34, 8, 128, f32, True, ps=64)
    path_case(dev, "f32 rows, bf16 cache", 34, 8, 128, f32, cache_dt=bf)
    path_case(dev, "bf16 rows, f32 cache", 34, 8, 128, bf, cache_dt=f32,
              ps=16)
    path_case(dev, "gemma-2b", 18, 1, 256, bf, S=512)
    path_case(dev, "gemma-2b int8 paged", 18, 1, 256, bf, True, ps=64, S=512)
    path_case(dev, "qwen1.5-0.5b int8", 24, 16, 64, bf, True, S=512)
    path_case(dev, "qwen1.5-4b paged", 40, 20, 128, bf, ps=64, S=512)
    path_case(dev, "qwen1.5-4b int8", 40, 20, 128, bf, True, S=512)
    # the MoE and VLM families: granite-moe's 24 units of [8, 64],
    # internvl2's 48 of [8, 128] (phi3.5-moe's 16 served layers of [8,
    # 128] are a subset of openPangu-7B's 34)
    errs["granite-moe-1b-a400m"] = path_case(
        dev, "granite-moe-1b-a400m", 24, 8, 64, bf, S=512)
    path_case(dev, "granite-moe-1b-a400m paged", 24, 8, 64, bf, ps=64,
              S=512)
    path_case(dev, "granite-moe-1b-a400m int8 paged", 24, 8, 64, bf, True,
              ps=16, S=512)
    errs["internvl2-26b"] = path_case(dev, "internvl2-26b", 48, 8, 128, bf,
                                      S=512)
    path_case(dev, "internvl2-26b paged", 48, 8, 128, bf, ps=64, S=512)
    # the hybrid's one attention position a unit (jamba's one-unit cut:
    # one unit of [8, 128]) at the chain step: T 5 in-flight rows, every
    # layout
    jamba = "jamba-1.5-large-398b"
    errs[jamba] = path_case(dev, jamba, 1, 8, 128, bf, T=CHAIN_T, S=512)
    path_case(dev, f"{jamba} paged", 1, 8, 128, bf, T=CHAIN_T, ps=64, S=512)
    path_case(dev, f"{jamba} int8", 1, 8, 128, bf, True, T=CHAIN_T, S=512)
    path_case(dev, f"{jamba} int8 paged", 1, 8, 128, bf, True, T=CHAIN_T,
              ps=16, S=512)
    # the encoder-decoder's self entry: whisper-tiny's 4 decoder units of
    # [6, 64], every layout (its cross k/v is never committed)
    errs[WHISPER] = path_case(dev, WHISPER, 4, 6, 64, bf, S=512)
    path_case(dev, f"{WHISPER} paged", 4, 6, 64, bf, ps=64, S=512)
    path_case(dev, f"{WHISPER} int8", 4, 6, 64, bf, True, S=512)
    path_case(dev, f"{WHISPER} int8 paged", 4, 6, 64, bf, True, ps=16,
              S=512)
    # tensor parallelism: openPangu-7B's 34 units at a rank's kv heads (4
    # at tp 2, 2 at tp 4, and the reduced config's 1), every layout at tp 2
    for label, quantized, ps in (("dense", False, 0), ("paged", False, 64),
                                 ("int8", True, 0), ("int8+paged", True, 16)):
        errs[f"tp {label}"] = path_case(dev, f"tp2 {label}", 34, 4, 128, bf,
                                        quantized, ps=ps)
    path_case(dev, "tp4", 34, 2, 128, bf)
    path_case(dev, "tp4 int8 paged", 34, 2, 128, bf, True, ps=16)
    path_case(dev, "hkv1@tp paged", 34, 1, 128, bf, ps=64, S=512)
    return errs


# ---------------------------------------------------------------------------
# phase 4: float32, full width, 2 layers: spec == AR exactly, fused too
# ---------------------------------------------------------------------------

def expected_counts(cfg, steps: int, ar_steps: int = 0,
                    deferred: bool = False, proposer=None):
    """Launches of each kernel for ``steps`` spec steps and ``ar_steps`` AR
    steps on ``cfg``: K1 once per layer and step; with verify fusion K2
    once per spec step and, on an fp cache, K3 once per layer and step
    (never under ``deferred``, which writes no tree row); the commit once
    per spec step (every unit and cache leaf in one launch, int8 too),
    through K4 on the dense cache and K5 on the paged pool.  Only the
    attention layers count (an SSM layer launches none of these kernels,
    and a stack without attention commits without a launch).  A
    draft-model ``proposer`` adds its gamma + 1 T=1 decodes a step on each of its
    layers: K1 each, and K3 each on its fused fp write side (its cache is
    dense, in the target's cache dtype; ``deferred`` is the target's
    alone).  The encoder-decoder never launches K3: its decode keeps the
    unfused write side, as the reference's does."""
    per_layer = cfg.num_attn_layers * (steps + ar_steps)
    quantized = cfg.resolved_cache_dtype == "int8"
    commits = steps if cfg.num_attn_layers else 0
    fused = cfg.verify_fusion
    t1 = draft_t1_launches(proposer, steps)
    # the encoder-decoder's decode keeps the unfused write side
    unfused_write = quantized or cfg.family == "encdec"
    draft_k3 = t1 if t1 and proposer.dc.verify_fusion and not unfused_write \
        else 0
    return {"K1": per_layer + t1, "K2": steps if fused else 0,
            "K3": (per_layer if fused and not (unfused_write or deferred)
                   else 0) + draft_k3,
            "K4": 0 if cfg.paged else commits,
            "K5": commits if cfg.paged else 0}


def kept_graphs(eng):
    """[(label, StepGraph)] of the step graphs ``eng`` keeps."""
    from repro_torch.core.engine import SpecCarry
    return [("spec" if isinstance(c, SpecCarry) else "AR", g)
            for g, c in eng.step_graphs.kept()]


def phase_graph_rng(dev):
    """The captured step's randomness: a step that draws from a generator
    registered with its capture draws fresh noise at every replay, the
    noise the same steps draw eagerly from the same generator state; a
    capture whose step draws from a generator that is not registered
    raises (no eager fallback), and the card works on after it."""
    from repro_torch import runtime
    from repro_torch.core import sampling as S

    gen = torch.Generator(device=dev).manual_seed(0)
    buf = torch.empty((4, 153376), device=dev)
    graph = runtime.StepGraph(lambda: buf.copy_(S.gumbel(buf.shape, gen)),
                              dev, generators=(gen,))
    seen = []
    for _ in range(5):
        graph()
        seen.append(buf.clone())
    gen.manual_seed(0)
    eager = [S.gumbel(buf.shape, gen) for _ in range(5)]
    same = [torch.equal(a, b) for a, b in zip(seen, eager)]
    fresh = [not torch.equal(a, b) for a, b in zip(seen, seen[1:])]
    log(f"  registered generator: warm-up, capture and {graph.replays} "
        f"replays drew the eager draws {same}; each draw differs from the "
        f"one before {fresh}")
    if not (all(same) and all(fresh)) or graph.replays != 4:
        fail("a captured step's draws are not the eager draws, or a replay "
             "repeated the noise of the one before")
    other = torch.Generator(device=dev).manual_seed(1)
    bad = runtime.StepGraph(lambda: buf.copy_(S.gumbel(buf.shape, other)),
                            dev)
    bad()                                   # the eager warm-up draws
    try:
        bad()
    except RuntimeError as e:
        log(f"  unregistered generator: the capture raised ({e}; cause: "
            f"{str(e.__cause__).splitlines()[0][:160]})")
    else:
        fail("a capture drew from a generator not registered with it and "
             "did not raise")
    if bad.graph is not None or float(torch.ones(8, device=dev).sum()) != 8:
        fail("the card did not work on after the refused capture")


# the seven layout / fusion combinations of phase 4:
# (label, verify_fusion, cache_dtype, cache_layout, page_size)
F32_LAYOUTS = [("dense", False, "", "dense", 64),
               ("verify fusion", True, "", "dense", 64),
               ("paged (page size 64)", False, "", "paged", 64),
               ("paged, verify fusion (page size 16)", True, "", "paged", 16),
               ("int8", False, "int8", "dense", 64),
               ("int8 paged (page size 64)", False, "int8", "paged", 64),
               ("int8, verify fusion", True, "int8", "dense", 64)]


def f32_base():
    """Phase 4's model: float32 openPangu-7B at full width, 2 layers."""
    from repro_torch.configs.registry import get_config
    return dataclasses.replace(get_config("openpangu-7b"), num_layers=2,
                               dtype="float32", param_dtype="float32",
                               name="openpangu-7b-2layer-f32")


def phase_f32(dev):
    """Float32 openPangu-7B at full width, 2 layers, on every cache layout:
    spec == AR token for token through the captured steps, a second run on
    the reused cache replays them without a new capture, and the eager
    steps give the same tokens; launch counts exact on every run.  On
    every layout ``accept="sample"`` at temperature 0 gives the AR tokens
    too; at temperature 0.7 (dense, and with verify fusion) the captured
    sampled step gives the eager step's tokens from the same generator
    seed, and a second run at temperature 0.9 replays the same graph
    with no new capture and again gives the eager tokens."""
    from repro_torch.configs.base import SamplingParams
    from repro_torch.configs.registry import get_config
    from repro_torch.core.engine import ar_generate, build_engine
    from repro_torch.launch.serve import build_model, make_prompts

    base = f32_base()
    params, mp = build_model(base, 1, 4, dev)
    prompts = make_prompts(base.vocab_size, 4, 1, 16, 129)
    tok, plen = padded_batch(prompts, range(4))
    tok = torch.from_numpy(tok).to(dev)
    plen = torch.from_numpy(plen).to(dev)
    max_new, max_len = 32, 512

    def counted_run(label, eng):
        """spec and AR on ``eng``'s cache (its graphs, or eager), the
        counts set to 0 just before and checked just after."""
        reset_counts()
        sp, _, st = eng.generate(params, mp, tok, plen,
                                 eng.init_cache(4, max_len), max_new)
        ar, _ = ar_generate(eng.cfg, params, tok, plen,
                            eng.init_cache(4, max_len), max_new,
                            use_kernel=True, graphs=eng.step_graphs)
        counts = read_counts()
        want = expected_counts(eng.cfg, st.steps, max_new)
        if counts != want:
            fail(f"f32 {label}: launches {counts}, expected {want}")
        ps = eng.cfg.page_size if eng.cfg.paged else 1
        check_routes(f"f32 {label}", None,
                     k1_routes(eng.cfg, 4, -(-max_len // ps) * ps, st.steps,
                               max_new, T=eng.tb.T))
        return sp.cpu(), ar.cpu(), st, counts

    def sampled(cfg, verify_fusion, temperature, graphs=True):
        return build_engine(cfg, "medusa", use_kernel=True, device=dev,
                            verify_fusion=verify_fusion, graphs=graphs,
                            accept="sample", seed=11,
                            sampling=SamplingParams(temperature=temperature))

    def sampled_run(label, eng, **kw):
        """One sampled generate, its launches exact."""
        reset_counts()
        out, n_out, st = eng.generate(params, mp, tok, plen,
                                      eng.init_cache(4, max_len), max_new,
                                      **kw)
        counts = read_counts()
        want = expected_counts(eng.cfg, st.steps)
        if counts != want or not bool((n_out == max_new).all()):
            fail(f"f32 sampled {label}: launches {counts}, expected {want}; "
                 f"n_out {n_out.tolist()}")
        return out.cpu(), st

    def sampled_zero(label, cfg, verify_fusion, ar):
        out, st = sampled_run(label + " at temperature 0",
                              sampled(cfg, verify_fusion, 0.0))
        if not torch.equal(out, ar):
            fail(f"float32 {label}: sampled at temperature 0 != AR:\n"
                 f"{out.tolist()}\n{ar.tolist()}")
        log(f"  f32 {label}: accept=sample at temperature 0 == AR for 4 x "
            f"{max_new} tokens ({st.steps} steps, launches exact)")

    def sampled_hot(label, cfg, verify_fusion, greedy):
        eng, eager = (sampled(cfg, verify_fusion, 0.7, g)
                      for g in (True, False))
        out, st = sampled_run(label + " at 0.7", eng)
        e_out, _ = sampled_run(label + " at 0.7 (eager)", eager)
        graphs = kept_graphs(eng)
        replays = {k: g.replays for k, g in graphs}
        out2, st2 = sampled_run(label + " at 0.9 (second run)", eng,
                                temperature=0.9)
        e_out2, _ = sampled_run(label + " at 0.9 (eager, second run)", eager,
                                temperature=0.9)
        again = {k: g.replays - replays[k] for k, g in kept_graphs(eng)}
        log(f"  f32 {label}: sampled at temperature 0.7, graph == eager "
            f"{torch.equal(out, e_out)} ({int((out != greedy).sum())} of "
            f"{out.numel()} tokens differ from greedy; {st.steps} steps); "
            f"a second run at 0.9 on the same engine replayed {again} "
            f"({st2.steps} steps), graph == eager {torch.equal(out2, e_out2)}"
            f"; capture {eng.step_graphs.capture_s:.3f}s")
        if not (torch.equal(out, e_out) and torch.equal(out2, e_out2)):
            fail(f"float32 {label}: sampled graph tokens != eager tokens from "
                 f"the same generator seed:\n{out.tolist()}\n"
                 f"{e_out.tolist()}\n{out2.tolist()}\n{e_out2.tolist()}")
        if again != {"spec": st2.steps} or len(kept_graphs(eng)) != 1:
            fail(f"float32 {label}: the second sampled run replayed {again}, "
                 f"expected {st2.steps} spec replays and no new capture")

    def run(label, verify_fusion=False, hot=False, **layout):
        cfg = dataclasses.replace(base, **layout)
        eng, eager = (build_engine(cfg, "medusa", use_kernel=True, device=dev,
                                   verify_fusion=verify_fusion, graphs=g)
                      for g in (True, False))
        sp, ar, st, counts = counted_run(label, eng)
        if not torch.equal(sp, ar):
            fail(f"float32 {label}: spec != AR:\nspec {sp.tolist()}\n"
                 f"AR   {ar.tolist()}")
        graphs = kept_graphs(eng)
        if sorted(k for k, g in graphs if g.graph is not None) != ["AR",
                                                                   "spec"]:
            fail(f"f32 {label}: captured {[k for k, _ in graphs]}, expected "
                 f"one spec and one AR graph")
        replays = {k: g.replays for k, g in graphs}
        sp2, ar2, st2, _ = counted_run(label + " (second run)", eng)
        again = {k: g.replays - replays[k] for k, g in kept_graphs(eng)}
        if again != {"spec": st2.steps, "AR": max_new} \
                or len(kept_graphs(eng)) != 2:
            fail(f"f32 {label}: the second run on the reused cache replayed "
                 f"{again}, expected {st2.steps} spec and {max_new} AR "
                 f"replays and no new capture")
        spe, are, _, _ = counted_run(label + " (eager)", eager)
        for what, out in (("second run", sp2), ("second run AR", ar2),
                          ("eager", spe), ("eager AR", are)):
            if not torch.equal(out, sp):
                fail(f"float32 {label}: graph spec != {what}:\n"
                     f"{sp.tolist()}\n{out.tolist()}")
        mean_acc = st.accepted_sum.item() / (st.steps * 4)
        capture_s = eng.step_graphs.capture_s
        log(f"  f32 full width, 2 layers, {label}: graph spec == graph AR == "
            f"eager spec == eager AR for 4 x {max_new} tokens; {st.steps} "
            f"spec steps (mean accepted {mean_acc:.3f}), {max_new} AR steps; "
            f"launches {counts} (exact on the graph runs and the eager run); "
            f"a second run on the reused cache replayed {again} with no new "
            f"capture; capture {capture_s:.3f}s")
        sampled_zero(label, cfg, verify_fusion, ar)
        if hot:
            sampled_hot(label, cfg, verify_fusion, sp)
        return sp

    # sampled at 0.7 too on the fp dense cache, unfused and fused
    outs = {label: run(label, verify_fusion=vf,
                       hot=not dtype and layout == "dense",
                       cache_dtype=dtype, cache_layout=layout, page_size=ps)
            for label, vf, dtype, layout, ps in F32_LAYOUTS}
    want = {"": outs["dense"], "int8": outs["int8"]}
    sp, int8 = want[""], want["int8"]
    for label, vf, dtype, layout, ps in F32_LAYOUTS:
        if not torch.equal(outs[label], want[dtype]):
            fail(f"float32 {label} spec != {dtype or 'fp'} dense spec:\n"
                 f"{outs[label].tolist()}\n{want[dtype].tolist()}")
    log(f"  f32: fused, paged and fused paged spec == dense spec; int8 "
        f"paged and int8 fused spec == int8 spec "
        f"({int(torch.sum(int8 == sp))} of {sp.numel()} int8 tokens equal "
        f"to the fp ones)")
    return dict(base=base, params=params, mp=mp, tok=tok, plen=plen,
                max_new=max_new, max_len=max_len, want=want)


def phase_f32_deferred(dev, f32):
    """Phase 4d: the deferred engine (``deferred=True``: no tree-row cache
    write; commit the only one) on phase 4's weights and prompts, on its
    seven layout / fusion combinations: deferred spec == the non-deferred
    spec of phase 4 (== AR there) token for token, through the captured
    step, a second run on the reused cache (every step replayed, no new
    capture) and the eager step; launches exact on every run: K1 once a
    layer and step, K2 once a fused step, the commit once a step, K3
    never."""
    from repro_torch.core.engine import build_engine

    params, mp, tok, plen = (f32[k] for k in ("params", "mp", "tok", "plen"))
    max_new, max_len = f32["max_new"], f32["max_len"]

    def counted_run(label, eng):
        reset_counts()
        sp, _, st = eng.generate(params, mp, tok, plen,
                                 eng.init_cache(4, max_len), max_new)
        counts = read_counts()
        want = expected_counts(eng.cfg, st.steps, deferred=True)
        if counts != want or counts["K3"]:
            fail(f"f32 deferred {label}: launches {counts}, expected {want}")
        ps = eng.cfg.page_size if eng.cfg.paged else 1
        check_routes(f"f32 deferred {label}", None,
                     k1_routes(eng.cfg, 4, -(-max_len // ps) * ps, st.steps,
                               T=eng.tb.T))
        return sp.cpu(), st, counts

    for label, vf, dtype, layout, ps in F32_LAYOUTS:
        cfg = dataclasses.replace(f32["base"], cache_dtype=dtype,
                                  cache_layout=layout, page_size=ps)
        eng, eager = (build_engine(cfg, "medusa", use_kernel=True, device=dev,
                                   verify_fusion=vf, graphs=g, deferred=True)
                      for g in (True, False))
        sp, st, counts = counted_run(label, eng)
        (_, graph), = kept_graphs(eng)
        replays = graph.replays
        sp2, st2, _ = counted_run(label + " (second run)", eng)
        again = graph.replays - replays
        if again != st2.steps or len(kept_graphs(eng)) != 1 \
                or graph.graph is None:
            fail(f"f32 deferred {label}: the second run replayed {again} "
                 f"steps, expected {st2.steps} and no new capture")
        spe, _, _ = counted_run(label + " (eager)", eager)
        want = f32["want"][dtype]
        for what, out in (("non-deferred spec (phase 4, == AR)", want),
                          ("second run", sp2), ("eager", spe)):
            if not torch.equal(sp, out):
                fail(f"float32 deferred {label}: spec != {what}:\n"
                     f"{sp.tolist()}\n{out.tolist()}")
        log(f"  f32 deferred, {label}: graph == second run == eager == "
            f"phase 4's spec and AR for 4 x {max_new} tokens; {st.steps} "
            f"steps, launches {counts} (exact, K3 0); the second run "
            f"replayed {again} steps with no new capture; capture "
            f"{eng.step_graphs.capture_s:.3f}s")


# the chain proposers' layouts in phase 4e: (label, cache_dtype,
# cache_layout, page_size)
CHAIN_LAYOUTS = [("dense", "", "dense", 64), ("int8", "int8", "dense", 64),
                 ("paged (page size 64)", "", "paged", 64),
                 ("int8 paged (page size 16)", "int8", "paged", 16)]


def truncated(params, layers: int):
    """The first ``layers`` units of ``params`` beside its embedding, final
    norm and lm head (views, no copy): a draft made of the target's own
    first layers, whose weights cost no memory.  (At full width with
    random weights it rarely agrees with the target: the self-draft is
    the run where every proposal is accepted.)"""
    from repro_torch.runtime import tree_map

    return dict(params, units=tree_map(lambda t: t[:layers],
                                       params["units"]))


def phase_chain_f32(dev, f32):
    """Phase 4e: the chain proposers on phase 4's weights and prompts
    (float32 openPangu-7B, full width, 2 layers).  For ``draft`` (the
    target's first layer as a 1-layer draft) and ``ngram``, on the dense,
    int8, paged and int8 + paged caches, unfused and with verify fusion,
    greedy and ``accept="sample"`` at temperature 0: spec == phase 4's AR
    tokens, token for token, through the captured step (one capture, the
    rest replays), launches exact (the target's chain of T 5, the draft's
    gamma + 1 T=1 decodes a step) and K1 on the routes ``decode_plan``
    gives (R 24 for the target, R 8 for the draft); deferred on the dense
    cache, unfused and fused, too.  Then a self-draft (the target's own
    config and weights as the draft): every proposal accepted, steps <=
    ceil(new / (gamma + 1)) + 1, tokens == AR."""
    from repro_torch.configs.base import SamplingParams
    from repro_torch.core.engine import build_engine

    base, params, tok, plen = (f32[k] for k in ("base", "params", "tok",
                                                "plen"))
    max_new, max_len = f32["max_new"], f32["max_len"]

    def run(label, kind, cfg, pp, **kw):
        eng = build_engine(cfg, kind, gamma=GAMMA, use_kernel=True,
                           device=dev, sampling=SamplingParams(temperature=0.0),
                           **kw)
        reset_counts()
        out, n_out, st = eng.generate(params, pp, tok, plen,
                                      eng.init_cache(4, max_len), max_new)
        counts = read_counts()
        want = expected_counts(eng.cfg, st.steps, deferred=eng.deferred,
                               proposer=eng.proposer)
        graphs = kept_graphs(eng)
        replays = sum(g.replays for _, g in graphs)
        if counts != want or not bool((n_out == max_new).all()):
            fail(f"f32 chain {label}: launches {counts}, expected {want}; "
                 f"n_out {n_out.tolist()}")
        if [k for k, g in graphs if g.graph is not None] != ["spec"] \
                or replays != st.steps - 1:
            fail(f"f32 chain {label}: {[(k, g.replays) for k, g in graphs]}"
                 f" for {st.steps} steps: not one capture and replays")
        ps = cfg.page_size if cfg.paged else 1
        check_routes(f"f32 chain {label}", None,
                     k1_routes(eng.cfg, 4, -(-max_len // ps) * ps, st.steps,
                               T=eng.tb.T, proposer=eng.proposer))
        ar = f32["want"][cfg.cache_dtype]
        out = out.cpu()
        if not torch.equal(out, ar):
            fail(f"float32 chain {label}: spec != AR:\n{out.tolist()}\n"
                 f"{ar.tolist()}")
        log(f"  f32 chain {label}: spec == AR for 4 x {max_new} tokens; "
            f"{st.steps} steps, "
            f"{(st.tokens_out - 1).sum().item() / (st.steps * 4):.3f} tokens a "
            f"step and slot; launches {counts} (exact); one capture "
            f"({eng.step_graphs.capture_s:.3f}s), {replays} replays")
        return st

    for kind, pp, extra in (("draft", truncated(params, 1),
                             dict(draft_layers=1)),
                            ("ngram", None, {})):
        for label, dtype, layout, ps in CHAIN_LAYOUTS:
            cfg = dataclasses.replace(base, cache_dtype=dtype,
                                      cache_layout=layout, page_size=ps)
            for vf in (False, True):
                for accept in ("greedy", "sample"):
                    what = (f"{kind} {label}"
                            + (", verify fusion" if vf else "")
                            + (", sampled at temperature 0"
                               if accept == "sample" else ""))
                    run(what, kind, cfg, pp, verify_fusion=vf, accept=accept,
                        **extra)
        for vf in (False, True):
            run(f"{kind} dense, deferred" + (", verify fusion" if vf else ""),
                kind, base, pp, verify_fusion=vf, deferred=True, **extra)
    st = run("self-draft (the target's config and weights as the draft)",
             "draft", base, params, draft_cfg=base)
    bound = -(-max_new // CHAIN_T) + 1
    log(f"  self-draft: {st.steps} steps for {max_new} tokens (bound "
        f"{bound})")
    if st.steps > bound:
        fail(f"self-draft took {st.steps} steps for {max_new} tokens, more "
             f"than {bound}: a proposal of the target itself was rejected")


def phase_tvd(dev):
    """The reference's tiny-vocabulary distribution gate on the card:
    openPangu-7B's widths in float32, 2 layers, a 16-token vocabulary,
    1024 rows of one 4-token prompt, 5 new tokens at temperature 0.9,
    through K1, K2 (fused), K3 (fused) and K4: the Medusa tree walk (a
    cartesian (2, 2) tree with untrained heads: heavy rejection) and the
    draft model's chain walk (a 1-layer draft of other random weights,
    gamma 4, its chain sampled from its own warped logits).  The sampled
    speculative tokens must meet ``TVD <= 1.5 * floor + 0.05`` against
    ``ar_generate_sampled``, the floor being the TVD of two AR runs of
    other seeds, unfused and fused."""
    from repro_torch.configs.base import SamplingParams
    from repro_torch.configs.registry import get_config
    from repro_torch.core import medusa as M
    from repro_torch.core import sampling as S
    from repro_torch.core.engine import (SpecEngine, ar_generate_sampled,
                                         build_engine)
    from repro_torch.core.tree import cartesian_tree
    from repro_torch.models.api import get_model

    cfg = dataclasses.replace(get_config("openpangu-7b"), num_layers=2,
                              vocab_size=16, dtype="float32",
                              param_dtype="float32",
                              name="openpangu-7b-2layer-f32-v16")
    gen = torch.Generator(device=dev).manual_seed(2)
    params = get_model(cfg).init_params(gen, cfg, dtype=cfg.dtype)
    tb = cartesian_tree((2, 2))
    mp = M.init_medusa(gen, cfg, tb.K)
    mp["w1"].normal_(generator=gen).mul_(0.1)
    B, new = 1024, 5
    tok = torch.randint(0, cfg.vocab_size, (1, 4), generator=gen, device=dev,
                        dtype=torch.int32).expand(B, 4).contiguous()
    plen = torch.full((B,), 4, dtype=torch.int32, device=dev)
    max_len = 4 + new + tb.T + 8
    sp = SamplingParams(temperature=0.9)
    dparams = None
    for walk in ("tree", "chain"):
        for fused in (False, True):
            c = dataclasses.replace(cfg, verify_fusion=fused)
            if walk == "tree":
                eng = SpecEngine(c, tb, use_kernel=True, device=dev,
                                 accept="sample", sampling=sp, seed=21)
                pp = mp
            else:
                eng = build_engine(c, "draft", draft_layers=1, gamma=GAMMA,
                                   use_kernel=True, device=dev,
                                   accept="sample", sampling=sp, seed=24)
                if dparams is None:
                    dc = eng.proposer.dc
                    dparams = get_model(dc).init_params(gen, dc,
                                                        dtype=dc.dtype)
                pp = dparams
            label = f"{walk} walk, {'fused' if fused else 'unfused'}"
            reset_counts()
            spec, n_out, st = eng.generate(params, pp, tok, plen,
                                           eng.init_cache(B, max_len), new)
            counts = read_counts()
            want = expected_counts(eng.cfg, st.steps, proposer=eng.proposer)
            if counts != want or not bool((n_out == new).all()):
                fail(f"TVD gate, {label}: launches {counts}, expected "
                     f"{want}")
            ar1, ar2 = (ar_generate_sampled(
                c, params, tok, plen, eng.init_cache(B, max_len), new,
                torch.Generator(device=dev).manual_seed(s), sp,
                use_kernel=True, graphs=eng.step_graphs)[0].cpu()
                for s in (22, 23))
            floor = S.max_marginal_tvd(ar1, ar2, c.vocab_size)
            tvd = S.max_marginal_tvd(spec.cpu(), ar1, c.vocab_size)
            more = int((st.tokens_out > st.steps + 1).sum())
            log(f"  TVD gate, {label}: {B} rows x {new} tokens at "
                f"temperature 0.9, {st.steps} spec steps ({more} rows took "
                f"more than a token a step), launches {counts}: max "
                f"marginal TVD spec vs AR {tvd:.4f}, AR vs AR floor "
                f"{floor:.4f}, bound {1.5 * floor + 0.05:.4f}")
            if not tvd <= 1.5 * floor + 0.05:
                fail(f"sampled spec tokens are not distributed as sampled "
                     f"AR's ({label}): TVD {tvd} > 1.5 * {floor} + 0.05")


def phase_family_f32(dev):
    """The dense family at full width in float32, 2 layers: for each of
    granite-8b, qwen1.5-0.5b, qwen1.5-4b and gemma-2b, speculative
    ``generate`` == ``ar_generate`` token for token through the captured
    steps, unfused and with verify fusion, every kernel launched exactly
    as ``expected_counts`` says and K1 on the routes ``decode_plan``
    gives; for qwen1.5-0.5b and gemma-2b the same on the int8, paged and
    int8 + paged caches, the fp layouts giving the dense tokens and the
    int8 ones the int8 tokens."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core.engine import ar_generate, build_engine
    from repro_torch.launch.serve import build_model, make_prompts

    layouts = {"dense": {}, "int8": dict(cache_dtype="int8"),
               "paged": dict(cache_layout="paged", page_size=64),
               "int8+paged": dict(cache_dtype="int8", cache_layout="paged",
                                  page_size=16)}
    max_new, max_len = 32, 512
    for arch in FAMILY:
        base = dataclasses.replace(get_config(arch), num_layers=2,
                                   dtype="float32", param_dtype="float32",
                                   name=f"{arch}-2layer-f32")
        params, mp = build_model(base, 1, 4, dev)
        prompts = make_prompts(base.vocab_size, 4, 1, 16, 129)
        tok, plen = (torch.from_numpy(a).to(dev)
                     for a in padded_batch(prompts, range(4)))
        firsts = {}
        names = layouts if arch in ALL_LAYOUTS_FAMILY else ["dense"]
        for name in names:
            for vf in (False, True):
                cfg = dataclasses.replace(base, **layouts[name])
                label = f"{arch} {name}" + (", verify fusion" if vf else "")
                eng = build_engine(cfg, "medusa", use_kernel=True,
                                   device=dev, verify_fusion=vf)
                reset_counts()
                sp, _, st = eng.generate(params, mp, tok, plen,
                                         eng.init_cache(4, max_len), max_new)
                ar, _ = ar_generate(eng.cfg, params, tok, plen,
                                    eng.init_cache(4, max_len), max_new,
                                    use_kernel=True, graphs=eng.step_graphs)
                counts = read_counts()
                want = expected_counts(eng.cfg, st.steps, max_new)
                if counts != want:
                    fail(f"f32 {label}: launches {counts}, expected {want}")
                ps = cfg.page_size if cfg.paged else 1
                check_routes(f"f32 {label}", None,
                             k1_routes(eng.cfg, 4, -(-max_len // ps) * ps,
                                       st.steps, max_new, T=eng.tb.T))
                sp, ar = sp.cpu(), ar.cpu()
                if not torch.equal(sp, ar):
                    fail(f"float32 {label}: spec != AR:\nspec {sp.tolist()}"
                         f"\nAR   {ar.tolist()}")
                kind = "int8" if "int8" in name else "fp"
                firsts.setdefault(kind, sp)
                if not torch.equal(sp, firsts[kind]):
                    fail(f"float32 {label}: spec differs from the {kind} "
                         f"dense cache's tokens")
                mean_acc = st.accepted_sum.item() / (st.steps * 4)
                log(f"  f32 {label} (full width, 2 layers): graph spec == "
                    f"graph AR for 4 x {max_new} tokens; {st.steps} spec "
                    f"steps (mean accepted {mean_acc:.3f}); launches {counts}"
                    f" (exact)")
                del eng
        del params, mp
        torch.cuda.empty_cache()


def phase_family_serve(dev):
    """The launcher at full width and depth in bf16 on granite-8b,
    qwen1.5-0.5b, qwen1.5-4b and gemma-2b (``--arch``): the same 8
    requests through the captured step, unfused and with
    ``--verify-fusion`` on the same weights, launches exact (every K2 and
    K3 launch on the wgmma route, at most one tensor map a weight), each
    answer held to ``ar_generate`` under ``near_tie``;
    gemma-2b also with ``--accept sample --temperature 0 --verify-fusion``,
    whose 8 answers must equal fused greedy's.  Logs each run's tokens/s,
    steps, mean accepted length, capture seconds and peak memory.
    Returns {arch: the fused run's launch counts}."""
    out = {}
    for arch in FAMILY:
        argv = SERVE_ARGV + ["--arch", arch]
        log(f"  ({arch}) --arch {arch}")
        torch.cuda.reset_peak_memory_stats()
        srv, _ = serve_counted(argv)
        check_against_ar(srv, dev)
        weights = (srv.params, srv.proposer_params)
        log(f"  ({arch}) --arch {arch} --verify-fusion")
        enc0 = map_encodings()
        fsrv, counts = serve_counted(argv + ["--verify-fusion"], weights)
        enc = {k: n - enc0[k] for k, n in map_encodings().items()}
        limit = {"K2": 1, "K3": 3 * fsrv.cfg.num_layers}
        log(f"  weight tensor maps encoded over the run: {enc} (at most "
            f"{limit})")
        if any(enc[k] > limit[k] for k in enc):
            fail(f"{arch}: tensor maps encoded {enc}, more than one per "
                 f"weight tensor {limit}")
        check_against_ar(fsrv, dev)
        if arch == "gemma-2b":
            log(f"  ({arch}) --verify-fusion --accept sample --temperature 0")
            zero, _ = serve_counted(argv + ["--verify-fusion", "--accept",
                                            "sample", "--temperature", "0"],
                                    weights)
            same = same_answers(zero, fsrv)
            log(f"  {same} of {REQUESTS} answers at temperature 0 "
                f"token-identical to fused greedy's")
            if same != REQUESTS:
                fail(f"{arch} sampled at temperature 0: {same} of {REQUESTS} "
                     f"answers equal to greedy's")
            del zero

        def summary(run):
            wall, dev_ms = step_times(run.engine)
            return (f"{run_summary(run)}, replayed step wall {wall:.3f} ms, "
                    f"device {dev_ms:.3f} ms (idle {1 - dev_ms / wall:.3f})")
        log(f"  {arch}: unfused {summary(srv)}; fused {summary(fsrv)}; "
            f"{same_answers(fsrv, srv)} of {REQUESTS} fused answers equal to "
            f"unfused; peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        out[arch] = counts
        del srv, fsrv, weights
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phases 4m and 14: the MoE and VLM families
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def served_config(fn):
    """The launcher serves ``fn(config)`` for every ``--arch``
    (``serve.get_config`` patched): how its MoE runs take the no-drop
    capacity factor, for which the launcher has no flag (the reference's
    has none either)."""
    from repro_torch.launch import serve

    real = serve.get_config
    serve.get_config = lambda arch, reduced=False: fn(real(arch, reduced))
    try:
        yield
    finally:
        serve.get_config = real


class DropMeter:
    """The share of (token, expert) assignments the MoE drops, counted on
    the card inside the captured steps: while entered, ``layers.moe_route``
    is wrapped so each call adds its kept assignments (the dispatch mask's
    sum) and its offered ones (tokens x K, padding rows included, as the
    capacity counts them) to two device counters kept per group shape
    (G, s).  The adds are kernels of their own, captured with the step and
    replayed with it; nothing is read until ``line``."""

    def __init__(self):
        self.kept, self.offered = {}, {}

    def __enter__(self):
        from repro_torch.models import layers as L

        self.layers, self.real = L, L.moe_route

        def route(p, xg, cfg):
            out = self.real(p, xg, cfg)
            key = tuple(xg.shape[:2])
            if key not in self.kept:
                self.kept[key] = torch.zeros((), dtype=torch.float64,
                                             device=xg.device)
                self.offered[key] = torch.zeros_like(self.kept[key])
            self.kept[key].add_(out[0].sum(dtype=torch.float32))
            self.offered[key].add_(xg.shape[0] * xg.shape[1]
                                   * cfg.experts_per_tok)
            return out

        L.moe_route = route
        return self

    def __exit__(self, *exc):
        self.layers.moe_route = self.real

    def share(self, key) -> float:
        return 1 - float(self.kept[key]) / float(self.offered[key])

    def line(self) -> str:
        return "; ".join(
            f"groups {g} x {s} tokens: {self.share((g, s)):.4f} of "
            f"{float(self.offered[g, s]):.0f} assignments dropped"
            for g, s in sorted(self.kept, key=lambda k: -k[0] * k[1]))


def router_gap(cfg, params, tok, plen, prefix, extra) -> str:
    """At a MoE answer's first divergence from AR: the f32 router's
    smallest gap between its K-th and (K+1)-th expert logit over the
    layers, at the token whose logits the two paths part on (the last of
    the prompt and ``prefix``, the answer's tokens both paths share),
    from a bf16 prefill of that sequence (``tok`` [1, S] right-padded,
    ``plen`` [1] counting ``extra``'s prefix rows).  A gap near the
    rounding of bf16 hidden states is a routing flip's witness: the spec
    and AR steps may route that token apart."""
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as TT

    dev = tok.device
    n = int(plen[0]) - (0 if extra is None else extra.shape[1])
    seq = torch.cat([tok[0, :n], prefix.to(dev, tok.dtype)])[None]
    lens = plen + len(prefix)
    seen = []
    real = L.moe_route

    def route(p, xg, c):
        out = real(p, xg, c)
        seen.append(out[2].reshape(-1, out[2].shape[-1]))
        return out

    dense = dataclasses.replace(cfg, cache_dtype="", cache_layout="dense")
    L.moe_route = route
    try:
        TT.prefill(params, dense, seq, lens,
                   TT.init_cache(dense, 1, -(-int(lens[0]) // 64) * 64,
                                 device=dev), extra_embeds=extra)
    finally:
        L.moe_route = real
    K, at = cfg.experts_per_tok, int(lens[0]) - 1
    gaps = [float(t[0] - t[1]) for t in
            (torch.topk(rl[at], K + 1).values[K - 1:] for rl in seen)]
    layer = int(np.argmin(gaps))
    return (f"; the f32 router's smallest top-{K} gap at the parting token "
            f"{gaps[layer]:.6f} (layer {layer}; median over layers "
            f"{float(np.median(gaps)):.4f})")


def phase_moe_vlm_f32(dev):
    """Phase 4m: granite-moe-1b-a400m, phi3.5-moe-42b-a6.6b and
    internvl2-26b in float32 at full width, 2 layers, at the no-drop
    capacity factor (``no_drop``): speculative ``generate`` ==
    ``ar_generate`` token for token through the captured steps, unfused
    and with verify fusion, every kernel launched exactly as
    ``expected_counts`` says and K1 on the routes ``decode_plan`` gives;
    granite-moe also on the int8 + paged cache; internvl2 with its
    256-row frontend prefix (``frontend_embeds``) ahead of every prompt,
    in a 1024-row cache."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core.engine import ar_generate, build_engine
    from repro_torch.launch.serve import build_model, make_prompts
    from repro_torch.models.frontends import frontend_embeds

    max_new = 32
    for arch in MOE_VLM:
        base = dataclasses.replace(no_drop(get_config(arch)), num_layers=2,
                                   dtype="float32", param_dtype="float32",
                                   name=f"{arch}-2layer-f32")
        params, mp = build_model(base, 1, 4, dev)
        prompts = make_prompts(base.vocab_size, 4, 1, 16, 129)
        tok, plen = (torch.from_numpy(a).to(dev)
                     for a in padded_batch(prompts, range(4)))
        extra, max_len = None, 512
        if base.frontend:
            extra = frontend_embeds(base, 4,
                                    torch.Generator(device=dev).manual_seed(2))
            plen, max_len = plen + base.frontend_len, 1024
        layouts = [("dense", {})]
        if arch == "granite-moe-1b-a400m":
            layouts.append(("int8+paged", dict(cache_dtype="int8",
                                               cache_layout="paged",
                                               page_size=16)))
        for name, kw in layouts:
            for vf in (False, True):
                cfg = dataclasses.replace(base, **kw)
                label = f"{arch} {name}" + (", verify fusion" if vf else "")
                eng = build_engine(cfg, "medusa", use_kernel=True,
                                   device=dev, verify_fusion=vf)
                reset_counts()
                sp, _, st = eng.generate(params, mp, tok, plen,
                                         eng.init_cache(4, max_len), max_new,
                                         extra_embeds=extra)
                ar, _ = ar_generate(eng.cfg, params, tok, plen,
                                    eng.init_cache(4, max_len), max_new,
                                    use_kernel=True, graphs=eng.step_graphs,
                                    extra_embeds=extra)
                counts = read_counts()
                want = expected_counts(eng.cfg, st.steps, max_new)
                if counts != want:
                    fail(f"f32 {label}: launches {counts}, expected {want}")
                ps = cfg.page_size if cfg.paged else 1
                check_routes(f"f32 {label}", None,
                             k1_routes(eng.cfg, 4, -(-max_len // ps) * ps,
                                       st.steps, max_new, T=eng.tb.T))
                replays = [(k, g.replays) for k, g in kept_graphs(eng)]
                sp, ar = sp.cpu(), ar.cpu()
                if not torch.equal(sp, ar):
                    fail(f"float32 {label}: spec != AR:\nspec {sp.tolist()}"
                         f"\nAR   {ar.tolist()}")
                mean_acc = st.accepted_sum.item() / (st.steps * 4)
                prefix = (f", a {base.frontend_len}-row prefix"
                          if extra is not None else "")
                log(f"  f32 {label} (full width, 2 layers, capacity factor "
                    f"{cfg.capacity_factor}{prefix}): graph spec == graph "
                    f"AR for 4 x {max_new} tokens; {st.steps} spec steps "
                    f"(mean accepted {mean_acc:.3f}); graph replays "
                    f"{replays}; launches {counts} (exact)")
                del eng
        del params, mp
        torch.cuda.empty_cache()


def serve_prefix(engine, params, mp, prompts, extras):
    """``serve.serve_static`` with a frontend prefix: the groups of
    ``SLOTS`` requests through ``engine.generate``, group g's prompts after
    ``extras[g]`` [SLOTS, F, fd] (the lengths count its F rows).  Returns
    the launcher's ``Served``."""
    from repro_torch.launch.serve import Served

    F = extras[0].shape[1]
    results = []
    torch.cuda.synchronize()
    capture0 = engine.step_graphs.capture_s
    t0 = time.perf_counter()
    for g in range(0, REQUESTS, SLOTS):
        rows = list(range(g, g + SLOTS))
        tok, plen = padded_batch(prompts, rows)
        out, n_out, stats = engine.generate(
            params, mp, torch.from_numpy(tok).to(engine.device),
            torch.from_numpy(plen + F).to(engine.device),
            engine.init_cache(SLOTS, MAX_LEN), MAX_NEW,
            extra_embeds=extras[g // SLOTS])
        out, n_out = out.cpu().numpy(), n_out.cpu().numpy()
        acc = stats.accepted_per_slot.cpu().numpy()
        for j, i in enumerate(rows):
            results.append({"rid": i, "prompt_len": len(prompts[i]),
                            "status": "done", "output": out[j, :n_out[j]],
                            "steps": stats.steps, "accepted": int(acc[j])})
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    tokens = sum(len(r["output"]) for r in results)
    return Served(engine.cfg, engine, params, mp, prompts, results, seconds,
                  tokens, engine.step_graphs.capture_s - capture0)


def static_counted(engine, params, mp, prompts, extras=None):
    """``serve_static`` (or ``serve_prefix`` with ``extras``) on an engine
    built here, with the counts set to 0 just before it and read just
    after, checked as ``serve_counted`` checks the launcher's."""
    from repro_torch.launch.serve import Served, serve_static

    reset_counts()
    if extras is None:
        res = serve_static(engine, params, mp, prompts, SLOTS, MAX_NEW,
                           MAX_LEN)
        srv = Served(engine.cfg, engine, params, mp, prompts, *res)
    else:
        srv = serve_prefix(engine, params, mp, prompts, extras)
    counts = read_counts()
    check_served(srv, counts)
    steps = sum(srv.results[g]["steps"] for g in range(0, REQUESTS, SLOTS))
    check_routes(srv.cfg.name, counts if srv.cfg.verify_fusion else None,
                 k1_routes(srv.cfg, SLOTS, MAX_LEN, steps, T=engine.tb.T),
                 stats_route(srv.cfg))
    return srv, counts


def run_summary(run) -> str:
    """tokens/s, steps, mean accepted length and capture seconds of a
    static run."""
    steps = sum(run.results[g]["steps"] for g in range(0, REQUESTS, SLOTS))
    acc = (sum(r["accepted"] for r in run.results)
           / sum(r["steps"] for r in run.results))
    return (f"{run.tokens / run.seconds:.1f} tok/s "
            f"({run.tokens / (run.seconds - run.capture_s):.1f} without the "
            f"capture), {steps} steps, mean accepted {acc:.3f}, capture "
            f"{run.capture_s:.3f}s")


def server_counted(argv, weights):
    """One launcher run through the continuous-batching server (16
    requests, max_new 16..64, 4 slots) with the counts set to 0 just
    before it and read just after: every request finished, launches
    exact (``serve_expected``), one graph per level."""
    from repro_torch.launch import serve

    reset_counts()
    served = serve.main(argv + ["--requests", "16", "--slots", str(SLOTS),
                                "--max-len", str(MAX_LEN), "--min-new", "16",
                                "--max-new", str(MAX_NEW), "--min-prompt",
                                "64", "--max-prompt", "257", "--seed",
                                str(SEED)], weights=weights)
    counts = read_counts()
    want = serve_expected(served.server)
    label = " ".join(argv)
    if counts != want:
        fail(f"server {label}: launches {counts}, expected {want}")
    if served.cfg.verify_fusion:
        check_routes(f"server {label}", counts, None, stats_route(served.cfg))
    caps = check_server_graphs(f"server {label}", served.server)
    if any(r["status"] != "done" or len(r["output"]) != r["max_new"]
           for r in served.results):
        fail(f"server {label}: not every request finished")
    log(f"  server {label}: {served.tokens} tokens in {served.seconds:.3f}s "
        f"= {served.tokens / served.seconds:.1f} tok/s; "
        f"{latency_line(served.results)}; {served.iterations} iterations; "
        f"capture s by level { {g: round(x, 3) for g, x in caps.items()} }; "
        f"launches {counts} (exact)")
    return served


def phase_moe_vlm_serve(dev):
    """Phase 14: the MoE and VLM families in bf16 at full width.

    granite-moe-1b-a400m (24 layers, full depth) through the launcher:
    at the no-drop capacity factor (``served_config(no_drop)``) with
    ``--static``, unfused and ``--verify-fusion`` on the same weights
    (launches exact, K2 and K3 on wgmma, K2 over the pitched head), and
    through the server (16 requests), unfused and fused, every answer held
    to ``ar_generate`` under ``near_tie``; then at the config's own 1.25
    the same four runs reported, not held (a token dropped in the verify
    forward and not in AR changes the logits): answers equal to AR, drop
    share per step shape (``DropMeter``), tokens/s, accepted length.
    internvl2-26b (48 layers, ~40 GB) through ``SpecEngine.generate`` with
    a 256-row frontend prefix per request, unfused and fused, held to AR
    under ``near_tie``; then through the launcher with text only, fused.
    phi3.5-moe-42b-a6.6b cut to ``PHI_LAYERS`` of its 32 layers through
    ``build_engine`` (the static path): no-drop unfused and fused, held to
    AR; 1.25 fused, reported.  A MoE's divergences log ``router_gap``.
    Returns {arch: the fused no-drop static run's launch counts}."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core.engine import build_engine
    from repro_torch.launch.serve import build_model, make_prompts
    from repro_torch.models.frontends import frontend_embeds

    out = {}
    arch = "granite-moe-1b-a400m"
    argv = SERVE_ARGV + ["--arch", arch]
    torch.cuda.reset_peak_memory_stats()
    with served_config(no_drop):
        log(f"  ({arch}) --arch {arch} --static, capacity factor E / K "
            f"(no drop)")
        srv, _ = serve_counted(argv)
        check_against_ar(srv, dev)
        weights = (srv.params, srv.proposer_params)
        log(f"  ({arch}) --verify-fusion, no drop")
        fsrv, out[arch] = serve_counted(argv + ["--verify-fusion"], weights)
        check_against_ar(fsrv, dev)
        log(f"  {arch} no drop: unfused {run_summary(srv)}; fused "
            f"{run_summary(fsrv)}; peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        for flags in ([], ["--verify-fusion"]):
            served = server_counted(["--arch", arch] + flags, weights)
            check_server_against_ar(f"{arch} server {flags} no drop",
                                    served, dev)
    for flags in ([], ["--verify-fusion"]):
        with DropMeter() as meter:
            run, _ = serve_counted(argv + flags, weights)
        same = check_against_ar(run, dev, gate=False)
        log(f"  {arch} {flags} at capacity factor 1.25: {run_summary(run)};"
            f" {same} of {REQUESTS} answers == AR; {meter.line()}")
        with DropMeter() as meter:
            served = server_counted(["--arch", arch] + flags, weights)
        same = check_server_against_ar(f"{arch} server {flags} at 1.25",
                                       served, dev, gate=False)
        log(f"  {arch} server {flags} at 1.25: {same} of 16 answers == AR; "
            f"{meter.line()}")
    del srv, fsrv, run, served, weights
    torch.cuda.empty_cache()

    arch = "internvl2-26b"
    cfg = get_config(arch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, mp = build_model(cfg, SEED, 4, dev)
    torch.cuda.synchronize()
    log(f"  ({arch}) 48 layers at full width in bf16, Medusa heads K 4: "
        f"built in {time.perf_counter() - t0:.1f}s")
    prompts = make_prompts(cfg.vocab_size, REQUESTS, SEED, 64, 257)
    extras = [frontend_embeds(cfg, SLOTS,
                              torch.Generator(device=dev).manual_seed(9 + g))
              for g in range(REQUESTS // SLOTS)]
    for vf in (False, True):
        eng = build_engine(cfg, "medusa", use_kernel=True, device=dev,
                           verify_fusion=vf)
        run, counts = static_counted(eng, params, mp, prompts, extras)
        check_against_ar(run, dev, extras=extras)
        if vf:
            out[arch] = counts
        log(f"  {arch} generate with a {cfg.frontend_len}-row prefix"
            f"{', verify fusion' if vf else ''}: {run_summary(run)}; "
            f"launches {counts} (exact); peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        del eng, run
    log(f"  ({arch}) the launcher, text only, --verify-fusion")
    run, _ = serve_counted(SERVE_ARGV + ["--arch", arch, "--verify-fusion"],
                           (params, mp))
    check_against_ar(run, dev)
    log(f"  {arch} launcher, text only, fused: {run_summary(run)}")
    del params, mp, run
    torch.cuda.empty_cache()

    arch = "phi3.5-moe-42b-a6.6b"
    cfg = dataclasses.replace(get_config(arch), num_layers=PHI_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, mp = build_model(cfg, SEED, 4, dev)
    torch.cuda.synchronize()
    log(f"  ({arch}) {PHI_LAYERS} of its 32 layers at full width in bf16: "
        f"built in {time.perf_counter() - t0:.1f}s")
    prompts = make_prompts(cfg.vocab_size, REQUESTS, SEED, 64, 257)
    for capacity, vf in ((no_drop, False), (no_drop, True),
                         (lambda c: c, True)):
        c = capacity(cfg)
        eng = build_engine(c, "medusa", use_kernel=True, device=dev,
                           verify_fusion=vf)
        with DropMeter() as meter:
            run, counts = static_counted(eng, params, mp, prompts)
        held = c.capacity_factor != cfg.capacity_factor
        same = check_against_ar(run, dev, gate=held)
        if held and vf:
            out[arch] = counts
        log(f"  {arch} ({PHI_LAYERS} layers) capacity factor "
            f"{c.capacity_factor}{', verify fusion' if vf else ''}: "
            f"{run_summary(run)}; {same} of {REQUESTS} answers == AR"
            f"{'' if held else ' (not held)'}; {meter.line()}; launches "
            f"{counts} (exact); peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        del eng, run
    del params, mp
    torch.cuda.empty_cache()
    return out


def phase_train_moe(dev):
    """Phase 11 (iv): 8 ``lm_train_step``s of granite-moe-1b-a400m at full
    width and depth (float32 master weights, bf16 products, remat, the
    config's capacity factor) on one repeated batch of 8 x 512: the loss
    falls, the aux loss is finite and above 0 at every step; ms per step
    and peak memory."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer as TT
    from repro_torch.training import data as D
    from repro_torch.training import optimizer as O
    from repro_torch.training import steps as ST

    torch.cuda.reset_peak_memory_stats()
    cfg = get_config("granite-moe-1b-a400m")
    p = TT.init_params(torch.Generator(device=dev).manual_seed(8), cfg)
    state = {"p": p, "opt": O.adamw_init(p)}
    data = D.synthetic_chat(D.SyntheticChatConfig(
        vocab_size=cfg.vocab_size, seq_len=513, n_samples=8))
    x = torch.from_numpy(data).to(dev)
    auxes = []

    def lm_step():
        state["p"], state["opt"], met = ST.lm_train_step(
            state["p"], state["opt"], cfg, x[:, :-1], x[:, 1:])
        auxes.append(float(met["aux"]))
        return met["loss"]

    losses, ms = timed_steps(8, lm_step)
    peak = torch.cuda.max_memory_allocated() / 2**30
    n = sum(t.numel() for t in O.tree_leaves(p))
    log(f"  lm_train_step, granite-moe-1b-a400m at full width and depth "
        f"({n / 1e9:.3f} B float32 parameters, bf16 products, remat, "
        f"capacity factor {cfg.capacity_factor}), one batch of 8 x 512 "
        f"eight times: loss {losses[0]:.4f} -> {losses[-1]:.4f}, aux "
        f"{auxes[0]:.4f} -> {auxes[-1]:.4f}; {ms:.1f} ms/step (median of "
        f"steps 2-8); peak memory {peak:.2f} GiB")
    if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
        fail(f"granite-moe training: losses {losses}")
    if not all(np.isfinite(a) and a > 0 for a in auxes):
        fail(f"granite-moe training: aux losses {auxes}")


def ssm_f32_config(arch):
    """Phase 4s's float32 config of ``arch`` at full width: mamba2-2.7b at
    2 layers; jamba in its one-unit cut (``ONE_UNIT``) with its experts
    cut to ``JAMBA_F32_EXPERTS`` (top-2) at no drop."""
    from repro_torch.configs.jamba_15_large_398b import ONE_UNIT
    from repro_torch.configs.registry import get_config

    f32 = dict(dtype="float32", param_dtype="float32")
    if arch == "mamba2-2.7b":
        return dataclasses.replace(get_config(arch), num_layers=2,
                                   name=f"{arch}-2layer-f32", **f32)
    return no_drop(dataclasses.replace(
        ONE_UNIT, num_experts=JAMBA_F32_EXPERTS,
        name=f"{arch}-1unit-{JAMBA_F32_EXPERTS}experts-f32", **f32))


SSM_F32_LAYOUTS = {"dense": {}, "paged": dict(cache_layout="paged",
                                              page_size=16),
                   "int8": dict(cache_dtype="int8"),
                   "int8+paged": dict(cache_dtype="int8",
                                      cache_layout="paged", page_size=16)}


def phase_ssm_f32(dev):
    """Phase 4s: mamba2-2.7b (2 layers) and jamba-1.5-large-398b (one
    4-position unit, 4 experts, no drop) in float32 at full width, chain
    mode (gamma 4): speculative ``generate`` == ``ar_generate`` token for
    token through the captured steps for Medusa on the chain and n-gram,
    unfused and with verify fusion, on the dense and paged caches, and
    for jamba on int8 and int8 + paged too; launches exact
    (``expected_counts``: K2 alone on mamba2's path, K1-K5 on jamba's)
    and K1 on ``decode_plan``'s routes; on the dense cache the eager
    engine (``graphs=False``) gives the graph's tokens with the same
    launches.  Returns {arch: the dense fused Medusa run's counts}."""
    from repro_torch.core.engine import ar_generate, build_engine
    from repro_torch.launch.serve import build_model, make_prompts
    from repro_torch.models.transformer import unit_structure

    max_new, max_len = 32, 512
    out = {}
    for arch in SSM_HYBRID:
        base = ssm_f32_config(arch)
        t0 = time.perf_counter()
        params, mp = build_model(base, 1, GAMMA, dev)
        torch.cuda.synchronize()
        log(f"  ({arch}) {base.name}: {base.num_layers} layers "
            f"{unit_structure(base)}, {base.num_experts} experts, built in "
            f"{time.perf_counter() - t0:.1f}s; memory "
            f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
        prompts = make_prompts(base.vocab_size, 4, 1, 16, 129)
        tok, plen = (torch.from_numpy(a).to(dev)
                     for a in padded_batch(prompts, range(4)))
        layouts = ["dense", "paged"] + (["int8", "int8+paged"]
                                        if base.num_attn_layers else [])
        ars = {}
        for name in layouts:
            for vf in (False, True):
                cfg = dataclasses.replace(base, **SSM_F32_LAYOUTS[name])
                label = f"{arch} {name}" + (", verify fusion" if vf else "")
                ar = None
                for kind in ("medusa", "ngram"):
                    eng = build_engine(cfg, kind, gamma=GAMMA,
                                       use_kernel=True, device=dev,
                                       verify_fusion=vf)
                    pp = mp if kind == "medusa" else None
                    reset_counts()
                    sp, _, st = eng.generate(params, pp, tok, plen,
                                             eng.init_cache(4, max_len),
                                             max_new)
                    ar_steps = 0
                    if ar is None:
                        ar, _ = ar_generate(
                            eng.cfg, params, tok, plen,
                            eng.init_cache(4, max_len), max_new,
                            use_kernel=True, graphs=eng.step_graphs)
                        ar, ar_steps = ar.cpu(), max_new
                        ars[name, vf] = ar
                    counts = read_counts()
                    want = expected_counts(eng.cfg, st.steps, ar_steps)
                    if counts != want:
                        fail(f"f32 {label} {kind}: launches {counts}, "
                             f"expected {want}")
                    ps = cfg.page_size if cfg.paged else 1
                    check_routes(f"f32 {label} {kind}", None,
                                 k1_routes(eng.cfg, 4,
                                           -(-max_len // ps) * ps, st.steps,
                                           ar_steps, T=eng.tb.T))
                    replays = [(k, g.replays) for k, g in kept_graphs(eng)]
                    sp = sp.cpu()
                    if not torch.equal(sp, ar):
                        fail(f"float32 {label} {kind}: spec != AR:\nspec "
                             f"{sp.tolist()}\nAR   {ar.tolist()}")
                    mean_acc = st.accepted_sum.item() / (st.steps * 4)
                    log(f"  f32 {label}, {kind}: graph spec == graph AR "
                        f"for 4 x {max_new} tokens; {st.steps} spec steps "
                        f"(mean accepted {mean_acc:.3f}); graph replays "
                        f"{replays}; launches {counts} (exact)")
                    if name == "dense" and kind == "medusa":
                        if vf:
                            out[arch] = counts
                        eager = build_engine(cfg, kind, gamma=GAMMA,
                                             use_kernel=True, device=dev,
                                             verify_fusion=vf, graphs=False)
                        reset_counts()
                        ep, _, est = eager.generate(
                            params, pp, tok, plen,
                            eager.init_cache(4, max_len), max_new)
                        ecounts = read_counts()
                        if not torch.equal(ep.cpu(), sp) or \
                                est.steps != st.steps or ecounts != \
                                expected_counts(eng.cfg, st.steps):
                            fail(f"f32 {label}: the eager step's tokens, "
                                 f"steps or launches ({ecounts}) differ "
                                 f"from the graph's")
                        log(f"  f32 {label}, medusa: eager == graph tokens "
                            f"and steps; eager launches {ecounts}")
                        del eager
                    del eng
        # a self-draft (the target as its own draft model) proposes the
        # target's greedy chain: whole chains are accepted, so the commit's
        # select past the chain's first token runs on the card
        cfg = dataclasses.replace(base, verify_fusion=True)
        eng = build_engine(cfg, "draft", draft_cfg=cfg, gamma=GAMMA,
                           use_kernel=True, device=dev)
        reset_counts()
        sp, _, st = eng.generate(params, params, tok, plen,
                                 eng.init_cache(4, max_len), max_new)
        counts = read_counts()
        want = expected_counts(eng.cfg, st.steps, proposer=eng.proposer)
        mean_acc = st.accepted_sum.item() / (st.steps * 4)
        log(f"  f32 {arch} dense, verify fusion, self-draft: {st.steps} "
            f"spec steps, mean accepted {mean_acc:.3f}; launches {counts} "
            f"(expected {want})")
        if counts != want:
            fail(f"f32 {arch} self-draft: launches {counts}, expected {want}")
        if not torch.equal(sp.cpu(), ars["dense", True]) or mean_acc <= 2:
            fail(f"f32 {arch} self-draft: spec != AR or whole chains not "
                 f"accepted (mean accepted {mean_acc})")
        del eng, params, mp
        torch.cuda.empty_cache()
    return out


def ssm_step_line(run, profile: bool = False) -> str:
    """The replayed spec step of a static run's engine: wall ms a step
    (each replay followed by the exit test's host read) and device ms a
    step, from CUDA events around 10 replays queued back to back; with
    ``profile`` also the kernel launches a step and their device ms from
    ``torch.profiler`` over 2 replays.  Profiled once a model: profiles
    of graphs of ~10^4 nodes a replay leave later profiles recording
    fewer kernels (``device_profile``)."""
    graph, c = run.engine.step_graphs.kept()[0]

    def step():
        graph()
        bool(torch.any(c.n_out < 0))

    wall = host_ms(step, 10, warmup=1)
    line = (f"replayed step wall {wall:.3f} ms, device "
            f"{cuda_ms(graph, 10, warmup=1):.3f} ms (CUDA events)")
    if profile:
        dms, n = device_profile(step, 2, warmup=1)
        line += (f" ({dms:.3f} ms of kernels, idle {1 - dms / wall:.3f}, "
                 + ("launches not recorded" if n is None else
                    f"{n:.0f} kernel launches a step") + ": the profiler)")
    return line


def phase_ssm_serve(dev):
    """Phase 15: the SSM and hybrid families in bf16 at full width.

    mamba2-2.7b at full depth (64 layers, ~5.4 GB) through the launcher:
    ``--static`` with Medusa on the chain, unfused and ``--verify-fusion``
    (K2 its only kernel), and ``--proposer ngram``, each held to
    ``ar_generate`` under ``near_tie``; then the server (16 requests),
    unfused and fused, held the same way.  jamba-1.5-large-398b in its
    one-unit cut (``ONE_UNIT``, all 16 experts, at the no-drop capacity
    factor) through ``build_engine`` on the dense cache unfused and
    fused, the paged pool fused and the int8 cache, held to AR with
    ``router_gap`` at each divergence; then through the launcher's server
    (``served_config``), unfused, fused and with ``--chunk-size 64`` (the
    suffix prefill's kept SSM state, masked slots restored).  Logged:
    tok/s, tokens a step, the replayed step's wall and device ms and
    launches a step, capture seconds, peak memory and ``ssm_restores``.
    Returns {arch: the fused static run's launch counts}."""
    out = {"mamba2-2.7b": serve_mamba2(dev)}
    gc.collect()            # the servers' weights and the graphs' pools
    torch.cuda.empty_cache()
    out["jamba-1.5-large-398b"] = serve_jamba(dev)
    return out


def serve_mamba2(dev):
    """Phase 15's mamba2-2.7b runs; returns the fused static run's
    counts."""
    from repro_torch.core.engine import build_engine

    arch = "mamba2-2.7b"
    argv = SERVE_ARGV + ["--arch", arch]
    torch.cuda.reset_peak_memory_stats()
    log(f"  ({arch}) --arch {arch} --static, 64 layers at full width")
    srv = serve_counted(argv, drift=True)[0]
    check_against_ar(srv, dev)
    weights = (srv.params, srv.proposer_params)
    fsrv, counts = serve_counted(argv + ["--verify-fusion"], weights)
    check_against_ar(fsrv, dev)
    nsrv, _ = serve_counted(argv + ["--proposer", "ngram"],
                            (srv.params, None))
    check_against_ar(nsrv, dev)
    # a self-draft accepts whole chains at full depth: the commit's select
    # past the chain's first token, on bf16 states
    eng = build_engine(fsrv.cfg, "draft", draft_cfg=fsrv.cfg, gamma=GAMMA,
                       use_kernel=True, device=dev)
    dsrv, _ = static_counted(eng, srv.params, srv.params, srv.prompts)
    check_against_ar(dsrv, dev)
    for label, run in (("medusa", srv), ("medusa fused", fsrv),
                       ("ngram", nsrv), ("self-draft fused", dsrv)):
        log(f"  {arch} --static {label}: {run_summary(run)}; "
            f"{ssm_step_line(run, profile=run is fsrv)}; peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del fsrv, nsrv, dsrv, eng, run
    for flags in ([], ["--verify-fusion"]):
        served = server_counted(["--arch", arch] + flags, weights)
        check_server_against_ar(f"{arch} server {flags}", served, dev)
        log(f"  {arch} server {flags}: ssm_restores "
            f"{served.server.stats['ssm_restores']}; peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        del served
    return counts


def serve_jamba(dev):
    """Phase 15's runs of jamba's one-unit cut; returns the dense fused
    static run's counts."""
    from repro_torch.configs.jamba_15_large_398b import ONE_UNIT
    from repro_torch.core.engine import build_engine
    from repro_torch.launch.serve import build_model, make_prompts

    arch = "jamba-1.5-large-398b"
    cfg = no_drop(ONE_UNIT)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, mp = build_model(cfg, SEED, GAMMA, dev)
    torch.cuda.synchronize()
    log(f"  ({arch}) full width cut to one 4-position unit "
        f"(num_layers 4, hybrid_period 4, attn_index 1: SSM + dense, "
        f"attention + MoE, SSM + dense, SSM + MoE; 16 experts, capacity "
        f"factor {cfg.capacity_factor}) in bf16, Medusa heads K 4 on the "
        f"chain: built in {time.perf_counter() - t0:.1f}s; memory "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    prompts = make_prompts(cfg.vocab_size, REQUESTS, SEED, 64, 257)
    measure_drift(cfg, params, prompts, dev)
    for name, kw, vf in (("dense", {}, False), ("dense", {}, True),
                         ("paged 64", dict(cache_layout="paged"), True),
                         ("int8", dict(cache_dtype="int8"), False)):
        c = dataclasses.replace(cfg, **kw)
        eng = build_engine(c, "medusa", use_kernel=True, device=dev,
                           verify_fusion=vf)
        run, counts = static_counted(eng, params, mp, prompts)
        check_against_ar(run, dev)
        if name == "dense" and vf:
            out = counts
        log(f"  {arch} {name}{', verify fusion' if vf else ''}: "
            f"{run_summary(run)}; {ssm_step_line(run, profile=vf and not kw)}"
            f"; launches {counts} "
            f"(exact); peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        del eng, run
    with served_config(lambda c: cfg if c.family == "hybrid" else c):
        for flags in ([], ["--verify-fusion"], ["--chunk-size", "64"]):
            served = server_counted(["--arch", arch] + flags, (params, mp))
            check_server_against_ar(f"{arch} server {flags}", served, dev)
            st = served.server.stats
            log(f"  {arch} server {flags}: ssm_restores "
                f"{st['ssm_restores']}, chunk calls {st['chunk_calls']}; "
                f"peak memory "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
            if flags and flags[0] == "--chunk-size" and not (
                    st["chunk_calls"] and st["ssm_restores"]):
                fail(f"{arch} chunked server: no chunk call or no masked "
                     f"slot restored ({st})")
            del served
    del params, mp
    # a SpecServer holds itself through its bound device calls, so the
    # ~51 GB of weights its servers hold go with the cyclic collector
    gc.collect()
    return out


def measure_drift(cfg, params, prompts, dev):
    """``step_drift`` of ``cfg`` (bf16) on the first 4 ``prompts`` into
    ``SSM_DRIFT``, held below ``DRIFT_STEPS`` bf16 steps at the top logit
    for a model without experts.  A MoE's drift is logged, not bounded:
    a token whose router nearly ties between two experts can route apart
    in the two steps, which moves its logits by more than any rounding;
    ``router_gap`` witnesses it at each divergence."""
    t0 = time.perf_counter()
    D, flips, top = step_drift(cfg, params, prompts, dev)
    bound = DRIFT_STEPS * bf16_step(top)
    log(f"  ({cfg.name}) the spec and AR steps on the same tokens, 4 x "
        f"{MAX_NEW} teacher-forced: logits over AR's top 8 differ by up to "
        f"{D:.5f} (bound {bound:.5f}: {DRIFT_STEPS} bf16 steps at the top "
        f"{top:.3f}), argmaxes part at {flips} of {4 * MAX_NEW} positions "
        f"({time.perf_counter() - t0:.1f}s)")
    if not (cfg.num_experts or D <= bound):
        fail(f"{cfg.name}: the spec and AR steps' logits drift {D} apart "
             f"on the same tokens, beyond {bound}")
    SSM_DRIFT[cfg.name] = D


def phase_train_ssm(dev):
    """Phase 11 (v): 6 ``lm_train_step``s of mamba2-2.7b at full width
    and depth (float32 master weights, bf16 products, remat; batch and
    length cut to 4 x 512) on one repeated batch: the loss falls; ms per
    step and peak memory."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer as TT
    from repro_torch.training import data as D
    from repro_torch.training import optimizer as O
    from repro_torch.training import steps as ST

    torch.cuda.reset_peak_memory_stats()
    cfg = get_config("mamba2-2.7b")
    p = TT.init_params(torch.Generator(device=dev).manual_seed(8), cfg)
    state = {"p": p, "opt": O.adamw_init(p)}
    data = D.synthetic_chat(D.SyntheticChatConfig(
        vocab_size=cfg.vocab_size, seq_len=513, n_samples=4))
    x = torch.from_numpy(data).to(dev)

    def lm_step():
        state["p"], state["opt"], met = ST.lm_train_step(
            state["p"], state["opt"], cfg, x[:, :-1], x[:, 1:])
        return met["loss"]

    losses, ms = timed_steps(6, lm_step)
    peak = torch.cuda.max_memory_allocated() / 2**30
    n = sum(t.numel() for t in O.tree_leaves(p))
    log(f"  lm_train_step, mamba2-2.7b at full width and depth "
        f"({n / 1e9:.3f} B float32 parameters, bf16 products, remat), one "
        f"batch of 4 x 512 six times: loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}; {ms:.1f} ms/step (median of steps 2-6); peak "
        f"memory {peak:.2f} GiB")
    if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
        fail(f"mamba2 training: losses {losses}")
    del state, p
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phases 4w, 16 and 11 (vi): the encoder-decoder (whisper-tiny)
# ---------------------------------------------------------------------------

WHISPER_LAYOUTS = [("dense", {}), ("int8", dict(cache_dtype="int8")),
                   ("paged", dict(cache_layout="paged", page_size=64)),
                   ("int8+paged", dict(cache_dtype="int8",
                                       cache_layout="paged", page_size=16))]


def phase_whisper_f32(dev):
    """Phase 4w: whisper-tiny in float32 at full width and depth (4
    encoder and 4 decoder layers, d 384, 1500 frames a request from
    ``frontend_embeds``): speculative ``generate`` == ``ar_generate``
    token for token on the dense, int8, paged and int8 + paged caches,
    each with Medusa unfused, fused and sampled at temperature 0, and
    with the n-gram lookup (gamma 4), through the captured steps; on the
    dense cache also Medusa fused and n-gram through the eager steps
    (graph == eager); every run's launches exact (K1 a decoder layer and
    step, K2 a fused step, K3 never, one commit a spec step) and K1 on
    the routes ``decode_plan`` gives; the fp layouts give the dense
    tokens and the int8 ones the int8 tokens."""
    from repro_torch.configs.base import SamplingParams
    from repro_torch.configs.registry import get_config
    from repro_torch.core.engine import ar_generate, build_engine
    from repro_torch.launch.serve import build_model, make_prompts
    from repro_torch.models.frontends import frontend_embeds

    base = dataclasses.replace(get_config(WHISPER), dtype="float32",
                               param_dtype="float32", name=f"{WHISPER}-f32")
    params, mp = build_model(base, 1, 4, dev)
    prompts = make_prompts(base.vocab_size, 4, 1, 16, 129)
    tok, plen = (torch.from_numpy(a).to(dev)
                 for a in padded_batch(prompts, range(4)))
    frames = frontend_embeds(base, 4,
                             torch.Generator(device=dev).manual_seed(2))
    max_new, max_len = 32, 512
    want = {}
    for name, kw in WHISPER_LAYOUTS:
        cfg = dataclasses.replace(base, **kw)
        runs = [("medusa", False, "greedy", True),
                ("medusa", True, "greedy", True),
                ("medusa", False, "sample", True),
                ("ngram", False, "greedy", True)]
        if name == "dense":
            runs += [("medusa", True, "greedy", False),
                     ("ngram", False, "greedy", False)]
        for kind, vf, accept, graphs in runs:
            label = (f"{WHISPER} {name} {kind}"
                     + (", verify fusion" if vf else "")
                     + (", sampled at temperature 0" if accept == "sample"
                        else "") + ("" if graphs else ", eager"))
            eng = build_engine(cfg, kind, gamma=GAMMA, use_kernel=True,
                               device=dev, verify_fusion=vf, accept=accept,
                               graphs=graphs, seed=3,
                               sampling=SamplingParams(temperature=0.0))
            reset_counts()
            sp, n_out, st = eng.generate(
                params, mp if kind == "medusa" else None, tok, plen,
                eng.init_cache(4, max_len), max_new, extra_embeds=frames)
            ar, _ = ar_generate(eng.cfg, params, tok, plen,
                                eng.init_cache(4, max_len), max_new,
                                use_kernel=True, graphs=eng.step_graphs,
                                extra_embeds=frames)
            counts = read_counts()
            expect = expected_counts(eng.cfg, st.steps, max_new)
            if counts != expect:
                fail(f"f32 {label}: launches {counts}, expected {expect}")
            ps = cfg.page_size if cfg.paged else 1
            check_routes(f"f32 {label}", None,
                         k1_routes(eng.cfg, 4, -(-max_len // ps) * ps,
                                   st.steps, max_new, T=eng.tb.T))
            captured = sorted(k for k, g in kept_graphs(eng)
                              if g.graph is not None)
            if captured != (["AR", "spec"] if graphs else []):
                fail(f"f32 {label}: captured {captured}")
            sp, ar = sp.cpu(), ar.cpu()
            key = "int8" if "int8" in name else "fp"
            ref = want.setdefault(key, ar)
            if not (torch.equal(sp, ar) and torch.equal(ar, ref)
                    and bool((n_out == max_new).all())):
                fail(f"float32 {label}: spec != AR (or AR != the dense "
                     f"{key} AR):\nspec {sp.tolist()}\nAR   {ar.tolist()}"
                     f"\nref  {ref.tolist()}")
            mean_acc = st.accepted_sum.item() / (st.steps * 4)
            log(f"  f32 {label} (full width and depth, 1500 frames): spec "
                f"== AR for 4 x {max_new} tokens; {st.steps} spec steps "
                f"(mean accepted {mean_acc:.3f}); launches {counts} (exact)"
                + (f"; capture {eng.step_graphs.capture_s:.3f}s"
                   if graphs else ""))
            del eng
    log(f"  f32 {WHISPER}: paged spec == dense spec; int8 paged == int8 "
        f"({int(torch.sum(want['int8'] == want['fp']))} of "
        f"{want['fp'].numel()} int8 tokens equal to the fp ones)")
    del params, mp
    torch.cuda.empty_cache()


def server_timed(argv, weights):
    """``server_counted`` with each replay of the serve step bracketed by
    CUDA events; returns (Served, median device ms of the replayed
    step)."""
    from repro_torch.launch import serve

    pairs = []
    real = serve.SpecServer

    class Timed(real):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            pairs.append(event_timed_steps(self))
    serve.SpecServer = Timed
    try:
        served = server_counted(argv, weights)
    finally:
        serve.SpecServer = real
    return served, float(np.median([a.elapsed_time(b) for a, b in pairs[0]]))


def phase_whisper_serve(dev):
    """Phase 16: whisper-tiny in bf16 at full width and depth through the
    launcher, each request with its own 1500 random frames
    (``serve.request_frames``).  ``--static`` unfused and
    ``--verify-fusion`` on the same weights (8 requests; launches exact,
    K2 on wgmma over the pitched head, K3 never), each answer held to
    ``ar_generate`` on its frames under ``near_tie``; then the server (16
    requests, max_new 16..64) unfused and fused on the dense cache, and
    paged (page 64) with ``--preemption`` in a pool of two requests' worst
    case, unfused and fused (each must preempt), every answer held to AR
    the same way.  Logs tok/s, latency and time to first token p50/p99,
    the replayed step's device ms (the static step by ``step_times``, the
    server's by CUDA events around each replay).  Returns the fused
    static run's launch counts."""
    argv = SERVE_ARGV + ["--arch", WHISPER]
    torch.cuda.reset_peak_memory_stats()
    srv, _ = serve_counted(argv)
    check_against_ar(srv, dev, extras=frame_groups(srv, dev))
    weights = (srv.params, srv.proposer_params)
    fsrv, counts = serve_counted(argv + ["--verify-fusion"], weights)
    check_against_ar(fsrv, dev, extras=frame_groups(fsrv, dev))
    wall, device = step_times(fsrv.engine)
    log(f"  {WHISPER} static: unfused {run_summary(srv)}; fused "
        f"{run_summary(fsrv)}; the replayed fused step {wall:.3f} ms wall, "
        f"{device:.3f} ms device ({smi_line()}); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del srv, fsrv
    worst = -(-(257 + MAX_NEW + 66) // 64)      # blocks a request, worst
    paged = ["--cache-layout", "paged", "--page-size", "64", "--preemption",
             "--n-blocks", str(1 + 2 * worst)]
    for label, flags in (("dense", []), ("dense, verify fusion",
                                         ["--verify-fusion"]),
                         ("paged, preemption", paged),
                         ("paged, preemption, verify fusion",
                          paged + ["--verify-fusion"])):
        served, step_ms = server_timed(["--arch", WHISPER] + flags, weights)
        st = served.server.stats
        log(f"  {WHISPER} server {label}: the replayed serve step "
            f"{step_ms:.3f} ms median on the card (CUDA events; "
            f"{smi_line()}); {st['preemptions']} preemptions, peak "
            f"{st['peak_blocks']} blocks")
        if flags and flags[0] == "--cache-layout" and not (
                st["preemptions"] >= 1
                and served.server.pool.in_use == 0):
            fail(f"{WHISPER} server {label}: no preemption, or the pool "
                 f"did not drain: {st}")
        check_server_against_ar(f"{WHISPER} server {label}", served, dev)
    del served, weights
    torch.cuda.empty_cache()
    return counts


def frame_groups(run, dev):
    """A static run's frames as ``check_against_ar``'s ``extras``: each
    group's [SLOTS, F, fd] on ``dev``."""
    return [torch.from_numpy(np.stack(run.frames[g:g + SLOTS])).to(dev)
            for g in range(0, REQUESTS, SLOTS)]


def phase_train_whisper(dev):
    """Phase 11 (vi): whisper-tiny LM steps.  Reduced float32 (the
    reference's CPU config, 16 frames), on the card and on the CPU from
    the same weights, frames and batch, as phase 11 (i): the gradients
    within ``TRAIN_TOL`` of each leaf's largest magnitude, except the key
    biases ``bk``, whose gradient the softmax cancels (a key bias shifts
    all of a query row's scores alike): there both sides must be rounding,
    below 1e-6 of the largest gradient; the card's first step's
    parameters and moments against the CPU's optimizer (clip + AdamW) run
    on the card's gradients; three steps' losses.  Then full width and
    depth (1500 frames): 8 steps on one batch of 8 x 128, the loss falls;
    ms per step and peak memory."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import encdec as ED
    from repro_torch.models.frontends import frontend_embeds
    from repro_torch.training import data as D
    from repro_torch.training import optimizer as O
    from repro_torch.training import steps as ST
    from repro_torch.training.checkpoint import _flatten

    cpu = torch.device("cpu")
    cfg = get_config(WHISPER, reduced=True)
    gen = torch.Generator().manual_seed(5)
    params = ED.init_params(gen, cfg)
    for u in ("enc_units", "dec_units"):        # biases away from 0
        for p in params[u].values():
            for n in ("bq", "bk", "bv"):
                if n in p:
                    p[n].normal_(generator=gen).mul_(0.1)
    frames = frontend_embeds(cfg, 8, gen)
    corpus = torch.from_numpy(D.synthetic_chat(D.SyntheticChatConfig(
        vocab_size=cfg.vocab_size, seq_len=33, n_samples=8, noise=0.05)))
    opt_kw = dict(lr=3e-4, weight_decay=0.1)

    def on(tree, d):
        return O.tree_map(lambda t: t.to(d, copy=True), tree)

    def run(d):
        p = on(params, d)
        o = O.adamw_init(p)
        x, f = corpus.to(d), frames.to(d)
        (_, _), g = ST.value_and_grad(ST.lm_loss, on(p, d), cfg, x[:, :-1],
                                      x[:, 1:], f)
        losses, first = [], None
        for _ in range(3):
            p, o, met = ST.lm_train_step(p, o, cfg, x[:, :-1], x[:, 1:], f,
                                         **opt_kw)
            losses.append(float(met["loss"]))
            first = first or (on(p, cpu), on(o.mu, cpu), on(o.nu, cpu))
        return g, losses, first

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        g_d, loss_d, (p_d, mu_d, nu_d) = run(dev)
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    g_c, loss_c, _ = run(cpu)
    # the CPU's optimizer on the card's gradients
    g_ref, _ = O.clip_by_global_norm(on(g_d, cpu), 1.0)
    p_r, o_r = O.adamw_update(g_ref, O.adamw_init(params), on(params, cpu),
                              **opt_kw)
    top = max(float(t.abs().max()) for _, t in _flatten(g_c))
    gaps = {"gradients": {k: v for k, v in tree_gap(g_d, g_c).items()
                          if not k.endswith("bk")},
            "parameters (CPU optimizer, card gradients)":
                tree_gap(p_d, p_r),
            "first moments": tree_gap(mu_d, o_r.mu),
            "second moments": tree_gap(nu_d, o_r.nu)}
    cancelled = {k: (float(a.abs().max()), float(b.abs().max()))
                 for (k, a), (_, b) in zip(_flatten(g_d), _flatten(g_c))
                 if k.endswith("bk")}
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(loss_d, loss_c))
    log(f"  lm_train_step, reduced {WHISPER} with frames, card against CPU: "
        f"losses {[round(x, 6) for x in loss_d]} vs "
        f"{[round(x, 6) for x in loss_c]} (largest relative gap "
        f"{loss_gap:.2e}); largest gaps in units of each leaf's largest "
        f"magnitude: "
        + ", ".join(f"{k} {max(v.values()):.2e}" for k, v in gaps.items())
        + f"; the key biases' gradients (card, CPU) "
        f"{ {k: (f'{a:.2e}', f'{b:.2e}') for k, (a, b) in cancelled.items()} }"
        f" against the largest {top:.3e}")
    bad = {k: {n: x for n, x in v.items() if not x <= TRAIN_TOL}
           for k, v in gaps.items()}
    if not loss_gap <= TRAIN_TOL or any(bad.values()):
        fail(f"{WHISPER} training: card against CPU beyond {TRAIN_TOL}: "
             f"loss gap {loss_gap}, leaves {bad}")
    if any(max(a, b) >= 1e-6 * top for a, b in cancelled.values()):
        fail(f"{WHISPER} training: the key biases' gradients {cancelled} "
             f"are not rounding (largest gradient {top})")

    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(WHISPER)
    gen = torch.Generator(device=dev).manual_seed(8)
    p = ED.init_params(gen, cfg)
    state = {"p": p, "opt": O.adamw_init(p)}
    f = frontend_embeds(cfg, 8, gen)
    x = torch.from_numpy(D.synthetic_chat(D.SyntheticChatConfig(
        vocab_size=cfg.vocab_size, seq_len=129, n_samples=8))).to(dev)

    def lm_step():
        state["p"], state["opt"], met = ST.lm_train_step(
            state["p"], state["opt"], cfg, x[:, :-1], x[:, 1:], f)
        return met["loss"]

    losses, ms = timed_steps(8, lm_step)
    peak = torch.cuda.max_memory_allocated() / 2**30
    n = sum(t.numel() for t in O.tree_leaves(p))
    log(f"  lm_train_step, {WHISPER} at full width and depth ({n / 1e6:.1f} "
        f"M float32 parameters, bf16 products, remat, 1500 frames), one "
        f"batch of 8 x 128 eight times: loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}; {ms:.1f} ms/step (median of steps 2-8; "
        f"{smi_line()}); peak memory {peak:.2f} GiB")
    if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
        fail(f"{WHISPER} training: losses {losses}")


# ---------------------------------------------------------------------------
# phases 5 and 6: the launcher on bf16 openPangu-7B, full width and depth,
# unfused and then with verify fusion on the same weights
# ---------------------------------------------------------------------------

REQUESTS, SLOTS, MAX_NEW, MAX_LEN, SEED = 8, 4, 64, 2048, 0
SERVE_ARGV = ["--static", "--requests", str(REQUESTS), "--slots", str(SLOTS),
              "--max-new", str(MAX_NEW), "--max-len", str(MAX_LEN),
              "--min-prompt", "64", "--max-prompt", "257", "--seed",
              str(SEED)]
# a temperature at which the random-weight target is peaked enough that
# sampled candidates are accepted (at 0.7 none are), so 7s sees the
# accepting branch of the walks
LOW_TEMPERATURE = 0.1


def check_served(srv, counts):
    """Every request finished, and each kernel of the served config's path
    launched exactly as ``expected_counts`` says."""
    res = srv.results
    if any(r["status"] != "done" or len(r["output"]) != MAX_NEW
           for r in res):
        fail("not every request finished: "
             + str([(r["rid"], r["status"], len(r["output"])) for r in res]))
    steps = sum(res[g]["steps"] for g in range(0, REQUESTS, SLOTS))
    mean_acc = (sum(r["accepted"] for r in res)
                / sum(r["steps"] for r in res))
    want = expected_counts(srv.cfg, steps, deferred=srv.engine.deferred,
                           proposer=srv.engine.proposer)
    graphs = kept_graphs(srv.engine)
    replays = sum(g.replays for _, g in graphs)
    log(f"  served {REQUESTS} requests: {srv.tokens} tokens in "
        f"{srv.seconds:.3f}s = {srv.tokens / srv.seconds:.1f} tok/s "
        f"({srv.capture_s:.3f}s of it capturing the step graph); {steps} "
        f"decode steps, {replays} of them graph replays; mean accepted "
        f"length {mean_acc:.3f} tokens per step (1 = no draft token "
        f"accepted); launches {counts} (expected {want}); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if counts != want:
        fail(f"kernel launches on the path {counts}, expected {want}")
    if [k for k, g in graphs if g.graph is not None] != ["spec"] \
            or replays != steps - 1:
        fail(f"the launcher's steps were not replayed from one captured "
             f"graph: {[(k, g.replays) for k, g in graphs]} for {steps} "
             f"steps (one eager warm-up step, then replays)")


# the spec and AR steps' measured bf16 logit drift of a model with SSM
# layers (``step_drift``), by config name: a recurrence carries every
# rounding difference of the two steps' products into all later tokens
SSM_DRIFT = {}
# ``step_drift``'s sanity bound, in bf16 steps at the top logit
DRIFT_STEPS = 8


def step_drift(cfg, params, prompts, dev, n: int = MAX_NEW,
               K: int = 8):
    """The spec step's and the AR step's bf16 logits on the same tokens,
    teacher-forced: one prefill of 4 prompts copied into two caches, then
    ``n`` tokens (AR's own greedy choices) fed to both, the AR step
    (``ar_step``, T 1) and a spec-shaped step (a chain of T 5 over the
    token, committing its first: the served steps' shapes when nothing is
    accepted).  Returns (D, flips, top): the largest |difference| of the
    two steps' logits over AR's top ``K`` tokens at any position and row,
    the positions where their argmaxes differ, and the largest top
    logit.  In float32 the two agree bit for bit (phase 4s); in bf16 the
    products' row counts (B x 5 against B) round apart, and an SSM's
    recurrence carries that into every later token."""
    from repro_torch.core.engine import ar_step
    from repro_torch.core.tree import chain_tree
    from repro_torch.models import transformer as TT

    tok, plen = (torch.from_numpy(a).to(dev)
                 for a in padded_batch(prompts, range(4)))
    rows = -(-(tok.shape[1] + n + CHAIN_T + 8) // 64) * 64
    ca = TT.init_cache(cfg, 4, rows, device=dev)
    last, _ = TT.prefill(params, cfg, tok, plen, ca)
    cs = {p: {k: v.clone() for k, v in e.items()} for p, e in ca.items()}
    nxt = torch.argmax(TT.unembed(params, cfg, last), -1).to(torch.int32)
    tb = chain_tree(CHAIN_T - 1)
    mask = torch.from_numpy(tb.mask).to(dev)
    depths = torch.from_numpy(tb.depths).to(dev)
    path = torch.arange(CHAIN_T, dtype=torch.int32,
                        device=dev)[None].expand(4, CHAIN_T)
    one = torch.ones((4,), dtype=torch.int32, device=dev)
    la, ls = plen.clone(), plen.clone()
    D, flips, top = 0.0, 0, 0.0
    for _ in range(n):
        a, ca, la = ar_step(cfg, params, ca, nxt, la, use_kernel=True)
        h, spec = TT.decode(params, cfg, cs, nxt[:, None].expand(
            4, CHAIN_T).contiguous(), ls, mask, depths, use_kernel=True)
        cs, ls = TT.commit(cfg, spec, ls, path, one)
        a, sl = a.float(), TT.unembed(params, cfg, h[:, 0]).float()
        vals, idx = torch.topk(a, K, dim=-1)
        D = max(D, float((vals - sl.gather(1, idx)).abs().max()))
        flips += int((sl.argmax(-1) != idx[:, 0]).sum())
        top = max(top, float(vals[:, 0].max()))
        nxt = idx[:, 0].to(torch.int32)
    return D, flips, top


def near_tie(cfg, gap, top, spec_tok, ar_tok):
    """(accepted, bound) of a bf16 divergence where AR's top logit ``top``
    (token ``ar_tok``) lies ``gap`` above its logit for the speculative
    path's token ``spec_tok``.  openPangu-7B: ``gap < MARGIN_BOUND``, as
    reasoned there.  Another model: the same rule at the divergence's own
    top-logit magnitude (one bf16 step s there: gap < 2 s), completed for
    the case that rule leaves out: each of the two competing logits may
    round to a neighbouring step, in opposite directions, so the
    speculative step can tie them at an AR gap of exactly 2 s; a tie goes
    to the lower index (first wins), so that divergence is accepted only
    when the speculative token's index is below AR's.  A model with SSM
    layers whose drift ``SSM_DRIFT`` holds (``step_drift``: the two
    steps' logits on the same tokens differ by up to D over AR's top
    tokens) also accepts an AR gap up to 2 D: the spec token won, so its
    logit and AR's top moved apart by the gap, each by at most D."""
    if cfg.name.startswith("openpangu-7b"):
        return gap < MARGIN_BOUND, MARGIN_BOUND
    bound = 2 * bf16_step(top)
    drift = SSM_DRIFT.get(cfg.name)
    if drift is not None and gap <= 2 * drift:
        # a model with SSM layers: the two steps' logits on the same
        # tokens differ by up to ``drift`` over AR's top tokens, so a
        # divergence whose AR gap is within twice that is theirs
        return True, 2 * drift
    return gap < bound or (gap == bound and spec_tok < ar_tok), bound


def check_against_ar(srv, dev, extras=None, gate=True):
    """Each answer matches ``ar_generate`` on the served config up to its
    first divergence, which ``near_tie`` must accept (AR ranks the emitted
    token less than two bf16 steps below its top logit).  ``extras`` (a
    VLM's) holds each group's frontend prefix [SLOTS, F, fd], prefilled
    ahead of its prompts, or (the encoder-decoder's) each group's frames,
    which take no row.  With ``gate`` False (a MoE at the capacity
    factor that drops) the divergences are logged, not held.  For a MoE
    each divergence logs ``router_gap`` at the parting token.  Returns
    how many answers equal AR's."""
    from repro_torch.core.engine import ar_generate
    from repro_torch.models.api import init_cache

    res = srv.results
    diverged, worst, ar_seconds = 0, 0.0, 0.0
    runs = []
    for g in range(0, REQUESTS, SLOTS):
        rows = list(range(g, g + SLOTS))
        tok, plen = padded_batch(srv.prompts, rows)
        extra = None if extras is None else extras[g // SLOTS]
        tok = torch.from_numpy(tok).to(dev)
        plen = torch.from_numpy(plen).to(dev)
        if extra is not None and srv.cfg.family != "encdec":
            plen = plen + extra.shape[1]
        spec = torch.from_numpy(np.stack([res[i]["output"] for i in rows]))
        spec = spec.to(dev, torch.long)
        gaps, margins, tops = [], [], []

        def observe(t, logits):
            # AR's top logit minus its logit for the token the speculative
            # path emitted at t, and AR's own top-2 margin
            lf = logits.float()
            top2 = torch.topk(lf, 2, dim=-1).values
            gaps.append(top2[:, 0] - lf.gather(1, spec[:, t:t + 1])[:, 0])
            margins.append(top2[:, 0] - top2[:, 1])
            tops.append(top2[:, 0])

        cache = init_cache(srv.cfg, SLOTS, MAX_LEN, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ar, _ = ar_generate(srv.cfg, srv.params, tok, plen, cache, MAX_NEW,
                            use_kernel=True, observe=observe,
                            extra_embeds=extra)
        ar = ar.cpu()
        ar_seconds += time.perf_counter() - t0
        runs.append((rows, spec.cpu(), ar, torch.stack(gaps, 1).cpu(),
                     torch.stack(margins, 1).cpu(), torch.stack(tops).cpu(),
                     tok, plen, extra))
    for rows, spec, ar, gaps, margins, tops, tok, plen, extra in runs:
        for j, i in enumerate(rows):
            differ = (spec[j] != ar[j]).nonzero()
            if len(differ) == 0:
                log(f"  req {i}: spec == AR for all {MAX_NEW} tokens")
                continue
            at = int(differ[0, 0])
            gap, top = float(gaps[j, at]), float(tops[at, j])
            s_tok, a_tok = int(spec[j, at]), int(ar[j, at])
            ok, bound = near_tie(srv.cfg, gap, top, s_tok, a_tok)
            diverged += 1
            worst = max(worst, gap)
            gap_r = "" if not srv.cfg.num_experts else router_gap(
                srv.cfg, srv.params, tok[j:j + 1], plen[j:j + 1],
                ar[j, :at], None if extra is None else extra[j:j + 1])
            log(f"  req {i}: spec == AR for {at} tokens, then diverges (spec "
                f"token {s_tok}, AR's {a_tok}); AR ranks the spec token "
                f"{gap:.5f} below its top {top:.5f} (bound {bound}); AR "
                f"top-2 margin {float(margins[j, at]):.5f}{gap_r}")
            if gate and not ok:
                fail(f"request {i} diverges from AR at token {at}, where AR "
                     f"ranks the spec token {s_tok} {gap} below its top "
                     f"{a_tok} (bound {bound})")
    log(f"  ar_generate on the same groups: {REQUESTS * MAX_NEW} tokens in "
        f"{ar_seconds:.3f}s = {REQUESTS * MAX_NEW / ar_seconds:.1f} tok/s "
        f"(the margin readings included)")
    log(f"  divergences: {diverged} of {REQUESTS} requests "
        f"(largest AR gap to the spec token at a divergence {worst:.5f})")
    return REQUESTS - diverged


def serve_counted(argv, weights=None, drift=False):
    """One launcher run with the counts set to 0 just before it and read
    just after; returns (Served, counts).  With ``drift`` the served
    model's ``measure_drift`` runs first, on the run's own weights and
    prompts (after the run, which made them)."""
    from repro_torch.launch import serve

    reset_counts()
    srv = serve.main(argv, weights=weights)
    counts = read_counts()
    if drift:
        measure_drift(srv.cfg, srv.params, srv.prompts, srv.engine.device)
    check_served(srv, counts)
    steps = sum(srv.results[g]["steps"] for g in range(0, REQUESTS, SLOTS))
    ps = srv.cfg.page_size if srv.cfg.paged else 1
    check_routes(" ".join(argv[len(SERVE_ARGV):]) or "launcher",
                 counts if srv.cfg.verify_fusion else None,
                 k1_routes(srv.cfg, SLOTS, -(-MAX_LEN // ps) * ps, steps,
                           T=srv.engine.tb.T, proposer=srv.engine.proposer),
                 stats_route(srv.cfg))
    return srv, counts


def same_answers(a, b) -> int:
    return sum(np.array_equal(x["output"], y["output"])
               for x, y in zip(a.results, b.results))


def phase_serve(dev):
    srv, counts = serve_counted(SERVE_ARGV)
    check_against_ar(srv, dev)
    return srv, counts


def map_encodings():
    """{kernel: tensor maps its library has encoded for weights}."""
    from repro_torch.kernels.cache_update import qkv_map_encodings
    from repro_torch.kernels.tree_attention import stats_map_encodings
    return {"K2": stats_map_encodings(), "K3": qkv_map_encodings()}


def phase_serve_fused(dev, srv):
    """The launcher with ``--verify-fusion`` on ``srv``'s weights: every K2
    and K3 launch on the wgmma route, and at most one tensor map encoded
    per weight tensor (3 per layer for K3, the lm head for K2)."""
    enc0 = map_encodings()
    fsrv, counts = serve_counted(SERVE_ARGV + ["--verify-fusion"],
                                 weights=(srv.params, srv.proposer_params))
    enc = {k: n - enc0[k] for k, n in map_encodings().items()}
    limit = {"K2": 1, "K3": 3 * fsrv.cfg.num_layers}
    log(f"  weight tensor maps encoded over the run: {enc} (at most {limit}: "
        f"one per weight tensor; {counts['K2']} K2 and {counts['K3']} K3 "
        f"launches)")
    if any(enc[k] > limit[k] for k in enc):
        fail(f"tensor maps encoded {enc}, more than one per weight tensor "
             f"{limit}")
    log(f"  {same_answers(fsrv, srv)} of {REQUESTS} answers token-identical "
        f"to the unfused launcher's; tokens/s {fsrv.tokens / fsrv.seconds:.1f}"
        f" fused, {srv.tokens / srv.seconds:.1f} unfused")
    check_against_ar(fsrv, dev)
    return fsrv, counts


def step_times(eng, steps: int = 10):
    """(wall ms, device ms) per step of the captured spec step ``eng``
    keeps, replayed ``steps`` times from where its last run stopped, each
    replay followed by the loop's exit test (a host read) as in
    ``generate``: wall from the host clock, device from the kernels' own
    time under ``torch.profiler``."""
    graph, c = eng.step_graphs.kept()[0]

    def step_and_exit_test():
        graph()
        bool(torch.any(c.n_out < 0))

    step_and_exit_test()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step_and_exit_test()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / steps
    return wall, device_ms(step_and_exit_test, steps, warmup=1)


def phase_serve_eager(dev, fsrv):
    """The phase 6 configuration served once more on the same weights
    with the eager step (``graphs=False``): its launches exact, and its
    answers, tokens/s and step times logged beside the graph's."""
    from repro_torch.core.engine import build_engine
    from repro_torch.launch.serve import serve_static

    eng = build_engine(fsrv.cfg, "medusa", use_kernel=True, device=dev,
                       graphs=False)
    reset_counts()
    results, seconds, tokens, _ = serve_static(
        eng, fsrv.params, fsrv.proposer_params, fsrv.prompts, SLOTS, MAX_NEW,
        MAX_LEN)
    counts = read_counts()
    steps = sum(results[g]["steps"] for g in range(0, REQUESTS, SLOTS))
    want = expected_counts(fsrv.cfg, steps)
    if counts != want:
        fail(f"eager fused launcher: launches {counts}, expected {want}")
    same = [np.array_equal(a["output"], b["output"])
            for a, b in zip(results, fsrv.results)]
    log(f"  eager step: {tokens} tokens in {seconds:.3f}s = "
        f"{tokens / seconds:.1f} tok/s; graph (phase 6): "
        f"{fsrv.tokens / fsrv.seconds:.1f} tok/s, "
        f"{fsrv.tokens / (fsrv.seconds - fsrv.capture_s):.1f} tok/s without "
        f"its {fsrv.capture_s:.3f}s of capture; launches {counts} (exact)")
    log(f"  {sum(same)} of {REQUESTS} answers token-identical to the graph's "
        f"(expected {REQUESTS} of {REQUESTS})")
    for i, ok in enumerate(same):
        if not ok:
            at = int(np.nonzero(results[i]["output"]
                                != fsrv.results[i]["output"])[0][0])
            log(f"  req {i}: eager differs from the graph from token {at}")
    wall, dev_ms = step_times(fsrv.engine)
    log(f"  captured fused step, replayed: wall {wall:.3f} ms/step, device "
        f"{dev_ms:.3f} ms/step (idle {1 - dev_ms / wall:.3f}); peak memory "
        f"with the graph pools {torch.cuda.max_memory_allocated() / 2**30:.2f}"
        f" GiB")


def phase_serve_layouts(dev, srv, fsrv):
    """The launcher on the same weights under the reference's other cache
    layouts: (a) ``--cache-layout paged --verify-fusion``, token-identical
    to the fused dense answers (phase 6); (b) ``--cache-dtype int8``, held
    to ``ar_generate`` on the int8 config under the ``MARGIN_BOUND`` rule;
    (c) ``--cache-dtype int8 --cache-layout paged --page-size 16``,
    token-identical to (b).  Returns {label: (Served, counts)}."""
    weights = (srv.params, srv.proposer_params)
    runs = {}
    log("  (a) --cache-layout paged --verify-fusion")
    enc0 = map_encodings()
    runs["paged fused"] = serve_counted(
        SERVE_ARGV + ["--cache-layout", "paged", "--verify-fusion"], weights)
    log(f"  weight tensor maps encoded over the run: "
        f"{ {k: n - enc0[k] for k, n in map_encodings().items()} } (the "
        f"weights of phase 6, already encoded)")
    same = same_answers(runs["paged fused"][0], fsrv)
    log(f"  {same} of {REQUESTS} answers token-identical to the fused dense "
        f"launcher's (phase 6)")
    if same != REQUESTS:
        fail(f"paged fused answers differ from dense fused: {same} of "
             f"{REQUESTS} identical")
    log("  (b) --cache-dtype int8")
    runs["int8"] = serve_counted(SERVE_ARGV + ["--cache-dtype", "int8"],
                                 weights)
    log(f"  {same_answers(runs['int8'][0], srv)} of {REQUESTS} int8 answers "
        f"token-identical to the bf16 cache's (phase 5)")
    check_against_ar(runs["int8"][0], dev)
    log("  (c) --cache-dtype int8 --cache-layout paged --page-size 16")
    runs["int8 paged"] = serve_counted(
        SERVE_ARGV + ["--cache-dtype", "int8", "--cache-layout", "paged",
                      "--page-size", "16"], weights)
    same = same_answers(runs["int8 paged"][0], runs["int8"][0])
    log(f"  {same} of {REQUESTS} answers token-identical to the int8 dense "
        f"launcher's (b)")
    if same != REQUESTS:
        fail(f"int8 paged answers differ from int8 dense: {same} of "
             f"{REQUESTS} identical")
    for label, (run, _) in runs.items():
        log(f"  tokens/s {label}: {run.tokens / run.seconds:.1f}")
    return runs


def eager_answers(run) -> list:
    """The answers of launcher run ``run`` served again on its weights,
    config, sampling and seed through the eager step (``graphs=False``)."""
    from repro_torch.core.engine import build_engine
    from repro_torch.launch.serve import serve_static

    e = run.engine
    eng = build_engine(e.cfg, "medusa", use_kernel=True, device=e.device,
                       accept=e.accept, sampling=e.sampling, graphs=False,
                       seed=SEED)
    return serve_static(eng, run.params, run.proposer_params, run.prompts,
                        SLOTS, MAX_NEW, MAX_LEN)[0]


def phase_serve_sampled(dev, srv, fsrv):
    """The launcher on the same weights with ``--accept sample``: at
    temperature 0.7, unfused and with ``--verify-fusion`` (K2 at per-row
    temperatures, every launch on the wgmma route), through the captured
    step with launches exact, each logged beside greedy's (phases 5 and 6)
    with the wall and device ms of its replayed step; at
    ``LOW_TEMPERATURE`` its accepted length and its answers against the
    eager step's; at temperature 0 all 8 answers token-identical to
    greedy's (phase 5)."""
    weights = (srv.params, srv.proposer_params)
    hot = SERVE_ARGV + ["--accept", "sample", "--temperature", "0.7"]
    torch.cuda.reset_peak_memory_stats()

    def summary(run):
        steps = sum(run.results[g]["steps"] for g in range(0, REQUESTS,
                                                           SLOTS))
        mean_acc = (sum(r["accepted"] for r in run.results)
                    / sum(r["steps"] for r in run.results))
        return (f"{run.tokens / run.seconds:.1f} tok/s, {steps} steps, mean "
                f"accepted {mean_acc:.3f}, capture {run.capture_s:.3f}s")

    runs = {}
    for label, argv, greedy in (("sampled", hot, srv),
                                ("sampled fused", hot + ["--verify-fusion"],
                                 fsrv)):
        log(f"  ({label}) {' '.join(argv[len(SERVE_ARGV):])}")
        run, _ = serve_counted(argv, weights)
        wall, dev_ms = step_times(run.engine)
        log(f"  {label}: {summary(run)}; greedy: {summary(greedy)}; "
            f"{same_answers(run, greedy)} of {REQUESTS} answers equal to "
            f"greedy's; replayed step wall {wall:.3f} ms, device "
            f"{dev_ms:.3f} ms (idle {1 - dev_ms / wall:.3f})")
        runs[label] = run
    log(f"  peak memory over the sampled runs, the weights and every kept "
        f"graph pool included: "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    cold = SERVE_ARGV + ["--accept", "sample", "--temperature",
                         str(LOW_TEMPERATURE)]
    for label, argv in (("cold", cold),
                        ("cold fused", cold + ["--verify-fusion"])):
        log(f"  ({label}) {' '.join(argv[len(SERVE_ARGV):])}")
        run, _ = serve_counted(argv, weights)
        eager = sum(np.array_equal(r["output"], e["output"])
                    for r, e in zip(run.results, eager_answers(run)))
        log(f"  {label}: {summary(run)}; {same_answers(run, srv)} of "
            f"{REQUESTS} answers equal to greedy's; {eager} of {REQUESTS} "
            f"token-identical to the eager step's from the same seed "
            f"(expected {REQUESTS})")
        del run
    log("  (zero) --accept sample --temperature 0")
    zero, _ = serve_counted(SERVE_ARGV + ["--accept", "sample",
                                          "--temperature", "0"], weights)
    same = same_answers(zero, srv)
    log(f"  {same} of {REQUESTS} answers at temperature 0 token-identical "
        f"to greedy's (phase 5)")
    if same != REQUESTS:
        fail(f"sampled at temperature 0: {same} of {REQUESTS} answers equal "
             f"to greedy's")
    return runs


# ---------------------------------------------------------------------------
# phase 10: the deferred tree-row write at full width and depth
# ---------------------------------------------------------------------------

def phase_serve_deferred(dev, srv, fsrv, int8):
    """The launcher with ``--deferred`` (no tree-row cache write; commit
    the only one) on phase 5's weights and requests: (a) unfused, whose
    arithmetic is phase 5's, so all 8 answers must be phase 5's; (b) with
    ``--verify-fusion`` (the unfused projection and RoPE in place of K3,
    whose launches must be 0), held to ``ar_generate`` under
    ``MARGIN_BOUND``; (c) ``--cache-dtype int8``, all 8 answers those of
    the non-deferred int8 run (phase 7b).  Each run's tokens/s, capture
    seconds and its replayed step's wall and device ms are logged beside
    the non-deferred run's."""
    weights = (srv.params, srv.proposer_params)
    runs = {}
    for label, flags, twin in (("unfused", [], srv),
                               ("verify fusion", ["--verify-fusion"], fsrv),
                               ("int8", ["--cache-dtype", "int8"], int8)):
        log(f"  ({label}) --deferred {' '.join(flags)}")
        run, counts = serve_counted(SERVE_ARGV + ["--deferred"] + flags,
                                    weights)
        if counts["K3"]:
            fail(f"deferred {label}: K3 launched {counts['K3']} times")
        same = same_answers(run, twin)
        log(f"  {same} of {REQUESTS} answers token-identical to the "
            f"non-deferred run's")
        if label == "verify fusion":
            log(f"  {same_answers(run, srv)} of {REQUESTS} answers "
                f"token-identical to the unfused launcher's (phase 5)")
            check_against_ar(run, dev)
        elif same != REQUESTS:
            fail(f"deferred {label}: {same} of {REQUESTS} answers equal to "
                 f"the non-deferred run's")
        for what, r in (("deferred", run), ("non-deferred", twin)):
            wall, dev_ms = step_times(r.engine)
            log(f"  {label} {what}: {r.tokens / r.seconds:.1f} tok/s, "
                f"capture {r.capture_s:.3f}s; replayed step wall "
                f"{wall:.3f} ms, device {dev_ms:.3f} ms (idle "
                f"{1 - dev_ms / wall:.3f})")
        runs[label] = counts
    return runs

# ---------------------------------------------------------------------------
# phase 12: the chain proposers through the launcher at full width and depth
# ---------------------------------------------------------------------------

def phase_serve_chain(dev, srv):
    """The launcher's ``--proposer draft`` and ``--proposer ngram`` (gamma
    4) on phase 5's bf16 openPangu-7B and requests.  The draft is the
    launcher's 2-layer sibling with the weights it draws from ``--seed``
    (``serve.proposer_params``): unfused, ``--verify-fusion``,
    ``--cache-layout paged --verify-fusion`` (all 8 answers those of the
    fused dense run) and ``--cache-dtype int8``; the n-gram lookup
    unfused.  Launches exact (the draft's gamma + 1 T=1 decodes a step
    included), K1 on its routes, every K2 and K3 launch of a fused run on
    the wgmma route; each answer held to ``ar_generate`` under
    ``MARGIN_BOUND`` (the paged run by equality).  Logs each run's
    tokens/s, tokens a step, capture seconds and replayed step's wall and
    device ms beside phase 5's Medusa run, under the card's name and power
    limit.  Returns {label: launch counts}."""
    from repro_torch.core.engine import build_engine
    from repro_torch.launch.serve import proposer_params

    log(f"  card: {smi_line()}")
    dparams = proposer_params(build_engine(srv.cfg, "draft", device=dev),
                              SEED)

    def summary(run):
        steps = sum(run.results[g]["steps"]
                    for g in range(0, REQUESTS, SLOTS))
        wall, dev_ms = step_times(run.engine)
        return (f"{run.tokens / run.seconds:.1f} tok/s "
                f"({run.tokens / (run.seconds - run.capture_s):.1f} without "
                f"the capture), {steps} steps, "
                f"{run.tokens / (steps * SLOTS):.3f} tokens a step and slot, "
                f"capture {run.capture_s:.3f}s, replayed step wall "
                f"{wall:.3f} ms, device {dev_ms:.3f} ms (idle "
                f"{1 - dev_ms / wall:.3f})")

    runs = {}
    for label, flags, pp, twin in (
            ("draft", ["--proposer", "draft"], dparams, None),
            ("draft fused", ["--proposer", "draft", "--verify-fusion"],
             dparams, None),
            ("draft paged fused", ["--proposer", "draft", "--cache-layout",
                                   "paged", "--verify-fusion"], dparams,
             "draft fused"),
            ("draft int8", ["--proposer", "draft", "--cache-dtype", "int8"],
             dparams, None),
            ("ngram", ["--proposer", "ngram"], None, None)):
        log(f"  ({label}) {' '.join(flags)}")
        run, counts = serve_counted(SERVE_ARGV + flags, (srv.params, pp))
        if twin is None:
            check_against_ar(run, dev)
        else:
            same = same_answers(run, runs[twin][0])
            log(f"  {same} of {REQUESTS} answers token-identical to the "
                f"{twin} run's")
            if same != REQUESTS:
                fail(f"{label}: {same} of {REQUESTS} answers equal to the "
                     f"{twin} run's")
        log(f"  {label}: {summary(run)}; {same_answers(run, srv)} of "
            f"{REQUESTS} answers equal to phase 5's")
        runs[label] = (run, counts)
    log(f"  medusa (phase 5): {summary(srv)}")
    return {label: counts for label, (_, counts) in runs.items()}


# ---------------------------------------------------------------------------
# phases 13 and 13b: the continuous-batching server (serving/scheduler.py)
# ---------------------------------------------------------------------------

def serve_expected(srv, failed_steps: int = 0):
    """Launches of each kernel for everything ``srv`` (a ``SpecServer``)
    ran since its counters were set to 0: K1 once a layer for each decode
    step and each ``suffix_prefill`` call (prefix-cache admissions and
    chunks); with verify fusion K2 once a decode step and, on an fp cache,
    K3 once a layer for each decode step (unless deferred) and each
    suffix call (which never defers); one commit a decode step and a
    suffix call, K4 dense, K5 paged (none without an attention layer:
    only attention layers count); a draft-model proposer's gamma + 1
    T=1 decodes a step on each of its attention layers; no K3 for the
    encoder-decoder.  ``failed_steps`` are
    decode steps that ran and then failed (not in the stats).  Group
    prefills launch none of these kernels."""
    cfg, eng = srv.cfg, srv.engine
    steps = srv.stats["steps"] + failed_steps
    sfx = srv.timing["suffix_calls"]
    L = cfg.num_attn_layers
    unfused_write = (cfg.resolved_cache_dtype == "int8"
                     or cfg.family == "encdec")
    fused = cfg.verify_fusion
    t1 = draft_t1_launches(eng.proposer, steps)
    draft_k3 = t1 if t1 and eng.proposer.dc.verify_fusion \
        and not unfused_write else 0
    k3 = (L * (steps * (not eng.deferred) + sfx) if fused
          and not unfused_write else 0) + draft_k3
    commits = steps + sfx if L else 0
    return {"K1": L * (steps + sfx) + t1, "K2": steps if fused else 0,
            "K3": k3, "K4": 0 if cfg.paged else commits,
            "K5": commits if cfg.paged else 0}


def add_counts(*counts):
    return {k: sum(c[k] for c in counts) for k in counts[0]}


def check_server_graphs(label, srv, failed_steps: int = 0):
    """One captured graph per speculation level that ran, no recapture:
    a level's graph replayed every step after its first (eager warm-up)
    one, its capture never redone on admission, reap or recovery."""
    graphs = srv.step_graphs()
    got, want = {}, {}
    for g, n in srv.stats["gamma_steps"].items():
        n += failed_steps if g == srv._levels[-1][0] else 0
        if n:
            graph = graphs.get(g)
            got[g] = None if graph is None else (graph.graph is not None,
                                                 graph.replays)
            want[g] = (n >= 2, n - 1)
    if got != want:
        fail(f"{label}: serve-step graphs (captured, replays) by level {got},"
             f" expected {want}: one capture per level and every later step "
             f"replayed")
    return {g: graphs[g].capture_s for g in got}


def serve_ar(cfg, params, prompts, max_new, dev, observe=None, frames=None):
    """``ar_generate`` answers of ``prompts`` on ``cfg`` in groups of 4
    (padded as the launcher pads), ``max_new`` tokens each: [n, max_new]
    int64 on the host.  ``frames`` (the encoder-decoder's) holds each
    request's [F, fd] frames."""
    from repro_torch.core.engine import ar_generate
    from repro_torch.models.api import init_cache

    outs = []
    for g in range(0, len(prompts), 4):
        rows = list(range(g, min(g + 4, len(prompts))))
        tok, plen = padded_batch(prompts, rows)
        S = -(-(tok.shape[1] + max_new + 8) // 64) * 64
        extra = None if frames is None else torch.from_numpy(
            np.stack([frames[i] for i in rows])).to(dev)
        ar, _ = ar_generate(cfg, params, torch.from_numpy(tok).to(dev),
                            torch.from_numpy(plen).to(dev),
                            init_cache(cfg, len(rows), S, device=dev),
                            max_new, use_kernel=True,
                            observe=None if observe is None
                            else (lambda t, lg, rows=rows:
                                  observe(rows, t, lg)),
                            extra_embeds=extra)
        outs.append(ar.cpu().long())
    return torch.cat(outs)


SERVE13 = dict(slots=4, max_len=512)


def phase_serving_f32(dev, f32):
    """Phase 13: the ``SpecServer`` on phase 4's float32 openPangu-7B (full
    width, 2 layers): every answer equals ``ar_generate`` token for token
    on each of its runs, the mechanism each run is about fired (from its
    stats), the launches are exact (``serve_expected``), and each level's
    serve step is one captured graph replayed after its first step."""
    from repro_torch.configs.base import SamplingParams, SchedulerParams
    from repro_torch.core.engine import build_engine
    from repro_torch.launch.serve import make_prompts
    from repro_torch.serving.scheduler import (FamilySpecServer,
                                              ServerStepFailure, SpecServer)

    base, params, mp = f32["base"], f32["params"], f32["mp"]
    V = base.vocab_size
    rng = np.random.default_rng(13)
    plain = make_prompts(V, 7, 13, 16, 120)            # buckets 32 and 128
    # four donors of a 160-token shared prefix (10 pages of 16), then one
    # that shares 100 of its tokens (6 pages and 4 rows of a seventh: a
    # copy on write), admitted once a donor has finished and registered
    shared = rng.integers(0, V, size=160).astype(np.int32)
    prefixed = [np.concatenate([shared[:n], p]) for n, p in
                zip((160, 160, 160, 160, 100),
                    make_prompts(V, 5, 14, 4, 20))]
    longp = make_prompts(V, 4, 15, 90, 200)            # chunked at 32
    # 100 tokens each: admitted at blocks_for(100 + 66, 16) = 11 blocks,
    # so two fill a 22-block pool, and the first to grow past 110 rows
    # preempts the other
    hundred = make_prompts(V, 4, 16, 100, 101)
    news = [int(n) for n in rng.integers(8, 25, size=8)]
    ar_memo = {}

    def ar_of(cfg, prompts):
        key = (cfg.resolved_cache_dtype, id(prompts))
        if key not in ar_memo:
            ar_memo[key] = serve_ar(cfg, params, prompts, 24, dev)
        return ar_memo[key]

    def engine(cfg=base, kind="medusa", **kw):
        return build_engine(cfg, kind, gamma=GAMMA, use_kernel=True,
                            device=dev, **kw)

    def run(label, srv, prompts, *, temps=None, fail_at=None, lanes=None,
            check=None, new=None):
        new = news if new is None else new
        reset_counts()
        failed = {"n": 0}
        if fail_at is not None:
            real = srv._step_fn

            def flaky(level):
                out = real(level)
                failed["n"] += 1
                if failed["n"] == fail_at:
                    raise ServerStepFailure("injected device failure")
                return out
            srv._step_fn = flaky
        rids = []
        for i, p in enumerate(prompts):
            kw = {} if temps is None else dict(temperature=temps[i])
            if lanes is not None:
                kw["group"] = lanes[i % len(lanes)]
            rids.append(srv.submit(p, max_new=new[i % len(new)], **kw))
        t0 = time.perf_counter()
        iters = srv.run()
        seconds = time.perf_counter() - t0
        counts = read_counts()
        servers = (list(srv.groups.values()) if lanes is not None
                   else [srv])
        nfail = 1 if fail_at is not None and failed["n"] >= fail_at else 0
        want = add_counts(*(serve_expected(s, nfail) for s in servers))
        if counts != want:
            fail(f"serve f32 {label}: launches {counts}, expected {want}")
        caps = {}
        for s in servers:
            caps.update(check_server_graphs(f"serve f32 {label}", s, nfail))
        cfg = servers[0].engine.cfg
        ar = ar_of(cfg, prompts)
        same = 0
        for i, rid in enumerate(rids):
            req = srv.result(rid)
            n = new[i % len(new)]
            if req is None or req.status != "done" or len(req.output) != n:
                fail(f"serve f32 {label}: request {i} "
                     f"{None if req is None else req.status}, "
                     f"{0 if req is None else len(req.output)} of {n} tokens")
            if temps is not None and temps[i] != 0:
                continue
            if req.output != ar[i, :n].tolist():
                fail(f"serve f32 {label}: request {i} != AR:\n"
                     f"{req.output}\n{ar[i, :n].tolist()}")
            same += 1
        stats = [s.stats for s in servers]
        if check is not None and not check(stats[0] if len(stats) == 1
                                           else stats):
            fail(f"serve f32 {label}: its mechanism did not fire: {stats}")
        log(f"  serve f32 {label}: {same} of {len(prompts)} answers == AR "
            f"token for token ({len(prompts) - same} sampled); {iters} "
            f"iterations in {seconds:.3f}s; launches {counts} (exact); "
            f"captured levels {sorted(caps)} "
            f"({sum(caps.values()):.3f}s); stats "
            + "; ".join(json.dumps(st, default=int) for st in stats))
        return srv

    def server(eng, pp=mp, **kw):
        kw.setdefault("batch_slots", SERVE13["slots"])
        kw.setdefault("max_len", SERVE13["max_len"])
        return SpecServer(eng, params, pp, **kw)

    paged = dataclasses.replace(base, cache_layout="paged", page_size=16)
    int8 = dataclasses.replace(base, cache_dtype="int8")
    run("dense, batched admission", server(engine()), plain,
        check=lambda st: st["prefill_calls"] < len(plain))
    run("dense, serial admission", server(engine(), admission="serial"),
        plain, check=lambda st: st["prefill_calls"] == len(plain))
    run("int8", server(engine(int8)), plain)
    # worst case a request: 120 + 24 + 66 rows = 14 blocks of 16
    run("paged, a pool tight enough to defer",
        server(engine(paged), n_blocks=1 + 30), plain,
        check=lambda st: st["deferred"] >= 1 and st["peak_blocks"] <= 30)
    run("paged + prefix cache (CoW at a partial block)",
        server(engine(paged), n_blocks=1 + 64, prefix_cache=True), prefixed,
        check=lambda st: st["cow_copies"] >= 1 and st["cached_tokens"] > 0)
    run("chunked prefill (chunk 32)",
        server(engine(), sched=SchedulerParams(chunk_size=32)), longp,
        check=lambda st: st["chunk_calls"] >= 1)
    run("paged + preemption",
        server(engine(paged), n_blocks=1 + 22,
               sched=SchedulerParams(preemption=True)), hundred,
        new=[24], check=lambda st: st["preemptions"] >= 1
        and st["resumed"] >= 1)
    # the n-gram lookup on random prompts accepts little, so the level
    # falls (the Medusa heads, seeded from the lm head, accept ~4 a step)
    run("adaptive gamma (n-gram)",
        server(engine(kind="ngram"), None,
               sched=SchedulerParams(adaptive_gamma=True)), plain,
        check=lambda st: sum(1 for n in st["gamma_steps"].values() if n) >= 2)
    run("verify fusion", server(engine(verify_fusion=True)), plain)
    run("deferred", server(engine(deferred=True)), plain)
    lanes = ["medusa", "ngram", "draft"]
    fam = FamilySpecServer({
        "medusa": server(engine()),
        "ngram": server(engine(kind="ngram"), None),
        "draft": server(engine(kind="draft", draft_layers=1),
                        truncated(params, 1))})
    run("FamilySpecServer (medusa, ngram, draft lanes)", fam, plain,
        lanes=lanes, check=lambda sts: all(st["steps"] for st in sts))
    temps = [0.0 if i % 2 == 0 else 0.8 for i in range(len(plain))]
    run("sampled at 0.8, temperature-0 requests mixed in",
        server(engine(accept="sample", seed=5,
                      sampling=SamplingParams(temperature=0.8))),
        plain, temps=temps)
    run("an injected step failure, recovered",
        server(engine(), max_retries=2), plain, fail_at=3,
        check=lambda st: st["admitted"] > len(plain))


def latency_line(res):
    """p50 / p99 of per-request latency and time to first token, ms."""
    lat = np.array([r["latency_s"] for r in res]) * 1e3
    ttft = np.array([r["ttft_s"] for r in res]) * 1e3
    return (f"latency p50 {np.percentile(lat, 50):.1f} ms, p99 "
            f"{np.percentile(lat, 99):.1f} ms; time to first token p50 "
            f"{np.percentile(ttft, 50):.1f} ms, p99 "
            f"{np.percentile(ttft, 99):.1f} ms")


def event_timed_steps(srv):
    """Wrap ``srv``'s decode step so each replay is bracketed by CUDA
    events on the current stream; -> the list the (start, end) pairs go
    to (read with ``elapsed_time`` once the run is over)."""
    pairs = []
    real = srv._step_fn

    def step(level):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = real(level)
        b.record()
        pairs.append((a, b))
        return out
    srv._step_fn = step
    return pairs


class ServedLogits:
    """The served path's own logits, as a witness at a divergence from AR:
    for every token an unfused greedy server delivers, the top two
    (value, index) of the logits row that chose it, read from the run
    itself.  A token at a step's path position j + 1 is the argmax of the
    step's logits at path node j; the first token of a stint in a slot
    (after admission or a preemption's resume) is the argmax of the
    admission's logits (``prefill`` or ``suffix_prefill``).  The step's
    rows are gathered inside the captured graph (a gather and a top-k
    added to it), the admission's from a proxy of the engine's model; both
    are copied out on the device and read after the run.  ``table``
    checks that every delivered token is its row's argmax (a tie counted),
    so the witness is known to be the run's own."""

    def __init__(self, srv):
        eng = srv.engine
        self.srv, self.step, self.unembeds = srv, {}, []
        self.pending, self.records = {}, []
        real_verify, model, witness = eng._verify, eng.model, self

        def verify(cand, logits, q, draws, t, k, p, dt):
            verdict = real_verify(cand, logits, q, draws, t, k, p, dt)
            rows = torch.arange(logits.shape[0], device=logits.device)
            top = torch.topk(logits[rows[:, None], verdict.path_slots]
                             .float(), 2, dim=-1)
            self.step["top"] = (top.values, top.indices)   # [B, K+1, 2]
            return verdict

        class Model:
            def __getattr__(self, name):
                return getattr(model, name)

            def unembed(self, params, cfg, hidden):
                out = model.unembed(params, cfg, hidden)
                witness.unembeds.append(out)
                return out

        eng._verify, eng.model = verify, Model()
        real_admit, real_suffix = srv._admit_fn, srv._suffix_fn
        real_step = srv._step_fn

        def admitted(slots, rows):
            """The admission's first unembed is the base's logits."""
            lg = self.unembeds[0]
            top = torch.topk(lg.float(), 2, dim=-1)
            for s_, r_ in zip(slots, rows):
                self.pending[s_] = (top.values[r_], top.indices[r_])

        def admit(toks, plens, gtemp, gtopp, slots, rows, *rest):
            self.unembeds.clear()
            out = real_admit(toks, plens, gtemp, gtopp, slots, rows, *rest)
            admitted(slots.tolist(), rows.tolist())
            return out

        def suffix(stoks, nv, mlen, smask, *rest):
            self.unembeds.clear()
            out = real_suffix(stoks, nv, mlen, smask, *rest)
            live = smask.nonzero()[:, 0].tolist()
            admitted(live, live)
            return out

        def step(level):
            pre = [(i, sl.request.rid, len(sl.request.output))
                   for i, sl in enumerate(srv.slots)
                   if sl.request is not None and srv._active[i]]
            out = real_step(level)
            vals, idx = (t.clone() for t in self.step["top"])
            for i, rid, start in pre:
                if i in self.pending:
                    pv, pi = self.pending.pop(i)
                    self.records.append(("base", rid, start, pv, pi))
                self.records.append(("step", rid, start, vals[i], idx[i]))
            return out

        srv._admit_fn, srv._suffix_fn, srv._step_fn = admit, suffix, step

    def table(self, results):
        """{(result index, position): (v1, i1, v2, i2)} for every
        delivered token, after checking each is its row's argmax."""
        srv = self.srv
        rids = sorted(srv.done)
        if len(rids) != len(results) or any(
                list(srv.done[r].output) != list(res["output"])
                for r, res in zip(rids, results)):
            fail("the witness's requests are not the launcher's results")
        index = {rid: n for n, rid in enumerate(rids)}
        rows = {}
        for kind, rid, start, vals, idx in self.records:
            vals, idx = vals.cpu().tolist(), idx.cpu().tolist()
            if kind == "base":
                rows[index[rid], start] = (vals[0], idx[0], vals[1], idx[1])
                continue
            for j, (v, i) in enumerate(zip(vals, idx)):
                rows[index[rid], start + 1 + j] = (v[0], i[0], v[1], i[1])
        for n, res in enumerate(results):
            for pos, tok in enumerate(res["output"]):
                w = rows.get((n, pos))
                if w is None or not (tok == w[1] or (tok == w[3]
                                                     and w[0] == w[2])):
                    fail(f"the served-logits witness does not reproduce "
                         f"request {n}'s token {int(tok)} at {pos}: {w}")
        return rows


def check_server_against_ar(label, served, dev, witness=None, gate=True):
    """Each answer of a server run matches ``ar_generate`` on its config up
    to its first divergence, where AR ranks the emitted token within
    ``MARGIN_BOUND`` of its top logit (openPangu-7B; another model's
    divergence ``near_tie`` must accept, and a MoE's logs ``router_gap``
    there).  With ``gate`` False (a MoE at the capacity factor that drops)
    the divergences are logged, not held.  With ``witness`` (a
    ``ServedLogits`` on an unfused prefix-cache run: a request's prompt
    rows were written by another request's prefill, and its suffix's by
    a causal ``suffix_prefill`` pass through K1, each in bf16, where AR
    computes them in its own prefill) each divergence also logs the
    served path's own gap between the two tokens, and one more case is
    accepted: AR's gap exactly two bf16 steps (one rounding each way of
    the two competing logits) where the served logits tie them exactly
    and the tie went to the lower index, the served token's.  Returns how
    many answers equal AR's."""
    res, prompts, cfg = served.results, served.prompts, served.cfg
    n_max = max(r["max_new"] for r in res)
    outs = [torch.tensor(r["output"], dtype=torch.long) for r in res]
    gaps = {}
    seen = None if witness is None else witness.table(res)

    def observe(rows, t, logits):
        lf = logits.float()
        top = lf.max(dim=-1).values
        for j, i in enumerate(rows):
            if t < len(outs[i]):
                gaps[i, t] = (top[j] - lf[j, outs[i][t]], top[j])

    res_params = served.params
    ar = serve_ar(cfg, res_params, prompts, n_max, dev, observe,
                  served.frames)
    gaps = {k: (float(g), float(t)) for k, (g, t) in gaps.items()}
    diverged, worst, ties = 0, 0.0, 0
    for i, r in enumerate(res):
        n = len(outs[i])
        differ = (outs[i] != ar[i, :n]).nonzero()
        if len(differ) == 0:
            continue
        at = int(differ[0, 0])
        gap, top = gaps[i, at]
        s_tok, a_tok = int(outs[i][at]), int(ar[i, at])
        diverged += 1
        worst = max(worst, gap)
        tie, served = False, ""
        if seen is not None:
            v1, i1, v2, i2 = seen[i, at]
            if {i1, i2} == {s_tok, a_tok}:
                s_gap = v1 - v2 if i1 == s_tok else v2 - v1
                tie = s_gap == 0.0 and s_tok < a_tok
                served = (f"; the served logits put it {s_gap:.5f} above "
                          f"AR's token (top {v1:.5f})")
            else:
                served = (f"; AR's token is not in the served top two "
                          f"({i1} {v1:.5f}, {i2} {v2:.5f})")
        if cfg.name.startswith("openpangu-7b"):
            ok = gap < MARGIN_BOUND or (tie and gap == MARGIN_BOUND)
        else:
            ok = near_tie(cfg, gap, top, s_tok, a_tok)[0]
        ties += ok and gap >= MARGIN_BOUND
        if cfg.num_experts:
            p = torch.from_numpy(prompts[i][None]).to(dev)
            served += router_gap(
                cfg, res_params, p,
                torch.tensor([p.shape[1]], dtype=torch.int32, device=dev),
                ar[i, :at], None)
        log(f"  {label}: request {i} == AR for {at} tokens, then the served "
            f"token {s_tok} where AR's is {a_tok}, {gap:.5f} below AR's top "
            f"{top:.5f}{served}")
        if gate and not ok:
            fail(f"{label}: request {i} diverges from AR at token {at}, "
                 f"where AR ranks the served token {s_tok} {gap} below its "
                 f"top {a_tok} ({top}; bound {MARGIN_BOUND}{served})")
    log(f"  {label}: {len(res) - diverged} of {len(res)} answers == AR "
        f"token for token, the rest near ties at their first divergence "
        f"(largest gap {worst:.5f}; {ties} at {MARGIN_BOUND} with the "
        f"served logits tied"
        + (f", the witness checked on {len(seen)} served tokens)"
           if seen is not None else ")"))
    return len(res) - diverged


PAGED_13B = "paged 64, verify fusion, prefix cache, preemption"
PAGED_13B_UNFUSED = "paged 64, prefix cache, preemption"


def phase_serving_full(dev, static):
    """Phase 13b: the launcher's continuous-batching server on phase 5's
    bf16 openPangu-7B (full width and depth) and weights: 16 requests
    (phase 5's 8 prompts and 8 more from the same generator), 4 slots,
    max_len 2048, max_new drawn from 16..64, so slots free at different
    times and refill; unfused, with --verify-fusion, and paged (page 64)
    with --prefix-cache --preemption, unfused and with --verify-fusion
    (the suffix admissions run K1, and K3 fused, at the suffix_prefill
    shapes), over 4 shared bases of 224 tokens (3.5 pages: CoW) plus
    16..64-token suffixes in a pool of about 3/4 of the concurrent worst
    case.  Each answer held to ``ar_generate`` under ``MARGIN_BOUND``; the
    unfused paged run carries a ``ServedLogits`` witness (its timings
    include the witness's gather, top-k and host reads), which logs the
    served side of each divergence and decides the one case beyond
    ``MARGIN_BOUND`` that ``check_server_against_ar`` accepts; launches
    exact; one graph per level."""
    from repro_torch.launch import serve

    argv = ["--requests", "16", "--slots", "4", "--max-len", str(MAX_LEN),
            "--min-new", "16", "--max-new", "64", "--seed", str(SEED)]
    weights = (static.params, static.proposer_params)
    worst = -(-(224 + 64 + 64 + 66) // 64)        # blocks a request, worst
    n_blocks = 1 + (3 * 4 * worst) // 4
    paged = ["--cache-layout", "paged", "--page-size", "64",
             "--prefix-cache", "--preemption", "--shared-prefix", "224",
             "--min-prompt", "16", "--max-prompt", "65", "--n-blocks",
             str(n_blocks)]
    runs = {}
    for label, flags in (
            ("dense", ["--min-prompt", "64", "--max-prompt", "257"]),
            ("dense, verify fusion", ["--min-prompt", "64", "--max-prompt",
                                      "257", "--verify-fusion"]),
            (PAGED_13B_UNFUSED, paged),
            (PAGED_13B, paged + ["--verify-fusion"])):
        reset_counts()
        pairs, witness = [], []
        real_main_server = serve.SpecServer

        class Timed(real_main_server):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                pairs.append(event_timed_steps(self))
                if label == PAGED_13B_UNFUSED:
                    witness.append(ServedLogits(self))
        serve.SpecServer = Timed
        try:
            served = serve.main(argv + flags, weights=weights)
        finally:
            serve.SpecServer = real_main_server
        counts = read_counts()
        srv = served.server
        want = serve_expected(srv)
        if counts != want:
            fail(f"13b {label}: launches {counts}, expected {want}")
        caps = check_server_graphs(f"13b {label}", srv)
        if any(r["status"] != "done" or len(r["output"]) != r["max_new"]
               for r in served.results):
            fail(f"13b {label}: not every request finished: "
                 + str([(r["rid"], r["status"], len(r["output"]))
                        for r in served.results]))
        st, tm = srv.stats, srv.timing
        dev_ms = [a.elapsed_time(b) for a, b in pairs[0]]
        host_ms = (tm["iter_s"] - tm["step_s"]) * 1e3 / tm["iterations"]
        admit_ms = tm["admit_s"] * 1e3 / tm["iterations"]
        log(f"  13b {label}: {served.tokens} tokens in {served.seconds:.3f}s "
            f"= {served.tokens / served.seconds:.1f} tok/s ({smi_line()}); "
            f"{latency_line(served.results)}; {served.iterations} scheduler "
            f"iterations, host {host_ms:.2f} ms an iteration outside the "
            f"step's replay and sync read ({admit_ms:.2f} ms of it in "
            f"admission and suffix calls); the replayed serve step "
            f"{np.median(dev_ms):.2f} ms median on the card (CUDA events "
            f"around the replay, {len(dev_ms)} steps); capture s by level "
            f"{ {g: round(s, 3) for g, s in caps.items()} }; launches "
            f"{counts} (exact); stats {json.dumps(st, default=int)}")
        if label.startswith("paged"):
            dense_worst = 4 * (MAX_LEN // 64)
            log(f"  13b paged: peak {st['peak_blocks']} blocks of a "
                f"{n_blocks - 1}-block pool (the dense layout's worst case "
                f"{dense_worst}); {st['preemptions']} preemptions, "
                f"{st['cow_copies']} CoW copies, {st['cached_tokens']} "
                f"prompt tokens from the prefix cache")
            if not (st["preemptions"] >= 1 and st["cow_copies"] >= 1
                    and st["peak_blocks"] < dense_worst):
                fail(f"13b paged: preemption, CoW or the pool did not do "
                     f"their part: {st}")
        check_server_against_ar(f"13b {label}", served, dev,
                                witness=witness[0] if witness else None)
        runs[label] = served
    log(f"  the static launcher on phase 5's 8 prompts (phase 5): "
        f"{static.tokens / static.seconds:.1f} tok/s; the server on 16 "
        f"(8 of them phase 5's): "
        + ", ".join(f"{k} {v.tokens / v.seconds:.1f} tok/s"
                    for k, v in runs.items()))
    return runs


# ---------------------------------------------------------------------------
# phase 11: training (dense family)
# ---------------------------------------------------------------------------

TRAIN_TOL = 1e-4          # card against CPU, in units of a leaf's largest


def leaf_gap(got, ref) -> float:
    """max |got - ref| over ref's largest magnitude."""
    g, r = got.detach().float().cpu(), ref.detach().float().cpu()
    return ((g - r).abs().max() / r.abs().max().clamp(min=1e-30)).item()


def tree_gap(got, ref) -> dict:
    """{leaf path: leaf_gap} of two nested dicts of tensors."""
    from repro_torch.training.checkpoint import _flatten
    return {k: leaf_gap(g, r) for (k, g), (_, r) in
            zip(_flatten(got), _flatten(ref))}


def phase_train_parity(dev):
    """(i) One ``lm_train_step`` and one ``medusa_train_step`` on reduced
    float32 openPangu-7B, the same weights and batch on the card and on
    the CPU: the loss, every gradient leaf (``steps.value_and_grad``) and
    the updated parameters and moments within ``TRAIN_TOL`` of each leaf's
    largest magnitude: the whole step's parameters against the CPU's
    step, and, beside it, the card's parameters and moments against the
    CPU's optimizer (clip + AdamW) run on the card's gradients, which
    holds the optimizer apart from the gradients.  Deterministic
    algorithms are on for the card's work, so the step's gradients are the
    ones ``value_and_grad`` returns."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core import medusa as M
    from repro_torch.models import transformer as TT
    from repro_torch.training import data as D
    from repro_torch.training import optimizer as O
    from repro_torch.training import steps as ST

    cfg = get_config("openpangu-7b", reduced=True)
    cpu = torch.device("cpu")
    gen = torch.Generator().manual_seed(5)
    params = TT.init_params(gen, cfg)
    mp = M.init_medusa(gen, cfg, 3, base_lm_head=params["lm_head"])
    # a residual block away from its zero init, so w1's path is exercised
    for name in ("w1", "b1"):
        mp[name].normal_(generator=gen).mul_(0.05)
    corpus = D.synthetic_chat(D.SyntheticChatConfig(
        vocab_size=cfg.vocab_size, seq_len=65, n_samples=16, noise=0.05))
    pad = D.special_id(cfg.vocab_size, D.PAD)

    def on(tree, d):
        return O.tree_map(lambda t: t.to(d, copy=True), tree)

    cases = {
        "lm_train_step": (
            lambda p, x, bb: ST.value_and_grad(ST.lm_loss, p, cfg, x[:, :-1],
                                               x[:, 1:]),
            lambda p, o, x, bb: ST.lm_train_step(p, o, cfg, x[:, :-1],
                                                 x[:, 1:]),
            params, dict(lr=3e-4, weight_decay=0.1)),
        "medusa_train_step": (
            lambda p, x, bb: ST.value_and_grad(ST.medusa_loss, p, bb, cfg, x,
                                               3, pad_id=pad),
            lambda p, o, x, bb: ST.medusa_train_step(p, o, bb, cfg, x, 3,
                                                     pad_id=pad),
            mp, dict(lr=1e-3))}
    batch = torch.from_numpy(corpus)
    for label, (vg, step, tree, opt_kw) in cases.items():
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            (loss_d, _), g_d = vg(on(tree, dev), batch.to(dev),
                                  on(params, dev))
            p_d, o_d, met = step(on(tree, dev), O.adamw_init(on(tree, dev)),
                                 batch.to(dev), on(params, dev))
            torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(False)
        (loss_c, _), g_c = vg(on(tree, cpu), batch, params)
        p_c, o_c, _ = step(on(tree, cpu), O.adamw_init(on(tree, cpu)), batch,
                           params)
        # the CPU's optimizer on the card's gradients
        g_ref, _ = O.clip_by_global_norm(on(g_d, cpu), 1.0)
        p_r, o_r = O.adamw_update(g_ref, O.adamw_init(tree), on(tree, cpu),
                                  **opt_kw)
        loss_gap = abs(float(loss_d) - float(loss_c)) / abs(float(loss_c))
        gaps = {"gradients": tree_gap(g_d, g_c),
                "the step's parameters": tree_gap(p_d, p_c),
                "parameters (CPU optimizer, card gradients)":
                    tree_gap(p_d, p_r),
                "first moments": tree_gap(o_d.mu, o_r.mu),
                "second moments": tree_gap(o_d.nu, o_r.nu)}
        log(f"  {label}, card against CPU: loss {float(loss_d):.6f} vs "
            f"{float(loss_c):.6f} (relative gap {loss_gap:.2e}, metrics "
            f"loss {float(met['loss']):.6f}); largest gaps in units of each "
            f"leaf's largest magnitude: "
            + ", ".join(f"{k} {max(v.values()):.2e}" for k, v in gaps.items()))
        bad = {k: {n: x for n, x in v.items() if not x <= TRAIN_TOL}
               for k, v in gaps.items()}
        if not loss_gap <= TRAIN_TOL or any(bad.values()):
            fail(f"{label}: card against CPU beyond {TRAIN_TOL}: loss gap "
                 f"{loss_gap}, leaves {bad}")


def timed_steps(n, fn):
    """Run ``fn()`` ``n`` times, each timed on the host around synchronised
    work; returns (the per-step losses fn returns, ms per step from the
    second step on)."""
    losses, ms = [], []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(fn()))
        ms.append((time.perf_counter() - t0) * 1e3)
    return losses, float(np.median(ms[1:]))


def phase_train_full(dev, params):
    """(ii) At full width: self-distil 8 prompts of the synthetic corpus
    (64 tokens each, 64 new) with ``ar_generate`` on ``params``, the bf16
    openPangu-7B of phase 5; 20 ``medusa_train_step``s of K 4 float32
    heads on that set (the loss finite and lower at the end); the heads
    through ``checkpoint.save`` / ``restore`` bit for bit; then 10
    ``lm_train_step``s of qwen1.5-0.5b (float32 master weights, bf16
    products) on one repeated batch of 8 x 512 (the loss must fall).  ms
    per step and peak memory of each."""
    import tempfile

    from repro_torch.configs.registry import get_config
    from repro_torch.core import medusa as M
    from repro_torch.models import transformer as TT
    from repro_torch.training import checkpoint as C
    from repro_torch.training import data as D
    from repro_torch.training import optimizer as O
    from repro_torch.training import steps as ST

    cfg = get_config("openpangu-7b")
    backbone_gib = sum(t.numel() * t.element_size()
                       for t in O.tree_leaves(params)) / 2**30
    prompts = D.synthetic_chat(D.SyntheticChatConfig(
        vocab_size=cfg.vocab_size, seq_len=128, n_samples=8))
    t0 = time.perf_counter()
    distilled = D.self_distill(params, TT, cfg, prompts, 64, batch=8,
                               device=dev)
    log(f"  self-distilled {distilled.shape[0]} x {distilled.shape[1]} "
        f"tokens through ar_generate in {time.perf_counter() - t0:.3f}s")
    if distilled.shape != (8, 128) or not np.array_equal(distilled[:, :64],
                                                         prompts[:, :64]):
        fail(f"self_distill returned {distilled.shape}, or not the prompts")
    K = 4
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(7)
    mp = M.init_medusa(gen, cfg, K, base_lm_head=params["lm_head"],
                       dtype="float32")
    state = {"mp": mp, "opt": O.adamw_init(mp)}
    batch = torch.from_numpy(distilled).to(dev)
    pad = D.special_id(cfg.vocab_size, D.PAD)
    n_heads = sum(t.numel() for t in O.tree_leaves(mp))

    def head_step():
        state["mp"], state["opt"], met = ST.medusa_train_step(
            state["mp"], state["opt"], params, cfg, batch, K, pad_id=pad)
        state["acc"] = met["head_acc"]
        return met["loss"]

    losses, ms = timed_steps(20, head_step)
    dev_ms = device_ms(head_step, 2, warmup=0)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"  medusa_train_step, K {K} float32 heads ({n_heads / 1e9:.3f} B "
        f"parameters) over the bf16 backbone, batch 8 x 128: loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}, head top-1 "
        f"{[round(a, 3) for a in state['acc'].tolist()]}; {ms:.1f} ms/step "
        f"(median of steps 2-20), device {dev_ms:.1f} ms/step (steps 21-22, "
        f"profiler); peak memory {peak:.2f} GiB")
    if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
        fail(f"full-width head training: losses {losses}")
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        path = C.save(d, 20, state["mp"], meta={"K": K})
        step, back, meta = C.restore(path, state["mp"])
        same = all(torch.equal(a, b) for (_, a), (_, b) in
                   zip(C._flatten(back), C._flatten(state["mp"])))
        log(f"  the heads through checkpoint.save / restore: bitwise "
            f"{same} (step {step}, meta {meta}) in "
            f"{time.perf_counter() - t0:.1f}s")
        if not same or step != 20:
            fail("the heads did not round-trip through the checkpoint")
    del state, mp, back
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    qcfg = get_config("qwen1.5-0.5b")
    qp = TT.init_params(torch.Generator(device=dev).manual_seed(8), qcfg)
    qstate = {"p": qp, "opt": O.adamw_init(qp)}
    data = D.synthetic_chat(D.SyntheticChatConfig(
        vocab_size=qcfg.vocab_size, seq_len=513, n_samples=8))
    x = torch.from_numpy(data).to(dev)

    def lm_step():
        qstate["p"], qstate["opt"], met = ST.lm_train_step(
            qstate["p"], qstate["opt"], qcfg, x[:, :-1], x[:, 1:])
        return met["loss"]

    losses, ms = timed_steps(10, lm_step)
    dev_ms = device_ms(lm_step, 2, warmup=0)
    peak = torch.cuda.max_memory_allocated() / 2**30
    n = sum(t.numel() for t in O.tree_leaves(qp))
    log(f"  lm_train_step, qwen1.5-0.5b at full width ({n / 1e9:.3f} B "
        f"float32 parameters, bf16 products, remat), one batch of 8 x 512 "
        f"ten times: loss {losses[0]:.4f} -> {losses[-1]:.4f}; {ms:.1f} "
        f"ms/step (median of steps 2-10), device {dev_ms:.1f} ms/step "
        f"(steps 11-12, profiler); peak memory {peak:.2f} GiB, the bf16 "
        f"openPangu-7B backbone's {backbone_gib:.2f} GiB included")
    if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
        fail(f"qwen1.5-0.5b training: losses {losses}")


# the reference's benchmarks/bench_fig34_speedup.py: its lengths, batch,
# prompt and new tokens, and its tree
FIG34_LENGTHS, FIG34_B, FIG34_PROMPT, FIG34_NEW = (128, 256, 512, 1024), 4, \
    16, 32


def phase_trained_stack(dev, params=None):
    """(iii) The counterpart of ``benchmarks/common.py::trained_stack`` and
    ``bench_fig34_speedup.py`` on reduced openPangu-7B (float32), with the
    reference's steps and sizes: 150 ``lm_train_step``s (batch 16, lr
    1e-3) on the synthetic corpus (512 x 64, noise 0.05); self-distil 256
    prompts x 32 tokens; 120 ``medusa_train_step``s of K 3 heads (batch
    16, lr 1e-3).  Logs each head's top-1 accuracy (the Table 2 metric);
    then, on the reference's cartesian (4, 2, 1) tree and its cache
    lengths, the mean accepted length, the spec/AR step ratio and the
    speedup of ``SpecEngine.generate`` against ``ar_generate`` (both on
    the plain attention path, as the reference's bench runs them: K1 has
    no head_dim-16 instance), for the trained heads and for the same
    heads before training (the Medusa init: copies of the lm head).
    Gates: greedy spec == AR everywhere, and on 16 held-out corpus prompts
    of the bench's 16 tokens the trained heads accept more tokens a step
    than the untrained ones, both in one batch (whose steps are its
    slowest row's) and as the mean of each row run alone (the bench's
    contexts are whole corpus rows, whose continuations run past EOS into
    PAD, which the untrained heads predict as well as the trained).
    ``params``: the backbone's initial weights (default: drawn from seed
    0 on ``dev``)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core import medusa as M
    from repro_torch.core.engine import SpecEngine, ar_generate
    from repro_torch.core.tree import cartesian_tree
    from repro_torch.models import transformer as TT
    from repro_torch.runtime import StepGraphs
    from repro_torch.training import data as D
    from repro_torch.training import optimizer as O
    from repro_torch.training import steps as ST

    cfg = get_config("openpangu-7b", reduced=True)
    if params is None:
        params = TT.init_params(torch.Generator(device=dev).manual_seed(0),
                                cfg)
    corpus = D.synthetic_chat(D.SyntheticChatConfig(
        vocab_size=cfg.vocab_size, seq_len=64, n_samples=512, noise=0.05))
    st = {"p": params, "opt": O.adamw_init(params)}
    it = D.batches(corpus, 16, seed=1)

    def lm_step():
        b = torch.from_numpy(next(it)).to(dev)
        st["p"], st["opt"], met = ST.lm_train_step(st["p"], st["opt"], cfg,
                                                   b[:, :-1], b[:, 1:],
                                                   lr=1e-3)
        return met["loss"]

    t0 = time.perf_counter()
    lm_losses, lm_ms = timed_steps(150, lm_step)
    params = st["p"]
    distilled = D.self_distill(params, TT, cfg, corpus[:256], 32,
                               device=dev)
    K = 3
    mp = M.init_medusa(torch.Generator(device=dev).manual_seed(2), cfg, K,
                       base_lm_head=params["lm_head"])
    untrained = O.tree_map(torch.clone, mp)
    hs = {"mp": mp, "opt": O.adamw_init(mp)}
    hit = D.batches(distilled, 16, seed=3)
    pad = D.special_id(cfg.vocab_size, D.PAD)

    def head_step():
        b = torch.from_numpy(next(hit)).to(dev)
        hs["mp"], hs["opt"], met = ST.medusa_train_step(
            hs["mp"], hs["opt"], params, cfg, b, K, lr=1e-3, pad_id=pad)
        hs["acc"] = met["head_acc"]
        return met["loss"]

    head_losses, head_ms = timed_steps(120, head_step)
    acc = [round(a, 3) for a in hs["acc"].tolist()]
    log(f"  trained stack in {time.perf_counter() - t0:.1f}s: LM loss "
        f"{lm_losses[0]:.4f} -> {lm_losses[-1]:.4f} ({lm_ms:.2f} ms/step); "
        f"self-distilled {distilled.shape[0]} x {distilled.shape[1]}; head "
        f"loss {head_losses[0]:.4f} -> {head_losses[-1]:.4f} "
        f"({head_ms:.2f} ms/step); head top-1 accuracy (Table 2's metric) "
        f"{acc}")

    tb = cartesian_tree((4, 2, 1))
    B, P, NEW = FIG34_B, FIG34_PROMPT, FIG34_NEW
    rows = []
    for L in FIG34_LENGTHS:
        S_max = L + tb.T + 8
        pad_ctx = max(L - NEW - P, 0)
        # the reference's context: the prompt, then up to pad_ctx more
        # corpus tokens (its rows hold 64, so 64 tokens at every L; what
        # grows with L is the cache)
        ctx = np.concatenate([corpus[:B, :P],
                              corpus[:B, P:P + pad_ctx] % cfg.vocab_size],
                             axis=1).astype(np.int32)
        tok = torch.from_numpy(ctx).to(dev)
        ctx_len = torch.full((B,), ctx.shape[1], dtype=torch.int32,
                             device=dev)
        ar_graphs = StepGraphs(dev)
        ar_cache = TT.init_cache(cfg, B, S_max, device=dev)

        def ar_run():
            return ar_generate(cfg, params, tok, ctx_len, ar_cache, NEW,
                               graphs=ar_graphs)[0]

        row = {"L": L}
        t_ar, ar = median_s(ar_run)
        for heads, weights in (("trained", hs["mp"]), ("untrained",
                                                       untrained)):
            eng = SpecEngine(cfg, tb, device=dev)
            cache = eng.init_cache(B, S_max)

            def sp_run():
                return eng.generate(params, weights, tok, ctx_len, cache,
                                    NEW)

            t_sp, (out, n_out, stats) = median_s(sp_run)
            if not torch.equal(out, ar):
                fail(f"trained stack, L {L}, {heads} heads: spec != AR:\n"
                     f"{out.tolist()}\n{ar.tolist()}")
            steps = max(stats.steps, 1)
            ac = float(n_out.float().mean()) / steps
            overhead = (t_sp / steps) / (t_ar / NEW)
            row[heads] = dict(accept=ac, steps=steps, overhead=overhead,
                              speedup=t_ar / t_sp, ms=t_sp * 1e3)
        row["ar_ms"] = t_ar * 1e3
        rows.append(row)
        tr, un = row["trained"], row["untrained"]
        log(f"  L {L}: spec == AR; trained heads: accepted {tr['accept']:.3f}"
            f" tokens/step ({tr['steps']} steps), spec/AR step ratio "
            f"{tr['overhead']:.3f}, speedup {tr['speedup']:.3f} ({tr['ms']:.1f}"
            f" ms against AR's {row['ar_ms']:.1f} ms for {B} x {NEW}); "
            f"untrained: accepted {un['accept']:.3f}, step ratio "
            f"{un['overhead']:.3f}, speedup {un['speedup']:.3f}")
    # the gate: held-out corpus rows cut to the bench's 16-token prompt,
    # whose continuation is the grammar's text (each context above is a
    # whole 64-token row, whose continuation runs past its EOS into PAD,
    # where the untrained heads, copies of the lm head, already agree)
    tok = torch.from_numpy(np.ascontiguousarray(corpus[256:272, :P])).to(dev)
    plen = torch.full((16,), P, dtype=torch.int32, device=dev)
    ar = ar_generate(cfg, params, tok, plen,
                     TT.init_cache(cfg, 16, P + NEW + tb.T + 8, device=dev),
                     NEW)[0]
    held, per_row = {}, {}
    for heads, weights in (("trained", hs["mp"]), ("untrained", untrained)):
        eng = SpecEngine(cfg, tb, device=dev)
        out, n_out, stats = eng.generate(params, weights, tok, plen,
                                         eng.init_cache(16, P + NEW + tb.T + 8),
                                         NEW)
        if not torch.equal(out, ar):
            fail(f"trained stack, held-out prompts, {heads} heads: spec != "
                 f"AR:\n{out.tolist()}\n{ar.tolist()}")
        held[heads] = float(n_out.float().mean()) / max(stats.steps, 1)
        # each row alone: the batch's steps are its slowest row's
        cache = eng.init_cache(1, P + NEW + tb.T + 8)
        per_row[heads] = []
        for b in range(16):
            out, n_out, stats = eng.generate(params, weights, tok[b:b + 1],
                                             plen[:1], cache, NEW)
            if not torch.equal(out[0], ar[b]):
                fail(f"trained stack, held-out prompt {b} alone, {heads} "
                     f"heads: spec != AR")
            per_row[heads].append(float(n_out[0]) / max(stats.steps, 1))
    row_mean = {h: float(np.mean(v)) for h, v in per_row.items()}
    log(f"  16 held-out prompts of {P} tokens, {NEW} new: spec == AR; "
        f"accepted {held['trained']:.3f} tokens/step with the trained heads, "
        f"{held['untrained']:.3f} with the untrained (the batch's steps); "
        f"each row alone: mean {row_mean['trained']:.3f} trained, "
        f"{row_mean['untrained']:.3f} untrained; per row trained "
        f"{[round(a, 3) for a in per_row['trained']]}, untrained "
        f"{[round(a, 3) for a in per_row['untrained']]}")
    if not (held["trained"] > held["untrained"]
            and row_mean["trained"] > row_mean["untrained"]):
        fail(f"the trained heads accept {held['trained']} tokens a step on "
             f"held-out prompts ({row_mean['trained']} a row alone), no more "
             f"than the untrained heads' {held['untrained']} "
             f"({row_mean['untrained']})")
    return acc, rows


# ---------------------------------------------------------------------------
# phase 17: tensor parallelism (TPSpecEngine on torch.distributed)
# ---------------------------------------------------------------------------

def tp_backend(ranks: int) -> str:
    """nccl when every rank has a card of its own; else gloo, passed
    explicitly, the ranks sharing the card."""
    return "nccl" if torch.cuda.device_count() >= ranks else "gloo"


def tp_f32_rank(rank, world, dev, tp, tok, plen, max_new, max_len):
    """Phase 17 (a) on one rank of a ``tp``-way group: phase 4's weights
    (drawn alike on every rank from the same seed) sliced for the rank,
    then ``TPSpecEngine.generate`` on the dense, int8, paged and int8 +
    paged caches, Medusa and n-gram, greedy and sampled at temperature 0,
    each with the counts set to 0 just before and read just after.  Under
    gloo the rank first probes gloo's CUDA path (``probe_gloo_cuda``)."""
    from repro_torch.configs.base import SamplingParams
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed import tp as TPM
    from repro_torch.launch.serve import build_model

    mesh = TPM.make_tp_group(tp, data=world // tp)
    out = {"probe": (C.probe_gloo_cuda("model", dev)
                     if mesh.backend == "gloo" else None)}
    base = f32_base()
    params, mp = build_model(base, 1, 4, dev)
    tok, plen = tok.to(dev), plen.to(dev)
    runs = {}
    for label, dtype, layout, ps in TP_LAYOUTS:
        cfg = dataclasses.replace(base, cache_dtype=dtype,
                                  cache_layout=layout, page_size=ps)
        for proposer in ("medusa", "ngram"):
            for accept in ("greedy", "sample"):
                tpe = TPM.build_tp_engine(
                    cfg, mesh, proposer, use_kernel=True, device=dev,
                    accept=accept, seed=11,
                    sampling=SamplingParams(temperature=0.0))
                sp = tpe.shard_params(params)
                pp = mp if proposer == "medusa" else None
                cache = tpe.init_cache(4, max_len)
                reset_counts()
                with C.metered() as meter:
                    o, n, st = tpe.generate(sp, pp, tok, plen, cache,
                                            max_new)
                counts = read_counts()
                lc = tpe.local_cfg
                rows = -(-max_len // ps) * ps if lc.paged else max_len
                runs[label, proposer, accept] = dict(
                    out=o.cpu(), n=n.cpu(), steps=st.steps, counts=counts,
                    want=expected_counts(lc, st.steps),
                    routes=read_routes()["K1"],
                    want_routes=k1_routes(lc, 4, rows, st.steps,
                                          T=tpe.tb.T),
                    collectives=meter.total())
                del tpe, sp, cache
    out["runs"] = runs
    return out


def phase_tp_f32(dev, want, tok, plen, max_new, max_len, tp=TP):
    """Phase 17 (a): f32 full width, 2 layers, tp ``tp``: every rank's
    ``TPSpecEngine`` tokens == phase 4's single-device spec and AR tokens
    (``want``: fp and int8) on four layouts, Medusa and n-gram, greedy
    and sampled at temperature 0, with K1 and K4 / K5 launched exactly as
    ``expected_counts`` says at the local head count, K1 on its routes.
    Returns rank 0's launches by layout, summed over its runs."""
    from repro_torch.distributed import collectives as C

    backend = tp_backend(tp)
    log(f"  tp {tp} on {backend} ({torch.cuda.device_count()} card(s) "
        f"visible): {'a card a rank' if backend == 'nccl' else 'the ranks share card 0'}")
    try:
        outs = C.spawn(tp_f32_rank, tp, backend=backend, device=dev.type,
                       args=(tp, tok.cpu(), plen.cpu(), max_new, max_len),
                       timeout=600)
    except Exception as e:                     # a rank's traceback
        fail(f"tp {tp} f32 ranks failed: {e}")
    if outs[0]["probe"] is not None:
        log(f"  gloo on CUDA tensors: {outs[0]['probe']} (native: gloo's "
            f"own CUDA path, each result equal to the CPU's; staged: "
            f"through pinned host memory by collectives.py)")
    by_layout = {}
    for key, run in outs[0]["runs"].items():
        label, proposer, accept = key
        ref = want["int8" if "int8" in label else ""]
        for r, o in enumerate(outs):
            other = o["runs"][key]
            if not torch.equal(other["out"], ref):
                fail(f"tp {tp} f32 {key} rank {r}: tokens != phase 4's "
                     f"single-device spec and AR:\n{other['out'].tolist()}"
                     f"\n{ref.tolist()}")
            if other["counts"] != other["want"] \
                    or other["routes"] != other["want_routes"]:
                fail(f"tp {tp} f32 {key} rank {r}: launches "
                     f"{other['counts']} by route {other['routes']}, "
                     f"expected {other['want']} {other['want_routes']}")
        n_coll, coll_ms = run["collectives"]
        log(f"  tp {tp} f32 {label} {proposer} {accept}: every rank == "
            f"phase 4's spec and AR for 4 x {max_new} tokens; {run['steps']} "
            f"steps; launches a rank {run['counts']} (exact), K1 routes "
            f"{run['routes']}; {n_coll / run['steps']:.1f} collectives a "
            f"step, {coll_ms / run['steps']:.3f} ms a step")
        acc = by_layout.setdefault(label, dict.fromkeys(run["counts"], 0))
        for k, n in run["counts"].items():
            acc[k] += n
    return by_layout


def phase_tp_serve(dev, single=None, tp=TP, mesh_shape=""):
    """Phase 17 (b): the launcher at ``--tp`` on bf16 openPangu-7B, full
    width and depth, 8 requests, 4 slots, 64 new: every request done, every
    rank's answers rank 0's, K1 and the commit launched exactly (34 a step,
    one a step), each answer held to single-device AR under
    ``MARGIN_BOUND`` (the rank sums add the ``wo`` products in another
    order); tokens/s, wall and device ms a step, the collectives' ms a
    step and peak memory per rank logged beside phase 5's single-card
    figures (``single``).  AR runs on card 0 after the ranks are gone, on
    the same weights drawn from the launcher's seed.  Returns the run."""
    from types import SimpleNamespace

    from repro_torch.launch import serve

    data = int(mesh_shape.split("x")[0]) if mesh_shape else 1
    backend = tp_backend(data * tp)
    argv = SERVE_ARGV + ["--tp", str(tp), "--tp-backend", backend,
                         "--profile-steps", "2"]
    if mesh_shape:
        argv += ["--mesh-shape", mesh_shape]
    try:
        run = serve.main(argv)
    except Exception as e:
        fail(f"--tp {tp} {mesh_shape}: {e}")
    res = run.results
    if any(r["status"] != "done" or len(r["output"]) != MAX_NEW
           for r in res):
        fail(f"--tp {tp}: not every request finished")
    for r in run.ranks:
        steps = r["steps"]
        want = {"K1": run.cfg.num_layers * steps, "K4": steps, "K5": 0}
        prof = r["profile"]
        log(f"  --tp {tp} {mesh_shape or ''} ({backend}) rank {r['rank']} "
            f"{r['coords']} on {r['device']}: {r['tokens'] / r['seconds']:.1f}"
            f" tok/s, {steps} steps, wall {r['seconds'] * 1e3 / steps:.3f} "
            f"ms a step (prefill included); traced step: wall "
            f"{prof['wall_ms']:.3f} ms, device {prof['device_ms']:.3f} ms "
            f"(idle {prof['idle']:.3f}), {prof['launches']:.0f} launches, "
            f"collectives {prof['collectives']:.1f} taking "
            f"{prof['collective_ms']:.3f} ms (served run: "
            f"{r['collective_ms'] / steps:.3f} ms a step), NCCL kernels "
            f"{prof['nccl_ms']:.4f} ms, memcpy {prof['copy_ms']:.4f} ms; "
            f"peak {r['peak_bytes'] / 2 ** 30:.2f} GiB; launches "
            f"{r['launches']} (expected {want})")
        if r["launches"] != want:
            fail(f"--tp {tp} rank {r['rank']}: launches {r['launches']}, "
                 f"expected {want}")
    if single:
        log(f"  beside phase 5 on one card: {single['tok_s']:.1f} tok/s, "
            f"{single['step_ms']:.3f} ms a step (the captured step, prefill "
            f"included), peak {single['peak_gib']:.2f} GiB")
    from repro_torch.launch.serve import build_model
    params = build_model(run.cfg, SEED, 4, dev)[0]
    check_against_ar(SimpleNamespace(results=res, prompts=run.prompts,
                                     cfg=run.cfg, params=params), dev)
    del params
    torch.cuda.empty_cache()
    return run


def f32_ar_want(dev):
    """Phase 4's prompts and its AR tokens, fp and int8 (spec == AR there),
    for a run without phase 4."""
    from repro_torch.core.engine import ar_generate
    from repro_torch.launch.serve import build_model, make_prompts
    from repro_torch.models.api import init_cache

    base = f32_base()
    params, _ = build_model(base, 1, 4, dev)
    prompts = make_prompts(base.vocab_size, 4, 1, 16, 129)
    tok, plen = (torch.from_numpy(x).to(dev)
                 for x in padded_batch(prompts, range(4)))
    want = {}
    for dtype in ("", "int8"):
        cfg = dataclasses.replace(base, cache_dtype=dtype)
        want[dtype] = ar_generate(cfg, params, tok, plen,
                                  init_cache(cfg, 4, 512, device=dev), 32,
                                  use_kernel=True)[0].cpu()
    del params
    torch.cuda.empty_cache()
    return want, tok, plen


def tp_cards_main() -> int:
    """``chip_smoke.py --tp-cards``: phase 17 alone on four cards over NCCL
    (the kernels built first): (a) at tp 2 and tp 4, then the launcher at
    ``--tp 4`` and at ``--tp 2 --mesh-shape 2x2``, answers held as (b),
    each followed by phase 18 (c): its planned collectives and step
    arguments against every rank's metered step."""
    from repro_torch.kernels import build
    from repro_torch.runtime import resolve_device

    dev = resolve_device("cuda")
    if torch.cuda.device_count() < 4:
        fail(f"--tp-cards needs 4 cards, {torch.cuda.device_count()} visible")
    t_start = time.perf_counter()
    log(f"phase 1: {smi_line()}; torch {torch.__version__}; "
        f"{torch.cuda.device_count()} device(s)")
    build.build(sorted(p.stem for p in build.CSRC.glob("*.cu")))
    want, tok, plen = f32_ar_want(dev)
    for tp in (2, 4):
        log(f"phase 17 (a): f32, full width, 2 layers, tp {tp} "
            f"[at {time.perf_counter() - t_start:.1f}s]")
        phase_tp_f32(dev, want, tok, plen, 32, 512, tp=tp)
    for tp, shape in ((4, ""), (2, "2x2")):
        log(f"phase 17 (b): bf16 full depth, --tp {tp} {shape} "
            f"[at {time.perf_counter() - t_start:.1f}s]")
        run = phase_tp_serve(dev, tp=tp, mesh_shape=shape)
        log(f"phase 18 (c): the planned collectives and step arguments of "
            f"--tp {tp} {shape} against the metered ranks")
        check_plan_collectives(run, tp, data=int(shape[0]) if shape else 1)
    log(f"chip_smoke --tp-cards: passed in "
        f"{time.perf_counter() - t_start:.1f}s")
    print(smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


# ---------------------------------------------------------------------------
# phase 18: the dry-run planner held against the card
# ---------------------------------------------------------------------------

# (a): the planner's CLI, one process a cell, started together after the
# build (they trace on the host while the card runs phases 2-17)
PLAN_CLI = [("openpangu-7b", "decode_32k"), ("qwen1.5-0.5b", "train_4k"),
            ("qwen1.5-0.5b", "prefill_32k")]
# (b): the card's peak (the arguments' allocation plus the step's growth)
# against the planned peak, by kind (PERF.md gives their reasons)
PLAN_PEAK_TOL = {"decode": 0.01, "train": 0.05}
# (b): the step's own growth of ``memory_allocated`` against the planned
# temp bytes, both kinds: the tracker's direct reading (PERF.md, PR 28:
# within 1.3e-5 on both cells)
PLAN_TEMP_TOL = 1e-3
# the caching allocator's rounding of one tensor, at most: a large block
# is cut from a segment only when more than 1 MiB would be left over
ALLOC_ROUND = 2 * 2 ** 20
PLAN_KEY_BYTES = 8        # the decode cell's key (2,) uint32; no step takes it


def plan_cli_start():
    """Phase 18 (a): ``python -m repro_torch.launch.dryrun --arch A --shape
    S`` for each of ``PLAN_CLI`` on the production 16 x 16 mesh, each in
    its own process with no card visible, all started together; stopped
    at exit if still running (``plan_stop``)."""
    import atexit
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    procs = [((arch, shape), subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape], cwd=str(ROOT), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)) for arch, shape in PLAN_CLI]
    atexit.register(plan_stop, procs)
    return procs


def plan_cli_finish(procs):
    """Wait for phase 18 (a)'s processes; print each record on a line of
    its own and a summary.  A process that fails, or prints no record,
    fails the phase."""
    from repro_torch.launch.dryrun import summary
    for (arch, shape), p in procs:
        try:
            out, err = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            p.kill()
            p.communicate()
            fail(f"dryrun {arch} {shape}: still running after 600 s")
        recs = [ln for ln in out.splitlines() if ln.startswith("{")]
        if p.returncode != 0 or not recs:
            fail(f"dryrun {arch} {shape}: exit {p.returncode}\n"
                 f"{err[-3000:]}")
        print(recs[0], flush=True)
        log(f"  (a) the plan's, not the card's:{summary(json.loads(recs[0]))[1:]}")


def plan_stop(procs):
    for _, p in procs:
        if p.poll() is None:
            p.kill()
            p.communicate()


def planned(cfg, shape, mesh, rank: int = 0) -> dict:
    from repro_torch.launch import dryrun as DR
    rec = DR.plan(cfg, shape, mesh, False, rank=rank)
    mem = rec["mem"]
    log(f"  plan {cfg.name} {shape.name} (B {shape.global_batch}, "
        f"{shape.seq_len} rows) on {rec['mesh']}: program {rec['program']}, "
        f"per device {rec['per_device']}; arguments "
        f"{mem['argument_bytes']} B, temp {mem['temp_bytes']} B, peak "
        f"{mem['peak_bytes']} B, {rec['flops_per_device']:.4g} FLOP, "
        f"collectives {rec['collectives']}; traced in {rec['trace_s']} s "
        f"(counts of the plan, not the card's)")
    return rec


def allocated(dev, make):
    """(make(), the growth of ``memory_allocated`` over it)."""
    gc.collect()
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    m0 = torch.cuda.memory_allocated(dev)
    out = make()
    torch.cuda.synchronize(dev)
    return out, torch.cuda.memory_allocated(dev) - m0


def step_growth(dev, run) -> int:
    """Peak growth of ``memory_allocated`` above what is live before
    ``run()``."""
    gc.collect()
    torch.cuda.synchronize(dev)
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    run()
    torch.cuda.synchronize(dev)
    return torch.cuda.max_memory_allocated(dev) - before


def check_plan_args(label, rec, args, growth):
    """The arguments' allocation against the plan: the plan's bytes up to
    the allocator's rounding of each tensor."""
    from repro_torch.launch.dryrun import leaves
    want, n = rec["mem"]["argument_bytes"], len(leaves(args))
    log(f"  (b) {label}: arguments allocated {growth} B on the card "
        f"({n} tensors), planned {want} B (+{growth - want} B, rounding "
        f"bound {n * ALLOC_ROUND} B)")
    if not want <= growth <= want + n * ALLOC_ROUND:
        fail(f"{label}: the arguments' allocation {growth} B is not the "
             f"plan's {want} B up to rounding")


def check_plan_peak(label, kind, rec, args_growth, step_bytes):
    """The card's peak (the arguments' allocation plus the step's growth)
    against the planned peak, within ``PLAN_PEAK_TOL[kind]``, and the
    step's growth against the planned temp, within ``PLAN_TEMP_TOL``."""
    got = args_growth + step_bytes
    want = rec["mem"]["peak_bytes"]
    temp = rec["mem"]["temp_bytes"]
    log(f"  (b) {label}: peak {got} B on the card, planned {want} B "
        f"(ratio {got / want:.4f}, tolerance {PLAN_PEAK_TOL[kind]}); the "
        f"step's own growth {step_bytes} B against the planned temp "
        f"{temp} B (ratio {step_bytes / max(temp, 1):.4f})")
    if abs(got / want - 1) > PLAN_PEAK_TOL[kind]:
        fail(f"{label}: the card's peak {got} B is not within "
             f"{PLAN_PEAK_TOL[kind]} of the plan's {want} B")
    if abs(step_bytes / max(temp, 1) - 1) > PLAN_TEMP_TOL:
        fail(f"{label}: the step's growth {step_bytes} B is not within "
             f"{PLAN_TEMP_TOL} of the plan's temp {temp} B")


def phase_plan_decode(dev):
    """Phase 18 (b), decode: bf16 openPangu-7B at full width and depth at
    phase 5's shape (B 4, 2048 rows a slot, T 64), planned on a one-device
    mesh; the same arguments allocated on the card; one eager plain-path
    ``spec_step`` after a prefill of phase 5's prompt lengths: its peak
    against the plan's.  The kernel path's peak is logged beside it."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.core.engine import SpecEngine
    from repro_torch.core.tree import medusa_63
    from repro_torch.launch.mesh import make_dev_mesh
    from repro_torch.launch.serve import build_model, make_prompts
    from repro_torch.models.api import init_cache

    cfg = get_config("openpangu-7b")
    rec = planned(cfg, ShapeConfig("phase5", MAX_LEN, SLOTS, "decode"),
                  make_dev_mesh(1, 1))
    if rec["program"] != "single" or not rec["per_device"]:
        fail(f"phase 5's cell on one device planned as {rec['program']}")
    engines = {k: SpecEngine(cfg, medusa_63(), device=dev, graphs=False,
                             use_kernel=k) for k in (False, True)}
    eng = engines[False]

    def make():
        params, mp = build_model(cfg, SEED, 4, dev)
        lengths = torch.zeros(SLOTS, dtype=torch.int32, device=dev)
        return [params, mp, init_cache(cfg, SLOTS, MAX_LEN, device=dev),
                lengths, torch.zeros_like(lengths),
                eng.init_proposer_state(SLOTS, MAX_LEN),
                torch.empty(2, dtype=torch.uint32, device=dev)]

    args, growth = allocated(dev, make)
    check_plan_args("openPangu-7B decode", rec, args, growth)
    params, mp, cache = args[:3]
    del args
    prompts = make_prompts(cfg.vocab_size, SLOTS, SEED, 4, 48)
    tok, plen = (torch.from_numpy(x).to(dev)
                 for x in padded_batch(prompts, range(SLOTS)))
    peaks = {}
    for kernel, e in engines.items():
        cache, lengths, base, state = e.prefill(params, mp, tok, plen, cache)
        peaks[kernel] = step_growth(dev, lambda: e.spec_step(
            params, mp, cache, lengths, base, state))
        del lengths, base, state
    check_plan_peak("openPangu-7B decode, plain path", "decode", rec,
                    growth, peaks[False])
    log(f"  (b) the kernel path's step (K1, K4; reported, not gated): peak "
        f"{growth + peaks[True]} B, its own growth {peaks[True]} B")
    del params, mp, cache, engines, eng
    torch.cuda.empty_cache()


def phase_plan_train(dev):
    """Phase 18 (b), training: qwen1.5-0.5b at phase 11 (ii)'s shape (one
    batch of 8 x 512), planned on a one-device mesh; its parameters (the
    plan's dtype), AdamW state, tokens and targets allocated on the card;
    one ``lm_train_step``: its peak against the plan's."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.mesh import make_dev_mesh
    from repro_torch.models import transformer as TT
    from repro_torch.training import optimizer as O
    from repro_torch.training import steps as ST

    cfg = get_config("qwen1.5-0.5b")
    rec = planned(cfg, ShapeConfig("phase11", 512, 8, "train"),
                  make_dev_mesh(1, 1))

    def make():
        p = TT.init_params(torch.Generator(device=dev).manual_seed(8), cfg,
                           dtype=rec["meta"]["param_dtype"])
        tok = torch.randint(0, cfg.vocab_size, (8, 512), dtype=torch.int32,
                            device=dev)
        return [p, O.adamw_init(p), tok, torch.roll(tok, -1, 1)]

    args, growth = allocated(dev, make)
    check_plan_args("qwen1.5-0.5b LM step", rec, args, growth)
    step = step_growth(dev, lambda: ST.lm_train_step(*args[:2], cfg,
                                                     *args[2:]))
    check_plan_peak("qwen1.5-0.5b LM step", "train", rec, growth, step)
    del args
    torch.cuda.empty_cache()


def check_plan_collectives(run, tp: int, data: int = 1):
    """Phase 18 (c): the planned tp-``tp`` decode cell at the launcher's
    shape (B ``SLOTS`` a data row, ``MAX_LEN`` rows, T 64), each rank's
    program, against that rank's metered step (``--profile-steps``): the
    collectives' count and result bytes by kind, and the bytes of the
    step's arguments on the rank."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.dryrun import KINDS
    from repro_torch.launch.mesh import make_dev_mesh

    shape = ShapeConfig("launcher", MAX_LEN, SLOTS, "decode")
    for r in run.ranks:
        rank = r["rank"] % tp         # a data row's program (rows repeat)
        rec = planned(run.cfg, shape, make_dev_mesh(model=tp), rank=rank)
        prof = r["profile"]
        metered = {}
        for op, n in prof["by_op"].items():
            e = metered.setdefault(KINDS[op], {"count": 0, "bytes": 0,
                                               "bytes_body": 0})
            e["count"] += n
            e["bytes"] += prof["bytes_by_op"][op]
        args = rec["mem"]["program_argument_bytes"] - PLAN_KEY_BYTES
        log(f"  (c) --tp {tp} (data {data}) rank {r['rank']}: planned "
            f"collectives {rec['collectives']}, metered a step {metered}; "
            f"step arguments planned {args} B, on the rank "
            f"{prof['argument_bytes']} B")
        if rec["collectives"] != metered:
            fail(f"--tp {tp} rank {r['rank']}: planned collectives "
                 f"{rec['collectives']} != metered {metered}")
        if args != prof["argument_bytes"]:
            fail(f"--tp {tp} rank {r['rank']}: planned step arguments "
                 f"{args} B != the rank's {prof['argument_bytes']} B")


def median_s(fn, iters: int = 3):
    """(median seconds of ``iters`` synchronised calls after one warm-up,
    the last call's result)."""
    out = fn()
    ts = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)), out

# ---------------------------------------------------------------------------
# phase 8: timing at the main path's shapes
# ---------------------------------------------------------------------------

def bound(nbytes, flops):
    """(bound ms, what bounds it) on the H100's published peaks."""
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_BF16_FLOPS * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def time_verify_stats(dev, cfg, launches, max_err, T=64, suffix=""):
    """K2 at the spec step: hidden [4, T, d] (T 64: the Medusa tree; the
    chain's T 5 with ``suffix`` "@chain") against the full bf16 lm head
    (openPangu-7B: 153,376 columns, 1.26 GB; every launch reads it from
    HBM, as the live step does), or for a tied model (gemma-2b) against
    its [V, d] embedding table read in place through ``embed.T``.  An
    untied head is laid out as the model lays it out (``pitch_lm_head``);
    where that is a pitch past V, the row also gives ``torch.matmul`` on
    the contiguous head (``library_contig_ms``, the unfused step's
    product before the pitch), on the whole [d, ceil8(V)] allocation
    (``library_padded_ms``: the logits' rows 16-byte aligned too, which
    cuBLAS needs for its Hopper kernels) and K2 over the contiguous head
    on the ``tile`` route (``tile_ms``, the earlier design), timed in the
    same call."""
    from repro_torch.kernels.tree_attention import (
        pitch_lm_head, unembed_verify_stats, unembed_verify_stats_plain)

    B, d, V = 4, cfg.d_model, cfg.vocab_size
    N = B * T
    gen = torch.Generator(device=dev).manual_seed(3)
    h = torch.randn((B, T, d), generator=gen, device=dev).to(torch.bfloat16)
    if cfg.tie_embeddings:
        w = (torch.randn((V, d), generator=gen, device=dev)
             * d ** -0.5).to(torch.bfloat16).T
    else:
        w = (torch.randn((d, V), generator=gen, device=dev)
             * d ** -0.5).to(torch.bfloat16)
    contig = w
    w = pitch_lm_head(w)
    pitched = w.stride(0) != contig.stride(0)
    cand = torch.randint(0, V, (B, T), generator=gen, device=dev,
                         dtype=torch.int32)
    tmax = torch.ones((B,), device=dev)
    h2 = h.reshape(N, d)
    _, route = routed(unembed_verify_stats, h, w, cand, tmax)

    def kernel():
        uncounted(unembed_verify_stats, h, w, cand, tmax)

    ms = queued_ms(kernel, 20)
    ev_ms = cuda_ms(kernel, 20)
    rows_t = torch.tensor(TMAX_ROWS, dtype=torch.float32, device=dev)
    tmax_ms = queued_ms(
        lambda: uncounted(unembed_verify_stats, h, w, cand, rows_t), 20)
    plain_ms = queued_ms(
        lambda: unembed_verify_stats_plain(h, w, cand, tmax), 5)
    lib_ms = queued_ms(lambda: torch.matmul(h2, w), 20)
    h_ms = host_ms(kernel, 20)
    extra, old = {}, ""
    if pitched:
        _, old_route = routed(unembed_verify_stats, h, contig, cand, tmax)
        padded = w.as_strided((d, w.stride(0)), (w.stride(0), 1))
        extra = {"library_contig_ms": queued_ms(
                     lambda: torch.matmul(h2, contig), 20),
                 "library_padded_ms": queued_ms(
                     lambda: torch.matmul(h2, padded), 20),
                 "tile_ms": queued_ms(lambda: uncounted(
                     unembed_verify_stats, h, contig, cand, tmax), 20)}
        old = (f"; over the head at row pitch {w.stride(0)}: the contiguous "
               f"head takes the {old_route} route, {extra['tile_ms']:.4f} "
               f"ms, and torch.matmul on it {extra['library_contig_ms']:.4f} "
               f"ms, on the whole padded allocation "
               f"{extra['library_padded_ms']:.4f} ms")
    nbytes = d * V * 2 + N * d * 2 + N * 4 + B * 4 + N * 3 * 4 + N * T * 4
    flops = 2 * N * d * V
    b_ms, b_by = bound(nbytes, flops)
    over = " over the tied [V, d] table" if cfg.tie_embeddings else ""
    log(f"  unembed_verify_stats{over} (N={N} d={d} V={V} bf16, {route} "
        f"route), "
        f"queued back to back: kernel {ms:.4f} ms ({ms / lib_ms:.2f}x the "
        f"library call; {ev_ms:.4f} ms issued as the host goes), plain "
        f"{plain_ms:.4f} ms, torch.matmul of the product only {lib_ms:.4f} "
        f"ms, bound {b_ms:.5f} ms ({b_by}: {nbytes} bytes, {flops} flops); "
        f"the wrapper's host time {h_ms:.4f} ms per call; at per-row tmax "
        f"{TMAX_ROWS} {tmax_ms:.4f} ms{old}")
    return {"name": "unembed_verify_stats"
            + (f"[tied]@{cfg.name}" if cfg.tie_embeddings else "") + suffix,
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/verify_stats.cu",
            "replaces": "src/repro/kernels/tree_attention.py:298",
            "launches": launches, "max_abs_err": max_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib_ms, "host_ms": h_ms, "tmax_ms": tmax_ms,
            **extra}


def time_fused_qkv(dev, cfg, lens, launches, max_err, ps=0, Ts=(64, 1),
                   suffix=""):
    """K3 at the spec step (``Ts[0]``: T 64, or the chain's T 5 with
    ``suffix`` "@chain") and the AR step (T 1, the draft's step too); with
    ``ps`` its paged variant on pools of that page size through a
    shuffled table.
    Each timed launch takes the next of at least 4 weight sets, as many as
    make 100 MB, twice the L2 (openPangu-7B: 4 sets, 201 MB; gemma-2b: 10
    sets of 10.5 MB), so it reads its weights from HBM as a layer of the
    live step does."""
    from repro_torch.kernels.cache_update import (
        fused_qkv_rope_commit, fused_qkv_rope_commit_plain, qkv_blocks,
        qkv_plan, qkv_smem)
    from repro_torch.models.layers import rope_cos_sin

    B, S, d, Hq, Hkv, hd = (4, 2048, cfg.d_model, cfg.num_heads,
                            cfg.num_kv_heads, cfg.resolved_head_dim)
    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(4)
    sets, cats = [], []
    n_sets = max(4, -(-100_000_000 // (d * (Hq + 2 * Hkv) * hd * 2)))
    for _ in range(n_sets):
        p = {n: (torch.randn((d, H, hd), generator=gen, device=dev)
                 * d ** -0.5).to(bf)
             for n, H in (("wq", Hq), ("wk", Hkv), ("wv", Hkv))}
        sets.append(p)
        cats.append(torch.cat([p[n].reshape(d, -1) for n in
                               ("wq", "wk", "wv")], dim=1))
    table = None
    if ps:
        table = shuffled_table(B, S // ps, dev, 4)
        kc = torch.zeros((1 + B * S // ps, ps, Hkv, hd), dtype=bf,
                         device=dev)
    else:
        kc = torch.zeros((B, S, Hkv, hd), dtype=bf, device=dev)
    vc = torch.zeros_like(kc)
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    out = {}
    for T in Ts:
        N = B * T
        x = torch.randn((B, T, d), generator=gen, device=dev).to(bf)
        x2 = x.reshape(N, d)
        cos, sin = rope_cos_sin(lengths[:, None]
                                + torch.arange(T, device=dev), hd,
                                cfg.rope_theta)
        it = iter(range(10 ** 9))
        _, route = routed(fused_qkv_rope_commit, x, sets[0], lengths, kc, vc,
                          cos=cos, sin=sin, table=table)

        def kernel():
            uncounted(fused_qkv_rope_commit, x, sets[next(it) % n_sets],
                      lengths, kc, vc, cos=cos, sin=sin, table=table)

        # the wrapper's host cost is longer than the kernel: the launches
        # are queued so the card runs them back to back; as the host issues
        # them (CUDA events, no queue) beside it
        ms = queued_ms(kernel, 40)
        ev_ms = cuda_ms(kernel, 40)
        h_ms = host_ms(kernel, 40)
        plain_ms = queued_ms(lambda: fused_qkv_rope_commit_plain(
            x, sets[next(it) % n_sets], lengths, kc, vc, cos=cos, sin=sin,
            table=table), 8)
        lib_ms = queued_ms(
            lambda: torch.matmul(x2, cats[next(it) % n_sets]), 40)
        cols = (Hq + 2 * Hkv) * hd
        nbytes = (d * cols * 2 + N * d * 2 + N * cols * 2
                  + 2 * N * Hkv * hd * 2 + 2 * N * hd // 2 * 4 + B * 4
                  + (table.numel() * 4 if ps else 0))
        flops = 2 * N * d * cols
        b_ms, b_by = bound(nbytes, flops)
        out[T] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                      bound_ms=b_ms, bound_by=b_by, host_ms=h_ms)
        where = f" paged ps={ps}" if ps else ""
        plan = qkv_plan(N, d, hd, bf)
        log(f"  fused_qkv_rope_commit{where} {cfg.name} T={T} (B={B} d={d} "
            f"Hq={Hq} Hkv={Hkv} hd={hd} bf16, lengths {lens}, {route} route, "
            f"plan {plan}: {qkv_blocks(N, Hq, Hkv, hd, *plan)} blocks of "
            f"{qkv_smem(hd, plan[1])} bytes of shared memory), "
            f"queued back to back: kernel {ms:.4f} ms ({ms / lib_ms:.2f}x the "
            f"library call; {ev_ms:.4f} ms issued as the host goes), "
            f"plain {plain_ms:.4f} ms, torch.matmul of the product only "
            f"{lib_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}: {nbytes} bytes, "
            f"{flops} flops); the wrapper's host time {h_ms:.4f} ms per call")
    return {"name": "fused_qkv_rope_commit" + ("[paged]" if ps else "")
            + ("" if cfg.name == "openpangu-7b" else f"@{cfg.name}") + suffix,
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/fused_qkv_rope_commit.cu",
            "replaces": ("src/repro/kernels/cache_update.py:203" if ps else
                         "src/repro/kernels/cache_update.py:209"),
            "launches": launches, "max_abs_err": max_err, **out[Ts[0]],
            **{k + f"_t{T}": v for T in Ts[1:] for k, v in out[T].items()
               if k != "bound_by"}}


K1_REPLACES = {"": "src/repro/kernels/tree_attention.py:126",
               "int8": "src/repro/kernels/tree_attention.py:73",
               "paged": "src/repro/kernels/tree_attention.py:105",
               "int8+paged": "src/repro/kernels/tree_attention.py:105"}


# K1's yardstick: the SDPA backend that takes a boolean mask at this shape
# (flash attention takes none)
SDPA_BACKEND = "EFFICIENT_ATTENTION"


def sdpa_pinned(q, k, v, mask):
    """A call of ``scaled_dot_product_attention`` on these inputs, pinned to
    ``SDPA_BACKEND`` with ``torch.nn.attention.sdpa_kernel`` (it raises
    rather than fall back to another backend)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    def call():
        with sdpa_kernel(getattr(SDPBackend, SDPA_BACKEND)):
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                  scale=1.0)
    return call


def time_flash_decode(dev, prompt_lens, max_new, launches, max_err,
                      variant="", ps=64, shape=("", 8, 128, (256, 8)),
                      lens=None, live=None):
    """K1 at the spec (R 256) and AR (R 8) shapes, B 4, Hkv 8, D 128, a
    2048-row bf16 cache (int8 + f32 scales for the int8 variants; pools of
    page size ``ps`` through a shuffled table for the paged ones).  Kernel,
    plain version and yardstick are timed queued behind a spin kernel
    (``queued_ms``): the kernel is shorter than its wrapper's host cost.
    The yardstick is ``scaled_dot_product_attention`` with its backend
    pinned (``sdpa_pinned``) over the rows K1 sweeps, on the dense bf16
    view the cache holds: gathered from the pool for the paged variants,
    dequantized to bf16 for the int8 ones, neither step timed.  ``shape``
    (model, Hkv, D, (spec R, AR R)) gives another model's widths
    (``FAMILY_K1``) or the suffix_prefill's rows; the row's name then
    carries the model, and the second R's keys end in ``_r<R>``.
    ``lens`` (default: the prompts mid-way through generation) are the
    swept lengths.  ``live`` (optional) counts the leading slots that do
    real work (the suffix call's masked slots sweep to capacity): the row
    then also carries ``bound_ms_live``, the bound of those slots alone."""
    from repro_torch.kernels import paging as P
    from repro_torch.kernels.quant import dequantize, quantize_rows
    from repro_torch.kernels.tree_attention import (flash_decode,
                                                    flash_decode_plain)

    model, Hkv, D, r_both = shape
    B, S = 4, 2048
    bf = torch.bfloat16
    quantized, paged = "int8" in variant, "paged" in variant
    gen = torch.Generator(device=dev).manual_seed(0)
    # lengths mid-way through the first group's generation
    if lens is None:
        lens = [n + max_new // 2 for n in prompt_lens]
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    S_run = max(lens)
    n_cols = sum(lens)
    rows = {}
    for R in r_both:
        q = torch.randn((B, Hkv, R, D), generator=gen, device=dev,
                        dtype=bf) * (D ** -0.5)
        k = torch.randn((B, S, Hkv, D), generator=gen, device=dev, dtype=bf)
        v = torch.randn((B, S, Hkv, D), generator=gen, device=dev, dtype=bf)
        mask = (torch.arange(S, device=dev)[None, :]
                < lengths[:, None])[:, None, None, :]
        kw = {}
        if quantized:
            (k, kw["k_scale"]), (v, kw["v_scale"]) = (quantize_rows(k),
                                                      quantize_rows(v))
        if paged:
            table = shuffled_table(B, S // ps, dev, 10)
            k, v = to_pool(k, table, ps, gen), to_pool(v, table, ps, gen)
            kw = {n: to_pool(t, table, ps, gen) for n, t in kw.items()}
            kw["block_tables"] = table
        # the dense bf16 view the cache holds, as the library call needs it
        kd, vd = k, v
        ks, vs = kw.get("k_scale"), kw.get("v_scale")
        if paged:
            kd, vd = P.gather_cache(k, table), P.gather_cache(v, table)
            if quantized:
                ks, vs = P.gather_cache(ks, table), P.gather_cache(vs, table)
        if quantized:
            kd, vd = dequantize(kd, ks, bf), dequantize(vd, vs, bf)
        kt = kd.transpose(1, 2)[:, :, :S_run]
        vt = vd.transpose(1, 2)[:, :, :S_run]
        lib = sdpa_pinned(q, kt, vt, mask[..., :S_run])
        _, route = routed(flash_decode, q, k, v, lengths, **kw)

        def kernel():
            uncounted(flash_decode, q, k, v, lengths, **kw)

        ms = queued_ms(kernel, 100)
        ev_ms = cuda_ms(kernel, 100)
        h_ms = host_ms(kernel, 100)
        plain_ms = queued_ms(lambda: flash_decode_plain(q, k, v, lengths,
                                                        **kw), 20)
        lib_ms = queued_ms(lib, 100)
        def work(lens):
            """(bytes, flops) of K1 over slots of ``lens``: q, the swept
            rows of k and v (+ their f32 scales), the lengths, the table
            entries of the swept rows, the f32 outputs."""
            nb, cols = len(lens), sum(lens)
            row_bytes = Hkv * (D + 4) if quantized else Hkv * D * 2
            return (nb * Hkv * R * D * 2 + 2 * cols * row_bytes + nb * 4
                    + nb * Hkv * R * (D + 2) * 4
                    + (sum(-(-n // ps) for n in lens) * 4 if paged else 0),
                    4 * R * D * Hkv * cols)

        nbytes, flops = work(lens)
        b_ms, b_by = bound(nbytes, flops)
        rows[R] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                       bound_ms=b_ms, bound_by=b_by, host_ms=h_ms,
                       library_backend=SDPA_BACKEND)
        if live is not None:
            l_ms, l_by = bound(*work(lens[:live]))
            rows[R]["bound_ms_live"] = l_ms
            log(f"  flash_decode R={R}: the {live} live slot(s) alone "
                f"(lengths {lens[:live]}) bound {l_ms:.5f} ms ({l_by}); "
                f"{sum(lens[live:])} of the {n_cols} swept columns are the "
                f"masked slots' at capacity")
        what = variant + (f" ps={ps}" if paged else "")
        view = ("the dequantized bf16 view" if quantized else "the rows")
        view += ", gathered from the pool," if paged else ""
        log(f"  flash_decode {what or 'dense'}{' ' + model if model else ''}"
            f" R={R} (B={B} Hkv={Hkv} D={D} "
            f"S={S} bf16, lengths {lens}, {route} route), queued back to "
            f"back: kernel {ms:.4f} ms ({ms / lib_ms:.2f}x the library call; "
            f"{ev_ms:.4f} ms issued as the host goes), plain {plain_ms:.4f} "
            f"ms, sdpa ({SDPA_BACKEND}) over {view} {S_run} rows {lib_ms:.4f} "
            f"ms, bound {b_ms:.5f} ms ({b_by}: {nbytes} bytes, {flops} "
            f"flops); "
            f"the wrapper's host time {h_ms:.4f} ms per call")
    return {"name": "flash_decode" + (f"[{variant}]" if variant else "")
            + (f"@{model}" if model else ""),
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_decode.cu",
            "replaces": K1_REPLACES[variant], "launches": launches,
            "max_abs_err": max_err, **rows[r_both[0]],
            **{k + f"_r{r_both[1]}": v for k, v in rows[r_both[1]].items()
               if k != "bound_by"}}


def time_commit(dev, launches, max_err, paged=False, quantized=False,
                ps=64, nu=34, D=128, T=64, suffix="", H=8, queued=False):
    """The one-launch commit (K4 dense, K5 paged) at the main path's:
    openPangu-7B's 34 units' in-flight k and v [4, 64, 8, 128] bf16 (one
    tensor per unit, as decode leaves them), a best path of K1 5 rows per
    slot (int64, as the verdict holds it), into a 2048-row bf16 cache or
    int8 values with f32 scales, dense or a pool of page size ``ps``
    through a shuffled table.  Device times from the profiler
    (``device_ms``): the kernel; its plain version; the old per-step
    sequence (the two stacks of the in-flight rows, the gathers,
    ``quantize_rows`` under int8, and one rows-given launch of the same
    kernel per leaf: 2, or 4 under int8); one rows-given launch of one
    leaf's pre-gathered rows (what the K4/K5 rows of earlier slices
    timed); the yardstick, ``index_put_`` of the pre-gathered (under int8
    pre-quantized) rows into each leaf; and an empty kernel.  The bound
    counts the accepted rows read once and written once (the scales
    under int8), the lengths, the path and the table entries they use.
    ``nu`` units of [``H``, ``D``] rows (``suffix`` names another model's
    widths in the row's name), from ``T`` in-flight rows a slot (the
    chain step's 5).  ``queued`` times every call by CUDA events queued
    behind a spin kernel (``queued_ms``, the profiler's fallback) without
    trying the profiler first."""
    from repro_torch.kernels import cache_update as CU
    from repro_torch.kernels import paging as P
    from repro_torch.kernels.quant import quantize_rows

    B, K1, S = 4, 5, 2048
    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(11)
    src = {n: tuple(torch.randn((B, T, H, D), generator=gen,
                                device=dev).to(bf) for _ in range(nu))
           for n in "kv"}
    path = torch.randint(0, T, (B, K1), generator=gen, device=dev)
    lengths = torch.tensor([300, 517, 1300, 2000], dtype=torch.int32,
                           device=dev)
    table = shuffled_table(B, S // ps, dev, 12) if paged else None
    lead = (nu, 1 + B * S // ps, ps) if paged else (nu, B, S)
    leaves = {}
    for n in "kv":
        leaves[n] = torch.zeros(lead + (H, D), device=dev,
                                dtype=torch.int8 if quantized else bf)
        if quantized:
            leaves[n + "_scale"] = torch.zeros(lead + (H, 1), device=dev)
    rows_given = CU.commit_rows_paged_stacked if paged else \
        CU.commit_rows_stacked
    extra = (table,) if paged else ()
    # the old sequence's inputs, made once: the rows each leaf takes
    bidx = torch.arange(B, device=dev)[:, None]
    pre = {}
    for n in "kv":
        r = torch.stack(src[n])[:, bidx, path]
        if quantized:
            pre[n], pre[n + "_scale"] = quantize_rows(r)
        else:
            pre[n] = r
    if paged:
        flat = {n: t.view(nu, -1, *t.shape[3:]) for n, t in leaves.items()}
        phys = P.phys_rows(table, lengths, K1, ps).reshape(-1)
        at = (torch.arange(nu, device=dev)[:, None], phys[None, :])
    else:
        flat = leaves
        pos = (lengths.long()[:, None]
               + torch.arange(K1, device=dev)).reshape(-1)
        slot = torch.arange(B, device=dev).repeat_interleave(K1)
        at = (torch.arange(nu, device=dev)[:, None], slot[None, :],
              pos[None, :])
    flat_rows = {n: r.reshape(nu, B * K1, *r.shape[3:])
                 for n, r in pre.items()}

    def kernel():
        uncounted(CU.commit_path_stacked, leaves, src, path, lengths, table)

    def old():
        rows_b = torch.arange(B, device=dev)[:, None]
        for n in "kv":
            r = torch.stack(src[n])[:, rows_b, path]
            rows = dict(zip((n, n + "_scale"), quantize_rows(r))) \
                if quantized else {n: r}
            for leaf, x in rows.items():
                uncounted(rows_given, leaves[leaf], *extra, x, lengths)

    def lib():
        for n, t in flat.items():
            t.index_put_(at, flat_rows[n])

    # each call is shorter than the host's cost of issuing it: device
    # times from the profiler, and the host's rate beside them
    def timed(fn, iters, expect=None):
        if queued:
            return queued_ms(fn, iters)
        return device_ms(fn, iters, expect=expect)

    issue_ms = cuda_ms(kernel, 200)
    ms = timed(kernel, 50, expect=1)
    plain_ms = timed(lambda: CU.commit_path_stacked_plain(
        leaves, src, path, lengths, table), 50)
    old_ms = timed(old, 50)
    given_ms = timed(lambda: uncounted(rows_given, leaves["k"], *extra,
                                       pre["k"], lengths), 50, expect=1)
    lib_ms = timed(lib, 50)
    empty_ms = timed(lambda: torch.cuda._sleep(0), 50, expect=1)
    moved = sum(r.numel() * r.element_size() for r in pre.values())
    read = 2 * nu * B * K1 * H * D * 2
    blocks = len({(b, (n + j) // ps) for b, n in enumerate(lengths.tolist())
                  for j in range(K1)}) if paged else 0
    nbytes = read + moved + B * 4 + path.numel() * 8 + blocks * 4
    b_ms, b_by = bound(nbytes, 0)
    name = ("commit_rows_paged" if paged else "commit_rows") \
        + ("[int8]" if quantized else "")
    log(f"  {name} (commit_path_stacked: nu={nu} B={B} T={T} K1={K1} rows "
        f"[{H}, {D}] bf16 -> {'int8 + f32 scales' if quantized else 'bf16'}"
        f"{f', page size {ps}' if paged else ''}, one launch), device time "
        f"per step: kernel {ms:.4f} ms ({b_ms / ms:.0%} of its bound), plain "
        f"{plain_ms:.4f} ms, the old sequence (stacks, gathers"
        f"{', quantize_rows' if quantized else ''}, "
        f"{len(pre)} rows-given launches) {old_ms:.4f} ms, one rows-given "
        f"launch of one leaf {given_ms:.4f} ms, index_put_ of the "
        f"pre-gathered rows into {len(pre)} leaves {lib_ms:.4f} ms, an "
        f"empty kernel {empty_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}: "
        f"{nbytes} bytes); back to back on CUDA events the wrapper issues "
        f"one call per {issue_ms:.4f} ms")
    return {"name": name + suffix, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/commit_rows.cu",
            "replaces": "src/repro/kernels/cache_update.py:"
                        + {(False, False): "32", (True, False): "86",
                           (False, True): "301",
                           (True, True): "317"}[paged, quantized],
            "launches": launches, "max_abs_err": max_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib_ms, "empty_kernel_ms": empty_ms,
            "old_sequence_ms": old_ms, "rows_given_ms": given_ms,
            "host_issue_ms": issue_ms,
            "timed_by": "queued CUDA events" if queued else "profiler"}


def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {__file__}: run from a checkout of "
             "the repo")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs an "
             "NVIDIA GPU")
    sys.path.insert(0, str(ROOT / "src"))
    if sys.argv[1:] == ["--tp-cards"]:
        return tp_cards_main()
    if sys.argv[1:]:
        fail(f"unknown arguments {sys.argv[1:]} (none, or --tp-cards)")
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import build
    from repro_torch.runtime import resolve_device

    dev = resolve_device("cuda")
    t_start = time.perf_counter()

    def phase(msg: str):
        log(f"{msg} [at {time.perf_counter() - t_start:.1f}s]")
    smi = smi_line()
    phase(f"phase 1: {smi}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; {torch.cuda.device_count()} device(s)")
    sources = sorted(p.stem for p in build.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    logs = build.build(sources)
    for name in sources:
        log(f"  built {build.target(name).name} "
            f"({time.perf_counter() - t0:.1f}s)")
        for line in logs[name].splitlines():
            if "registers" in line or "spill" in line:
                log(f"    {line.strip()}")
    plan_procs = plan_cli_start()

    phase("phase 2: flash_decode kernel (dense, int8, paged, int8 + paged) vs "
        "plain version on the card")
    k1_errs_dense = phase_kernels(dev)
    k1_err = k1_errs_dense["main"]
    k1_errs = phase_kernel_variants(dev)

    phase("phase 3: unembed_verify_stats, fused_qkv_rope_commit (dense and "
        "paged) and commit_rows (dense and paged) kernels vs plain versions "
        "on the card")
    errs = phase_fusion_kernels(dev)
    commit_errs = phase_commit_kernels(dev)
    torch.cuda.empty_cache()

    phase("phase 4: float32, full width, 2 layers: speculative == AR on every "
        "cache layout, fused too; sampled at temperature 0 == AR, and "
        "sampled graph == eager")
    phase_graph_rng(dev)
    f32 = phase_f32(dev)
    phase("phase 4d: the deferred tree-row write, float32, full width, 2 "
        "layers: deferred spec == phase 4's spec and AR on its seven "
        "layouts, graph and eager, K3 never launched")
    phase_f32_deferred(dev, f32)
    phase("phase 4e: the chain proposers (draft model, n-gram), float32, "
          "full width, 2 layers: speculative == AR on four cache layouts, "
          "fused too, greedy and sampled at temperature 0, deferred, and a "
          "self-draft that accepts every proposal")
    phase_chain_f32(dev, f32)
    phase("phase 13: the continuous-batching server (SpecServer), float32, "
          "full width, 2 layers: every answer == AR on each of its runs "
          "(dense batched and serial, int8, paged tight, prefix cache + "
          "CoW, chunked prefill, preemption, adaptive gamma, fusion, "
          "deferred, FamilySpecServer, sampled with temperature-0 "
          "requests, a recovered failure)")
    phase_serving_f32(dev, f32)
    tp_in = (f32["want"], f32["tok"].cpu(), f32["plen"].cpu(),
             f32["max_new"], f32["max_len"])
    del f32
    torch.cuda.empty_cache()
    phase(f"phase 17 (a): tensor parallelism, float32, full width, 2 "
          f"layers, tp {TP}: TPSpecEngine == phase 4's spec and AR on four "
          f"cache layouts, Medusa and n-gram, greedy and sampled at "
          f"temperature 0, launches exact on every rank")
    tp_counts = phase_tp_f32(dev, *tp_in)
    torch.cuda.empty_cache()
    phase("phase 4b: the sampled distribution gate (tiny vocabulary, 1024 "
        "rows): the tree walk and the draft's chain walk, unfused and "
        "fused")
    phase_tvd(dev)
    torch.cuda.empty_cache()
    phase("phase 4c: the dense family (granite-8b, qwen1.5-0.5b, qwen1.5-4b, "
        "gemma-2b), float32, full width, 2 layers: speculative == AR, "
        "unfused and fused, every layout for qwen1.5-0.5b and gemma-2b")
    phase_family_f32(dev)
    torch.cuda.empty_cache()
    phase("phase 4m: the MoE and VLM families (granite-moe-1b-a400m, "
          "phi3.5-moe-42b-a6.6b, internvl2-26b with its 256-row prefix), "
          "float32, full width, 2 layers, no-drop capacity: speculative == "
          "AR, unfused and fused, int8 + paged for granite-moe")
    phase_moe_vlm_f32(dev)
    torch.cuda.empty_cache()
    phase("phase 4s: the SSM and hybrid families (mamba2-2.7b at 2 layers, "
          "jamba-1.5-large-398b cut to one 4-position unit with "
          f"{JAMBA_F32_EXPERTS} of its 16 experts, no drop), float32, full "
          "width, chain mode: speculative == AR for Medusa on the chain and "
          "n-gram, unfused and fused, dense and paged (jamba int8 and int8 + "
          "paged too), graph == eager")
    phase_ssm_f32(dev)
    torch.cuda.empty_cache()
    phase("phase 4w: the encoder-decoder (whisper-tiny, 4 + 4 layers, 1500 "
          "frames a request), float32, full width and depth: speculative "
          "== AR on four cache layouts, Medusa unfused, fused and sampled "
          "at temperature 0, n-gram, graph == eager")
    phase_whisper_f32(dev)
    torch.cuda.empty_cache()

    phase("phase 5: the launcher on bf16 openPangu-7B, full width and depth, "
        "through the captured step")
    torch.cuda.reset_peak_memory_stats()
    srv, _ = phase_serve(dev)
    steps5 = sum(srv.results[g]["steps"] for g in range(0, REQUESTS, SLOTS))
    single = {"tok_s": srv.tokens / srv.seconds,
              "step_ms": srv.seconds * 1e3 / steps5,
              "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}

    phase("phase 6: the launcher with --verify-fusion on the same weights")
    fsrv, fused = phase_serve_fused(dev, srv)
    phase("phase 6b: the same configuration through the eager step "
        "(graphs=False)")
    phase_serve_eager(dev, fsrv)

    phase("phase 7: the launcher on the same weights under the paged and int8 "
        "cache layouts")
    runs = phase_serve_layouts(dev, srv, fsrv)
    layout_counts = {label: counts for label, (_, counts) in runs.items()}
    phase("phase 10: the launcher with --deferred on the same weights: "
        "unfused, --verify-fusion and --cache-dtype int8")
    phase_serve_deferred(dev, srv, fsrv, runs["int8"][0])
    del runs
    torch.cuda.empty_cache()
    phase("phase 7s: the launcher on the same weights with --accept sample "
        f"(temperature 0.7 and {LOW_TEMPERATURE}, unfused and fused; "
        "temperature 0)")
    phase_serve_sampled(dev, srv, fsrv)
    phase("phase 12: the launcher with --proposer draft (unfused, fused, "
          "paged fused, int8) and --proposer ngram on the same weights")
    chain = phase_serve_chain(dev, srv)
    torch.cuda.empty_cache()
    phase("phase 13b: the launcher's continuous-batching server on the same "
          "weights: 16 requests, 4 slots, max_new 16..64; unfused, "
          "--verify-fusion, and paged with --prefix-cache --preemption")
    serving = phase_serving_full(dev, srv)
    # the suffix calls' count, not the server, which holds phase 5's
    # weights (~18 GB) and its pool
    suffix_calls = serving[PAGED_13B].server.timing["suffix_calls"]
    del serving
    torch.cuda.empty_cache()
    prompt_lens = [len(p) for p in srv.prompts[:4]]
    params = srv.params
    del srv, fsrv
    torch.cuda.empty_cache()
    phase("phase 11: training (ii) at full width: self-distillation on bf16 "
        "openPangu-7B, its float32 Medusa heads, qwen1.5-0.5b LM steps")
    phase_train_full(dev, params)
    del params
    torch.cuda.empty_cache()
    phase(f"phase 17 (b): the launcher at --tp {TP} on bf16 openPangu-7B, "
          f"full width and depth: answers held to single-device AR")
    tp_run = phase_tp_serve(dev, single)
    torch.cuda.empty_cache()
    phase("phase 18: the dry-run planner: (a) its CLI on three production "
          "cells, (b) the plan against the card's allocation and peak "
          "(openPangu-7B decode at phase 5's shape, a qwen1.5-0.5b LM "
          "step), (c) the planned tp-2 collectives against phase 17 (b)'s")
    phase_plan_decode(dev)
    phase_plan_train(dev)
    check_plan_collectives(tp_run, TP)
    plan_cli_finish(plan_procs)
    phase("phase 9: the launcher on the dense family at full width and depth "
        "in bf16, unfused and --verify-fusion")
    family = phase_family_serve(dev)
    torch.cuda.empty_cache()
    phase("phase 14: the MoE and VLM families in bf16 at full width: "
          "granite-moe-1b-a400m through the launcher (--static and the "
          "server, unfused and fused, no drop and 1.25), internvl2-26b "
          "through generate with its prefix and the launcher, "
          f"phi3.5-moe-42b-a6.6b at {PHI_LAYERS} layers through build_engine")
    moe_vlm = phase_moe_vlm_serve(dev)
    torch.cuda.empty_cache()
    phase("phase 15: the SSM and hybrid families in bf16 at full width: "
          "mamba2-2.7b at full depth through the launcher (--static: Medusa "
          "on the chain unfused and fused, n-gram; the server unfused and "
          "fused), jamba-1.5-large-398b cut to one 4-position unit at no "
          "drop through build_engine (dense unfused and fused, paged fused, "
          "int8) and the server (unfused, fused, chunked)")
    ssm = phase_ssm_serve(dev)
    torch.cuda.empty_cache()
    phase("phase 16: the encoder-decoder in bf16 at full width and depth: "
          "whisper-tiny through the launcher with 1500 frames a request "
          "(--static and the server, unfused and fused, dense and paged "
          "with preemption)")
    whisper = phase_whisper_serve(dev)
    torch.cuda.empty_cache()
    phase("phase 11: training (iv) granite-moe-1b-a400m LM steps at full "
          "width and depth")
    phase_train_moe(dev)
    torch.cuda.empty_cache()
    phase("phase 11: training (v) mamba2-2.7b LM steps at full width and "
          "depth")
    phase_train_ssm(dev)
    torch.cuda.empty_cache()
    phase("phase 11: training (vi) whisper-tiny LM steps with frames: card "
          "against CPU (reduced float32), then full width and depth")
    phase_train_whisper(dev)
    torch.cuda.empty_cache()
    phase("phase 11: training (i) card against CPU, reduced float32 "
        "openPangu-7B")
    phase_train_parity(dev)
    phase("phase 11: training (iii) the trained stack and Fig 3/4 on reduced "
        "openPangu-7B")
    phase_trained_stack(dev)

    phase("phase 8: timing at the main path's shapes")
    cfg = get_config("openpangu-7b")
    mid = [n + MAX_NEW // 2 for n in prompt_lens]
    paged_fused = layout_counts["paged fused"]
    rows = [time_flash_decode(dev, prompt_lens, MAX_NEW, fused["K1"],
                              k1_err),
            time_flash_decode(dev, prompt_lens, MAX_NEW,
                              layout_counts["int8"]["K1"], k1_errs["int8"],
                              variant="int8"),
            time_flash_decode(dev, prompt_lens, MAX_NEW, paged_fused["K1"],
                              k1_errs["paged"], variant="paged"),
            time_flash_decode(dev, prompt_lens, MAX_NEW,
                              layout_counts["int8 paged"]["K1"],
                              k1_errs["int8+paged"], variant="int8+paged",
                              ps=16),
            time_verify_stats(dev, cfg, fused["K2"], errs["K2"]),
            time_fused_qkv(dev, cfg, mid, fused["K3"], errs["K3"]),
            time_fused_qkv(dev, cfg, mid, paged_fused["K3"],
                           errs["K3-paged"], ps=64),
            time_commit(dev, fused["K4"], commit_errs["dense"]),
            time_commit(dev, paged_fused["K5"], commit_errs["paged"],
                        paged=True),
            time_commit(dev, layout_counts["int8"]["K4"],
                        commit_errs["int8"], quantized=True),
            time_commit(dev, layout_counts["int8 paged"]["K5"],
                        commit_errs["int8+paged"], paged=True,
                        quantized=True, ps=16)]
    # the dense family's new shapes: K1 at gemma-2b's and qwen1.5-0.5b's,
    # K2 over gemma-2b's tied table, K3 at its head_dim 256
    for shape in FAMILY_K1:
        rows.append(time_flash_decode(dev, prompt_lens, MAX_NEW,
                                      family[shape[0]]["K1"],
                                      k1_errs_dense[shape[0]], shape=shape))
    gemma = get_config("gemma-2b")
    rows += [time_verify_stats(dev, gemma, family["gemma-2b"]["K2"],
                               errs["K2 table"]),
             time_fused_qkv(dev, gemma, mid, family["gemma-2b"]["K3"],
                            errs["K3 hd256"])]
    # the chain proposers' verify step: K1 at R 24 (the draft's T=1 at R 8
    # beside it), K2 at N 20, K3 at M 20 (and the draft's M 4)
    chain_k1 = ("chain", 8, 128, (CHAIN_R, 8))
    rows += [time_flash_decode(dev, prompt_lens, MAX_NEW,
                               chain["draft fused"]["K1"],
                               k1_errs_dense["chain"], shape=chain_k1),
             time_flash_decode(dev, prompt_lens, MAX_NEW,
                               chain["draft int8"]["K1"],
                               k1_errs["chain int8"], variant="int8",
                               shape=chain_k1),
             time_flash_decode(dev, prompt_lens, MAX_NEW,
                               chain["draft paged fused"]["K1"],
                               k1_errs["chain paged"], variant="paged",
                               shape=chain_k1),
             time_verify_stats(dev, cfg, chain["draft fused"]["K2"],
                               errs["K2 chain"], T=CHAIN_T, suffix="@chain"),
             time_fused_qkv(dev, cfg, mid, chain["draft fused"]["K3"],
                            errs["K3 chain"], Ts=(CHAIN_T, 1),
                            suffix="@chain")]
    # the server's suffix_prefill (13b's paged prefix admissions): K1 at
    # R 512 / 2048 (T 128 / 512) with one slot continuing from 192 cached
    # rows and three outside the mask at capacity, K3 at M 512 / 2048
    sfx = cfg.num_layers * suffix_calls
    rows += [time_flash_decode(dev, prompt_lens, MAX_NEW, sfx,
                               k1_errs_dense["suffix128"],
                               shape=("suffix", 8, 128,
                                      tuple(4 * T for T in SUFFIX_T)),
                               lens=[192, 2048, 2048, 2048], live=1),
             time_fused_qkv(dev, cfg, [192, 2048, 2048, 2048], sfx,
                            errs["K3 suffix128"], Ts=SUFFIX_T,
                            suffix="@suffix")]
    # the MoE and VLM families' shapes: K1 at their folds, K2 over their
    # heads (granite-moe's and internvl2's pitched),
    # K3 at their widths, the commit over their units
    for shape in MOE_VLM_K1:
        rows.append(time_flash_decode(dev, prompt_lens, MAX_NEW,
                                      moe_vlm[shape[0]]["K1"],
                                      k1_errs_dense[shape[0]], shape=shape))
    for arch in MOE_VLM:
        mcfg = get_config(arch)
        rows.append(time_verify_stats(dev, mcfg, moe_vlm[arch]["K2"],
                                      errs[f"K2 {arch}"],
                                      suffix=f"@{arch}"))
        if arch != "phi3.5-moe-42b-a6.6b":
            rows.append(time_fused_qkv(dev, mcfg, mid, moe_vlm[arch]["K3"],
                                       errs[f"K3 {arch}"]))
    for arch, nu, D in (("granite-moe-1b-a400m", 24, 64),
                        ("internvl2-26b", 48, 128)):
        rows.append(time_commit(dev, moe_vlm[arch]["K4"],
                                commit_errs[arch], nu=nu, D=D,
                                suffix=f"@{arch}"))
    # the SSM and hybrid families' chain step (phase 15's fused static
    # runs): K2 over mamba2-2.7b's head (its only kernel) and jamba's; K1
    # at jamba's fold (R 40, the AR step's R 8), K3 at its widths (M 20
    # and M 4), the commit of its one unit of [8, 128] from T 5 rows
    for arch in SSM_HYBRID:
        rows.append(time_verify_stats(dev, get_config(arch), ssm[arch]["K2"],
                                      errs[f"K2 {arch}"], T=CHAIN_T,
                                      suffix=f"@{arch}"))
    jamba = "jamba-1.5-large-398b"
    rows += [time_flash_decode(dev, prompt_lens, MAX_NEW, ssm[jamba]["K1"],
                               k1_errs_dense[jamba], shape=JAMBA_K1[0]),
             time_fused_qkv(dev, get_config(jamba), mid, ssm[jamba]["K3"],
                            errs[f"K3 {jamba}"], Ts=(CHAIN_T, 1)),
             time_commit(dev, ssm[jamba]["K4"], commit_errs[jamba], nu=1,
                         D=128, T=CHAIN_T, suffix=f"@{jamba}")]
    # the encoder-decoder's tree step (phase 16's fused static runs): K1 at
    # R 64 (the AR step's R 8 beside it) over 6 kv heads of 64, K2 over
    # its [384, 51865] head, pitched, the commit over its 4
    # decoder units of [6, 64]
    wname, wH, wD, wrows = WHISPER_K1[0]
    rows += [time_flash_decode(dev, prompt_lens, MAX_NEW, whisper["K1"],
                               k1_errs_dense[WHISPER],
                               shape=(wname, wH, wD, wrows[:2])),
             time_verify_stats(dev, get_config(WHISPER), whisper["K2"],
                               errs[f"K2 {WHISPER}"], suffix=f"@{WHISPER}"),
             time_commit(dev, whisper["K4"], commit_errs[WHISPER], nu=4,
                         D=64, H=6, suffix=f"@{WHISPER}")]
    # tensor parallelism's kernels at a tp-2 rank's 4 kv heads: the dense
    # rows' launches are phase 17 (b)'s rank 0's, the other layouts' phase
    # 17 (a)'s
    tp_name = TP_K1[0][0]
    tp_dense = tp_run.ranks[0]["launches"]
    rows.append(time_flash_decode(dev, prompt_lens, MAX_NEW, tp_dense["K1"],
                                  k1_errs_dense[tp_name], shape=TP_K1[0]))
    for variant, ps in (("int8", 64), ("paged", 64), ("int8+paged", 16)):
        rows.append(time_flash_decode(
            dev, prompt_lens, MAX_NEW, tp_counts[variant]["K1"],
            k1_errs[f"{tp_name} {variant}"], variant=variant, ps=ps,
            shape=TP_K1[0]))
    # the commit by queued CUDA events: this late in the run the profiler
    # has recorded none of these kernels, three sessions a reading
    tp_commit = dict(H=4, suffix="@tp2", queued=True)
    rows += [time_commit(dev, tp_dense["K4"], commit_errs["tp dense"],
                         **tp_commit),
             time_commit(dev, tp_counts["paged"]["K5"],
                         commit_errs["tp paged"], paged=True, **tp_commit),
             time_commit(dev, tp_counts["int8"]["K4"], commit_errs["tp int8"],
                         quantized=True, **tp_commit),
             time_commit(dev, tp_counts["int8+paged"]["K5"],
                         commit_errs["tp int8+paged"], paged=True,
                         quantized=True, ps=16, **tp_commit)]
    log(f"chip_smoke: all phases passed in "
        f"{time.perf_counter() - t_start:.1f}s")
    print(smi_line(), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
