"""Where the port's trained stack and the reference's part: the backbone's
initial weights, or the training.

  PYTHONPATH=src python tests/trained_stack_study.py

Runs on the CPU (a few minutes).  Trains the reference's
``benchmarks/common.py::trained_stack`` (seed 0) and reads, with the
reference's engine on the cartesian (4, 2, 1) tree, 32 new tokens: the
mean accepted length on the Fig 3/4 bench's first context (the first four
64-token corpus rows, as ``bench_fig34_speedup.py`` reads it), on 16
held-out 16-token prompts in one batch, and on each of those prompts
alone, for the trained heads and the untrained ones (the Medusa init:
copies of the lm head).  Then runs ``chip_smoke.phase_trained_stack``
(the port's counterpart, which prints the same readings) twice: from the
reference's initial backbone carried across with ``bridge.to_torch``, and
from the port's own draw from seed 0.  Where the first port run reads as
the reference, the gap between the reference and the second port run is
the initial weights'.  Not collected by pytest: it takes minutes.
"""
from __future__ import annotations

import os
import pathlib
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke  # noqa: E402
from benchmarks.common import trained_stack  # noqa: E402
from repro.core import medusa as JM  # noqa: E402
from repro.core.engine import ar_generate, build_engine  # noqa: E402
from repro.core.tree import cartesian_tree  # noqa: E402
from repro.distributed.sharding import split_params  # noqa: E402
from repro.models.api import init_cache  # noqa: E402
from repro_torch import bridge  # noqa: E402

B, P, NEW = chip_smoke.FIG34_B, chip_smoke.FIG34_PROMPT, chip_smoke.FIG34_NEW


def reference_readings():
    cfg, model, params, mp, corpus, head_acc = trained_stack()
    untrained, _ = split_params(JM.init_medusa(
        jax.random.PRNGKey(2), cfg, 3, base_lm_head=params.get("lm_head")))
    tb = cartesian_tree((4, 2, 1))
    eng = build_engine(cfg, tb=tb)
    gen = jax.jit(lambda p, m, t, n, c: eng.generate(p, m, t, n, c, NEW))
    ar_fn = jax.jit(lambda p, t, n, c: ar_generate(cfg, p, t, n, c, NEW))
    S = P + 48 + NEW + tb.T + 8

    def accept(m, tok):
        n = jnp.full((tok.shape[0],), tok.shape[1], jnp.int32)
        out, n_out, stats = gen(params, m, tok, n,
                                init_cache(cfg, tok.shape[0], S))
        ar = ar_fn(params, tok, n, init_cache(cfg, tok.shape[0], S))[0]
        if not np.array_equal(np.asarray(out), np.asarray(ar)):
            raise SystemExit("reference: spec != AR")
        return float(jnp.mean(n_out)) / max(int(stats.steps), 1)

    bench = jnp.asarray(corpus[:B, :P + 48].astype(np.int32))
    held = jnp.asarray(np.ascontiguousarray(corpus[256:272, :P]), jnp.int32)
    print(f"reference (JAX, CPU): head top-1 "
          f"{[round(float(a), 3) for a in head_acc]}")
    for name, m in (("trained", mp), ("untrained", untrained)):
        per_row = [accept(m, held[b:b + 1]) for b in range(16)]
        print(f"  {name} heads: accepted {accept(m, bench):.3f} "
              f"tokens/step on the bench's first context; held-out batch "
              f"{accept(m, held):.3f}; each row alone: mean "
              f"{np.mean(per_row):.3f}, per row "
              f"{[round(a, 3) for a in per_row]}")
    return model, cfg


def main() -> int:
    torch.set_num_threads(min(8, os.cpu_count() or 1))
    torch.cuda.synchronize = lambda *a, **k: None   # timing helpers' syncs
    model, cfg = reference_readings()
    init, _ = split_params(model.init_params(jax.random.PRNGKey(0), cfg))
    cpu = torch.device("cpu")
    print("port (PyTorch, CPU), from the reference's initial backbone:")
    chip_smoke.phase_trained_stack(
        cpu, params=bridge.to_torch(jax.tree.map(np.asarray, init), cpu))
    print("port (PyTorch, CPU), from its own draw from seed 0:")
    chip_smoke.phase_trained_stack(cpu)
    return 0


if __name__ == "__main__":
    sys.exit(main())
