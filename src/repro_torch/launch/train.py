"""Training launcher for the port: LM training or Medusa-head training
with checkpoint/restart (counterpart of ``repro.launch.train``).

  PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu \\
      --mode heads --steps 200 --ckpt-dir /tmp/ck --resume

The reference's flags, plus ``--device`` (the card by default; ``cpu``
runs the same steps in plain PyTorch there).  Without ``--reduced`` the
architecture is at full width, where ``--mode heads`` trains K float32
heads over the backbone in its bf16 ``dtype``.  The backbone's weights
and the heads' are random, drawn from seeds 0 and 1; batches come from
the synthetic chat corpus (``training.data``), in the reference's order.
``--mode lm`` trains the whole model in float32 master weights, each
product in the config's ``dtype``.  Every ``--ckpt-every`` steps the
parameters and optimizer state are saved by the async checkpointer (the
newest three kept); ``--resume`` restarts from the newest checkpoint in
``--ckpt-dir`` (default: ``repro_torch_train_ckpt`` under the system's
temporary directory).
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from repro_torch.configs.registry import ALL_ARCHS, get_config
from repro_torch.core import medusa as M
from repro_torch.models.api import get_model
from repro_torch.runtime import resolve_device
from repro_torch.training import checkpoint as C
from repro_torch.training import data as D
from repro_torch.training import optimizer as O
from repro_torch.training import steps as ST


def main(argv=None) -> dict:
    """Run the launcher on ``argv``.  Returns {"losses": [per step],
    "start": the step it started from, "state": {"params", "opt"}}."""
    ap = argparse.ArgumentParser(prog="repro_torch.launch.train")
    ap.add_argument("--arch", default="openpangu-7b", choices=ALL_ARCHS)
    ap.add_argument("--mode", default="heads", choices=["lm", "heads"])
    ap.add_argument("--reduced", action="store_true",
                    help="the reference's reduced CPU-test config")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--heads", type=int, default=3)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=args.reduced)
    model = get_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    corpus = D.synthetic_chat(D.SyntheticChatConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq + 1,
        n_samples=max(args.batch * 8, 128)))
    it = D.batches(corpus, args.batch, seed=1)
    ck = C.AsyncCheckpointer(args.ckpt_dir, keep=3)

    if args.mode == "lm":
        params = model.init_params(gen, cfg)
        state = {"params": params, "opt": O.adamw_init(params)}

        def step_fn(p, o, b):
            return ST.lm_train_step(p, o, cfg, b[:, :-1], b[:, 1:],
                                    lr=args.lr)
    else:
        params = model.init_params(gen, cfg, dtype=cfg.dtype)
        mp = M.init_medusa(torch.Generator(device=dev).manual_seed(1), cfg,
                           args.heads, base_lm_head=params.get("lm_head"))
        state = {"params": mp, "opt": O.adamw_init(mp)}
        pad = D.special_id(cfg.vocab_size, D.PAD)

        def step_fn(p, o, b):
            return ST.medusa_train_step(p, o, params, cfg, b, args.heads,
                                        lr=args.lr, pad_id=pad)

    start = 0
    if args.resume:
        latest = C.restore_latest(args.ckpt_dir, state)
        if latest:
            start, state, _ = latest
            print(f"[resume] step {start}")

    p, o = state["params"], state["opt"]
    losses = []
    t0 = time.time()
    for i in range(start, args.steps):
        b = torch.from_numpy(next(it)).to(dev)
        p, o, met = step_fn(p, o, b)
        losses.append(float(met["loss"]))
        if i % 25 == 0 or i == args.steps - 1:
            extra = ""
            if "head_acc" in met:
                acc = [round(a, 3) for a in met["head_acc"].tolist()]
                extra = f" top1={acc}"
            print(f"step {i:5d} loss {losses[-1]:.4f}{extra} "
                  f"({(time.time() - t0):.0f}s)", flush=True)
        if (i + 1) % args.ckpt_every == 0:
            ck.save(i + 1, {"params": p, "opt": o})
    ck.wait()
    print("done")
    return {"losses": losses, "start": start,
            "state": {"params": p, "opt": o}}


if __name__ == "__main__":
    main()
