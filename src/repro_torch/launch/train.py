"""End-to-end trainer on one device, with checkpoint/restart: resume
is automatic if the checkpoint dir has state.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b-smoke \
        --steps 50 --batch 8 --seq 64 --ckpt-dir ckpt --ckpt-every 20

The reference's flags (``repro/launch/train.py``), plus ``--device``
(default ``cuda:0``, an error without a card; ``cpu`` runs the host path).
Parameters are made from ``--seed``; batch ``i`` is
``SyntheticLM(vocab, seq, seed).batch(batch, seed=i)``, so a resumed run
sees the batches the uninterrupted one would.  Each step is
``value_and_grad(Model.loss_fn)`` (attention through the flash kernel on a
card, its backward a plain recompute) and the AdamW update; the loss is read
back after every step, so a step's logged time ends in a synchronise.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, List, Optional

import torch

from ..ckpt.checkpoint import AsyncCheckpointer, latest_step, restore
from ..configs import get_config
from ..data.synthetic import SyntheticLM
from ..device import resolve_device
from ..models.model import build_model
from ..train.optimizer import AdamW
from ..train.train_step import value_and_grad


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b-smoke")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default cuda:0; 'cpu' for the host path")
    return ap


def run(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    """Train as ``main`` does and return what the run did: ``start`` (the
    first step run), per-step ``losses`` and ``step_s`` (host clock, each
    ending in a synchronise), ``tokens_per_step``, ``n_params``, and the
    final ``params`` and ``opt_state``."""
    args = _parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    model = build_model(cfg)
    opt = AdamW(lr=args.lr)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=args.seq, seed=args.seed)

    params = model.init_params(
        torch.Generator(device=device).manual_seed(args.seed), device)
    state = opt.init(params)
    start = 0
    ckpt = AsyncCheckpointer(args.ckpt_dir) if args.ckpt_dir else None
    if ckpt and latest_step(args.ckpt_dir) is not None:
        (params, state), manifest = restore(args.ckpt_dir, (params, state),
                                            device=device)
        start = manifest["step"] + 1
        print(f"resumed from step {manifest['step']}")

    def step_fn(p, s, batch):
        loss, grads = value_and_grad(model.loss_fn, p, batch)
        p2, s2 = opt.update(grads, s, p)
        return loss, p2, s2

    print(f"training {cfg.name}: {model.n_params():,} params "
          f"({model.n_active_params():,} active), on {device}")
    losses: List[float] = []
    step_s: List[float] = []
    t0 = time.time()
    tokens = 0
    for i in range(start, args.steps):
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in data.batch(args.batch, seed=i).items()}
        ts = time.perf_counter()
        loss, params, state = step_fn(params, state, batch)
        losses.append(float(loss))               # waits for the step
        step_s.append(time.perf_counter() - ts)
        tokens += args.batch * args.seq
        if i % args.log_every == 0 or i == args.steps - 1:
            dt = time.time() - t0
            print(f"step {i:5d} loss {losses[-1]:7.4f} "
                  f"tok/s {tokens/max(dt,1e-9):9.0f} "
                  f"step_ms {step_s[-1] * 1e3:.3f}")
        if ckpt and (i + 1) % args.ckpt_every == 0:
            ckpt.save(i, (params, state))
    if ckpt:
        ckpt.save(args.steps - 1, (params, state))
        ckpt.wait()
    final = f"{losses[-1]:.4f}" if losses else "none (no step left to run)"
    print(f"done in {time.time()-t0:.1f}s; final loss {final}")
    return {"arch": cfg.name, "n_params": model.n_params(), "start": start,
            "steps": args.steps, "losses": losses, "step_s": step_s,
            "tokens_per_step": args.batch * args.seq, "params": params,
            "opt_state": state}


def main(argv: Optional[List[str]] = None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
