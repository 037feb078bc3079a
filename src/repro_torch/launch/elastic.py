"""Elastic restart: train -> checkpoint -> 'fail' -> restore onto a new mesh
and keep training (the reference's ``repro/launch/elastic.py``: any pod
count can pick up the run).

    PYTHONPATH=src python -m repro_torch.launch.elastic --arch llama3.2-1b-smoke

The reference's flags, plus ``--device`` (default ``cuda:0``, an error
without a card; ``cpu`` runs the host path).  Phase 1 runs ``--steps``
steps of ``value_and_grad(Model.loss_fn)`` and ``AdamW(lr=1e-3)`` on
``SyntheticLM(vocab, seq_len=32, seed=0).batch(4, seed=i)`` from parameters
seeded 0, and saves ``(params, opt_state)`` in the reference's checkpoint
format (a temporary directory, removed at the end).  Phase 2 is a new
start: fresh ``Model`` and ``AdamW`` objects and ``make_host_mesh(model=1)``;
it restores onto that mesh's first device, checks the restored tree
against the saved one bit for bit, and trains 5 more steps on batches
``steps .. steps + 4``.  A last line ``elastic: {...}`` holds every loss,
the save and restore seconds and bytes, and the flash kernel's launches in
each phase.  There is one device per mesh here, so restoring
is placing; the reference reshards onto its mesh with its sharding rules.
"""
from __future__ import annotations

import argparse
import json
import math
import shutil
import tempfile
import time
from typing import Any, Dict, List, Optional

import torch

from .. import tree as tree_util
from ..ckpt.checkpoint import restore, save
from ..configs import get_config
from ..data.synthetic import SyntheticLM
from ..device import resolve_device
from ..kernels import flash_attention as flash
from ..models.model import Model
from ..train.optimizer import AdamW
from ..train.train_step import value_and_grad
from .mesh import make_host_mesh

PHASE2_STEPS = 5


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b-smoke")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="default cuda:0; 'cpu' for the host path")
    return ap


def _train(model: Model, opt: AdamW, data: SyntheticLM, params, state,
           steps: range, device: torch.device, losses: List[float]):
    for i in steps:
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in data.batch(4, seed=i).items()}
        loss, grads = value_and_grad(model.loss_fn, params, batch)
        params, state = opt.update(grads, state, params)
        losses.append(float(loss))                 # waits for the step
    return params, state


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    """Both phases as ``main`` runs them; returns the losses of each phase,
    the checkpoint's bytes, the save and restore seconds, whether the
    restored tree is bit-equal to the saved one, the mesh, and phase 2's
    final ``params`` and ``opt_state``."""
    args = _parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    model = Model(cfg)
    opt = AdamW(lr=1e-3)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=32, seed=0)
    params = model.init_params(
        torch.Generator(device=device).manual_seed(0), device)
    state = opt.init(params)
    ckdir = tempfile.mkdtemp(prefix="elastic_ck_")
    losses1: List[float] = []
    losses2: List[float] = []
    launches = [flash.launches]
    try:
        # phase 1: "pod A" trains and checkpoints
        params, state = _train(model, opt, data, params, state,
                               range(args.steps), device, losses1)
        launches.append(flash.launches)
        saved = (params, state)
        nbytes = sum(t.numel() * t.element_size()
                     for t in tree_util.leaves(saved))
        _sync(device)
        t0 = time.perf_counter()
        save(ckdir, args.steps - 1, saved)
        save_s = time.perf_counter() - t0
        print(f"phase 1 done (loss {losses1[-1]:.4f}); checkpoint written "
              f"({nbytes / 1e9:.3f} GB in {save_s:.3f} s)")

        # phase 2: simulated failure -> a new start builds a new mesh and
        # restores onto it
        model2 = Model(cfg)
        opt2 = AdamW(lr=1e-3)
        mesh = make_host_mesh(model=1, device=device)
        aparams = model2.abstract_params()
        like = (aparams, opt2.abstract_state(aparams))
        t0 = time.perf_counter()
        (params2, state2), manifest = restore(ckdir, like,
                                              device=mesh.devices[0])
        _sync(device)
        restore_s = time.perf_counter() - t0
        bit_equal = all(
            a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
            for a, b in zip(tree_util.leaves((params2, state2)),
                            tree_util.leaves(saved)))
        del params, state, saved
        print(f"phase 2: restored step {manifest['step']} onto mesh "
              f"{mesh.axis_sizes()} ({nbytes / 1e9:.3f} GB in "
              f"{restore_s:.3f} s; bit-equal to the saved tree: {bit_equal})")
        params2, state2 = _train(model2, opt2, data, params2, state2,
                                 range(args.steps, args.steps + PHASE2_STEPS),
                                 device, losses2)
        launches.append(flash.launches)
        print(f"phase 2 continued training (loss {losses2[-1]:.4f}) — "
              f"elastic restart OK")
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    summary = {"arch": cfg.name, "device": str(device), "steps": args.steps,
               "phase1_losses": losses1, "phase2_losses": losses2,
               "restored_step": manifest["step"], "ckpt_bytes": nbytes,
               "save_s": save_s, "restore_s": restore_s,
               "restored_bit_equal": bit_equal, "mesh": mesh.axis_sizes(),
               "flash_launches": [launches[1] - launches[0],
                                  launches[2] - launches[1]]}
    print("elastic: " + json.dumps(summary))
    return dict(summary, params=params2, opt_state=state2)


def main(argv: Optional[List[str]] = None) -> int:
    """0 when the restored tree was bit-equal to the saved one and every
    loss finite, 1 otherwise."""
    res = run(argv)
    finite = all(map(math.isfinite, res["phase1_losses"]
                     + res["phase2_losses"]))
    return 0 if res["restored_bit_equal"] and finite else 1


if __name__ == "__main__":
    raise SystemExit(main())
