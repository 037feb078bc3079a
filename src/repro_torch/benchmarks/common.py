"""Shared benchmark harness: timed simulation runs + CSV contract.

Every benchmark prints ``name,us_per_call,derived`` rows (run.py contract):
``us_per_call`` is the wall-clock of the producing computation (per sim run
or per scheduler invocation), ``derived`` carries the paper metric (speedup,
fraction, ...).  Set REPRO_BENCH_FAST=1 to subsample seeds for smoke runs.

Simulations run the array drain (``Simulator(engine="array")``) on
``device``: check-ins are matched by the ``match_segment`` kernel and
VENN-SCHED's resorts launch ``segmented_order``.  ``device=None`` is
``cuda:0`` (an error without a card); ``"cpu"`` runs the host path.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np

from ..core import SCHEDULERS
from ..device import DeviceLike, resolve_device
from ..sim import (JobTraceConfig, PopulationConfig, SimConfig,
                   generate_jobs, run_workload)

FAST = os.environ.get("REPRO_BENCH_FAST", "0") == "1"
SEEDS = (1,) if FAST else (1, 2)
N_JOBS = 30 if FAST else 50

BASE_POP = dict(base_rate=1.5)   # calibrated: random-matching JCT dominated
#                                  by scheduling delay, as in the paper's §5
BASE_SIM = SimConfig(max_time=30 * 24 * 3600.0)


def run_sched(sched_name: str, trace_cfg: JobTraceConfig, seed: int,
              pop_kw: Optional[dict] = None, device: DeviceLike = None,
              engine: str = "array", **sched_kw):
    """One simulation.  The device goes to the drain engine and to VENN's
    replan engine both (``run_workload`` hands it to the drain engine only).
    ``engine="python"`` is the per-device loop, for identity checks."""
    dev = resolve_device(device)
    jobs = generate_jobs(trace_cfg)
    cls = SCHEDULERS[sched_name]
    sched = cls(seed=seed, device=dev, **sched_kw) if sched_name == "venn" \
        else cls(seed=seed)
    pop = PopulationConfig(seed=1000 + seed, **(pop_kw or BASE_POP))
    t0 = time.time()
    metrics = run_workload(jobs, sched, pop, BASE_SIM, engine=engine,
                           device=dev)
    wall = time.time() - t0
    return metrics, wall, jobs


def avg_jct_over_seeds(sched_name: str, trace_kw: dict, seeds=SEEDS,
                       pop_kw=None, device: DeviceLike = None,
                       **sched_kw) -> Tuple[float, float, list]:
    """Returns (mean avg_jct, mean wall, list of (metrics, jobs))."""
    jcts, walls, runs = [], [], []
    for s in seeds:
        cfg = JobTraceConfig(num_jobs=trace_kw.pop("num_jobs", N_JOBS)
                             if "num_jobs" in trace_kw else N_JOBS,
                             seed=s, **trace_kw)
        m, w, jobs = run_sched(sched_name, cfg, s, pop_kw, device,
                               **sched_kw)
        jcts.append(m.avg_jct)
        walls.append(w)
        runs.append((m, jobs))
        trace_kw = dict(trace_kw)  # defensive copy for next loop
    return float(np.mean(jcts)), float(np.mean(walls)), runs


def emit(name: str, us_per_call: float, derived) -> None:
    print(f"{name},{us_per_call:.1f},{derived}")


def speedup_table(trace_kw: dict, scheds=("fifo", "srsf", "venn"),
                  seeds=SEEDS, pop_kw=None, label: str = "",
                  venn_kw: Optional[dict] = None,
                  device: DeviceLike = None) -> Dict[str, float]:
    """Speedup of each scheduler vs random on identical traces."""
    out: Dict[str, float] = {}
    base_jcts = {}
    for s in seeds:
        cfg = JobTraceConfig(num_jobs=N_JOBS, seed=s, **trace_kw)
        m, w, _ = run_sched("random", cfg, s, pop_kw, device)
        base_jcts[s] = m.avg_jct
        emit(f"{label}random_s{s}", w * 1e6, f"jct={m.avg_jct:.0f}s")
    for name in scheds:
        sps = []
        for s in seeds:
            cfg = JobTraceConfig(num_jobs=N_JOBS, seed=s, **trace_kw)
            kw = dict(venn_kw or {}) if name == "venn" else {}
            m, w, _ = run_sched(name, cfg, s, pop_kw, device, **kw)
            sps.append(base_jcts[s] / m.avg_jct)
        out[name] = float(np.mean(sps))
        emit(f"{label}{name}", w * 1e6, f"speedup={out[name]:.2f}x")
    return out


def device_arg(ap: argparse.ArgumentParser) -> argparse.ArgumentParser:
    ap.add_argument("--device", default=None,
                    help="default cuda:0; 'cpu' for the host path")
    return ap


def cli(main: Callable, argv: Optional[Sequence[str]] = None):
    """``python -m repro_torch.benchmarks.<name> [--device D]``."""
    args = device_arg(argparse.ArgumentParser()).parse_args(argv)
    return main(device=resolve_device(args.device))

