"""Job workload traces (Fig. 8b) and the five evaluation workloads (§5.1).

Jobs arrive by a Poisson process (default mean inter-arrival 30 min).  Each
job draws per-round demand, number of rounds, task duration and a device
requirement class.  Workload variants sample from the same base distribution:

* ``even``  — all jobs (default),
* ``small`` / ``large`` — below-/above-average **total** demand (demand × rounds),
* ``low``   / ``high``  — below-/above-average **per-round** demand,

plus the four *biased* workloads of §5.4 (half the jobs pinned to one
requirement class, the rest uniform).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import List, Optional, Sequence

import numpy as np

from ..core.types import Job, Requirement
from .devices import REQUIREMENT_CLASSES

WORKLOADS = ("even", "small", "large", "low", "high")
BIASED = {"general": 0, "compute_heavy": 1, "memory_heavy": 2, "resource_heavy": 3}


@dataclass
class JobTraceConfig:
    num_jobs: int = 50
    mean_interarrival: float = 1800.0       # 30 min Poisson (§5.1)
    demand_lo: int = 20                     # per-round demand, log-uniform
    demand_hi: int = 800
    rounds_lo: int = 4
    rounds_hi: int = 40
    task_time_lo: float = 40.0              # mean on-device task seconds
    task_time_hi: float = 240.0
    task_sigma: float = 0.35
    deadline_lo: float = 300.0              # 5-15 min (§5.1)
    deadline_hi: float = 900.0
    quorum: float = 0.8
    workload: str = "even"
    bias: Optional[str] = None              # §5.4 biased workloads
    seed: int = 0


def _loguniform(rng: np.random.Generator, lo: float, hi: float, n: int) -> np.ndarray:
    return np.exp(rng.uniform(math.log(lo), math.log(hi), size=n))


def generate_jobs(cfg: JobTraceConfig) -> List[Job]:
    """Draw a job trace; workload filters resample until the condition holds."""
    rng = np.random.default_rng(cfg.seed)
    # Draw a large base pool, compute averages, then filter per workload.
    pool_n = max(cfg.num_jobs * 8, 256)
    demands = np.rint(_loguniform(rng, cfg.demand_lo, cfg.demand_hi, pool_n)).astype(int)
    rounds = np.rint(_loguniform(rng, cfg.rounds_lo, cfg.rounds_hi, pool_n)).astype(int)
    totals = demands * rounds
    avg_total, avg_round = totals.mean(), demands.mean()

    mask = np.ones(pool_n, dtype=bool)
    if cfg.workload == "small":
        mask = totals < avg_total
    elif cfg.workload == "large":
        mask = totals >= avg_total
    elif cfg.workload == "low":
        mask = demands < avg_round
    elif cfg.workload == "high":
        mask = demands >= avg_round
    elif cfg.workload != "even":
        raise ValueError(f"unknown workload {cfg.workload!r}")
    idx = np.flatnonzero(mask)[: cfg.num_jobs]
    if len(idx) < cfg.num_jobs:
        raise ValueError("base pool too small for workload filter")

    n = cfg.num_jobs
    arrivals = np.cumsum(rng.exponential(cfg.mean_interarrival, size=n))
    task_means = _loguniform(rng, cfg.task_time_lo, cfg.task_time_hi, n)

    # requirement class per job: uniform by default, else biased (§5.4)
    if cfg.bias is None:
        req_idx = rng.integers(0, len(REQUIREMENT_CLASSES), size=n)
    else:
        pinned = BIASED[cfg.bias]
        req_idx = np.where(
            rng.uniform(size=n) < 0.5, pinned,
            rng.integers(0, len(REQUIREMENT_CLASSES), size=n))

    jobs: List[Job] = []
    for i in range(n):
        d = int(demands[idx[i]])
        # deadline scales with demand within [lo, hi] (§5.1: 5-15 min
        # "depending on the round demand")
        frac = (math.log(d) - math.log(cfg.demand_lo)) / (
            math.log(cfg.demand_hi) - math.log(cfg.demand_lo))
        deadline = cfg.deadline_lo + frac * (cfg.deadline_hi - cfg.deadline_lo)
        jobs.append(Job(
            job_id=i,
            requirement=REQUIREMENT_CLASSES[int(req_idx[i])],
            demand_per_round=d,
            total_rounds=int(rounds[idx[i]]),
            arrival_time=float(arrivals[i]),
            task_time_mean=float(task_means[i]),
            task_time_sigma=cfg.task_sigma,
            quorum_fraction=cfg.quorum,
            deadline=float(deadline),
        ))
    return jobs


def workload_variants(base: JobTraceConfig) -> Sequence[JobTraceConfig]:
    return [replace(base, workload=w) for w in WORKLOADS]
