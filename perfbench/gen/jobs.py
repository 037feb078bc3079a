"""The benchmark's job-trace generator: a frozen copy, as arrays.

It draws, call for call, what the program's ``sim/traces.py::generate_jobs``
draws from one ``numpy.random.Generator``, so that one seed gives the same
trace in both; it returns the trace as arrays, and the program's ``Job``
objects and the reference's are built from them.  It imports nothing of the
program.

Parameters (the keys of a configuration's ``"jobs"`` object): ``num_jobs``,
``mean_interarrival`` (s, Poisson arrivals), ``demand_lo``/``demand_hi``
(per-round demand, log-uniform), ``rounds_lo``/``rounds_hi`` (log-uniform),
``task_time_lo``/``task_time_hi`` (mean on-device seconds, log-uniform),
``task_sigma``, ``deadline_lo``/``deadline_hi`` (s, scaled with demand),
``quorum``, ``workload`` (``even``, ``small``, ``large``, ``low``,
``high``), ``pin`` (a requirement class index every job is pinned to, or
null for the uniform draw), ``bias`` (a requirement class index half the
jobs are pinned to, each with probability 0.5, as the paper's Sec. 5.4
biased workloads and the program's ``JobTraceConfig.bias`` draw it; absent
or null for the uniform draw) and ``trace_seed``.
"""
from __future__ import annotations

import math

import numpy as np

WORKLOADS = ("even", "small", "large", "low", "high")


def _loguniform(rng, lo, hi, n):
    return np.exp(rng.uniform(math.log(lo), math.log(hi), size=n))


def generate(p: dict, seed: int, num_classes: int) -> dict:
    """The trace for ``seed`` (a deployment's is ``p["trace_seed"]``):
    arrays indexed by job id."""
    rng = np.random.default_rng(seed)
    n = int(p["num_jobs"])
    pool_n = max(n * 8, 256)
    demands = np.rint(_loguniform(rng, p["demand_lo"], p["demand_hi"],
                                  pool_n)).astype(int)
    rounds = np.rint(_loguniform(rng, p["rounds_lo"], p["rounds_hi"],
                                 pool_n)).astype(int)
    totals = demands * rounds
    workload = p.get("workload", "even")
    if workload == "small":
        mask = totals < totals.mean()
    elif workload == "large":
        mask = totals >= totals.mean()
    elif workload == "low":
        mask = demands < demands.mean()
    elif workload == "high":
        mask = demands >= demands.mean()
    elif workload == "even":
        mask = np.ones(pool_n, dtype=bool)
    else:
        raise ValueError(f"unknown workload {workload!r}")
    idx = np.flatnonzero(mask)[:n]
    if len(idx) < n:
        raise ValueError("base pool too small for the workload filter")
    arrivals = np.cumsum(rng.exponential(p["mean_interarrival"], size=n))
    task_means = _loguniform(rng, p["task_time_lo"], p["task_time_hi"], n)
    if p.get("bias") is None:
        req_idx = rng.integers(0, num_classes, size=n)
    else:
        req_idx = np.where(rng.uniform(size=n) < 0.5, int(p["bias"]),
                           rng.integers(0, num_classes, size=n))
    if p.get("pin") is not None:
        req_idx = np.full(n, int(p["pin"]))
    d = demands[idx]
    # deadline scales with demand within [lo, hi] (log scale), per job in
    # Python floats, as the program's generator computes it
    lo_l, hi_l = math.log(p["demand_lo"]), math.log(p["demand_hi"])
    deadlines = np.array([
        p["deadline_lo"] + (math.log(int(di)) - lo_l) / (hi_l - lo_l)
        * (p["deadline_hi"] - p["deadline_lo"]) for di in d.tolist()])
    return {
        "requirement": req_idx.astype(np.int64),
        "demand": d.astype(np.int64),
        "rounds": rounds[idx].astype(np.int64),
        "arrival": arrivals,
        "task_mean": task_means,
        "deadline": deadlines,
        "task_sigma": float(p["task_sigma"]),
        "quorum": float(p["quorum"]),
    }
