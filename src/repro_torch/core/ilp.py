"""Exact reference solvers for the IRS problem (Appendix A): the
reference's ``repro/core/ilp.py``, copied so that the port imports nothing
of it.

The ILP: binary x_ij assigns arriving device i (time t_i) to job j, subject to
one-job-per-device, eligibility e_ij, and Σ_i x_ij = D_j; minimize the mean of
T_j = max_i (x_ij t_i).  No ILP solver ships in this environment, so we provide
two exact references for *small* instances used by the test-suite to bound the
heuristic's optimality gap:

* :func:`optimal_by_permutation` — exhaustive search over job priority orders,
  assigning each device to the first eligible unfinished job.  An exchange
  argument shows some permutation attains the ILP optimum: order an optimal
  solution's jobs by completion time; whenever a device is assigned out of
  order, swapping it with a later device of the earlier job never delays
  either completion.  (Verified against the brute-force below in tests.)
* :func:`optimal_bruteforce` — enumerate every feasible x (tiny q, m only).
"""
from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Sequence, Tuple

Arrival = Tuple[float, int]     # (time, atom_id)


def _simulate_order(order: Sequence[int], demands: Sequence[int],
                    elig: Sequence[Sequence[int]],
                    arrivals: Sequence[Arrival]) -> Optional[List[float]]:
    """Greedy fixed-priority assignment; returns per-job completion times."""
    remaining = list(demands)
    done_t: List[Optional[float]] = [None] * len(demands)
    for t, atom in arrivals:
        for j in order:
            if remaining[j] > 0 and atom in elig[j]:
                remaining[j] -= 1
                if remaining[j] == 0:
                    done_t[j] = t
                break
    if any(d is None for d in done_t):
        return None
    return [float(d) for d in done_t]  # type: ignore[misc]


def optimal_by_permutation(demands: Sequence[int], elig: Sequence[Sequence[int]],
                           arrivals: Sequence[Arrival]
                           ) -> Tuple[float, Tuple[int, ...]]:
    """Exact optimum over all job priority permutations (m <= ~8)."""
    m = len(demands)
    best, best_order = float("inf"), tuple(range(m))
    for order in itertools.permutations(range(m)):
        ts = _simulate_order(order, demands, elig, arrivals)
        if ts is None:
            continue
        avg = sum(ts) / m
        if avg < best:
            best, best_order = avg, order
    return best, best_order


def optimal_bruteforce(demands: Sequence[int], elig: Sequence[Sequence[int]],
                       arrivals: Sequence[Arrival]) -> float:
    """Exact optimum by enumerating x_ij (use only for q*m <= ~20)."""
    m, q = len(demands), len(arrivals)
    best = float("inf")
    # each device picks one of: a job it's eligible for, or unassigned (-1)
    choices: List[List[int]] = []
    for t, atom in arrivals:
        opts = [-1] + [j for j in range(m) if atom in elig[j]]
        choices.append(opts)
    for assign in itertools.product(*choices):
        counts = [0] * m
        comp = [0.0] * m
        for i, j in enumerate(assign):
            if j >= 0:
                counts[j] += 1
                comp[j] = max(comp[j], arrivals[i][0])
        if counts == list(demands):
            best = min(best, sum(comp) / m)
    return best


def greedy_order_jct(order: Sequence[int], demands: Sequence[int],
                     elig: Sequence[Sequence[int]],
                     arrivals: Sequence[Arrival]) -> Optional[float]:
    ts = _simulate_order(order, demands, elig, arrivals)
    return None if ts is None else sum(ts) / len(ts)
