"""Fig. 10: scheduler overhead at scale — one VENN-SCHED invocation latency
vs #jobs and #groups.  Paper: low ms even at large scale,
O(m log m + n^2).  Accept: <50ms at 10k jobs/16 groups (python impl).

VENN-SCHED (``core/irs.py::venn_schedule``) is host code in both packages,
so these are host latencies; the device is resolved all the same, so that
this entry runs only where the others do."""
import time

import numpy as np

from .common import cli, emit
from ..core.irs import venn_schedule
from ..core.types import Job, JobGroup, JobRequest, Requirement
from ..device import resolve_device


def _mk_groups(m_jobs, n_groups, seed=0):
    rng = np.random.default_rng(seed)
    atoms = [frozenset({f"a{i}"} | {f"a{j}" for j in range(i)})
             for i in range(n_groups)]           # nested atom structure
    rates = {a: float(rng.uniform(0.5, 5.0)) for a in atoms}
    groups = []
    for gi in range(n_groups):
        req = Requirement.of(f"g{gi}", **{f"g{gi}": 1.0})
        g = JobGroup(requirement=req)
        g.eligible_atoms = frozenset(atoms[gi:])
        g.atom_rates = {a: rates[a] for a in g.eligible_atoms}
        g.supply = sum(g.atom_rates.values())
        for k in range(m_jobs // n_groups):
            j = Job(job_id=gi * 100000 + k, requirement=req,
                    demand_per_round=int(rng.integers(10, 500)),
                    total_rounds=5, arrival_time=0.0)
            j.current = JobRequest(job=j, round_index=0,
                                   demand=j.demand_per_round, submit_time=0.0)
            g.jobs.append(j)
        groups.append(g)
    return groups


def main(device=None):
    resolve_device(device)
    results = {}
    for m_jobs, n_groups in [(100, 4), (1000, 4), (10000, 4),
                             (1000, 16), (10000, 16), (10000, 64)]:
        groups = _mk_groups(m_jobs, n_groups)
        # warm + measure
        venn_schedule(groups, queue_len=lambda g: g.queue_len)
        reps = 5
        t0 = time.time()
        for _ in range(reps):
            venn_schedule(groups, queue_len=lambda g: g.queue_len)
        us = (time.time() - t0) / reps * 1e6
        results[(m_jobs, n_groups)] = us
        emit(f"fig10_m{m_jobs}_n{n_groups}", us, f"latency_ms={us/1e3:.2f}")
    ok = results[(10000, 16)] < 50_000
    emit("fig10_validates", 0, f"under_50ms_at_10k_jobs={ok}")
    return results


if __name__ == "__main__":
    cli(main)
