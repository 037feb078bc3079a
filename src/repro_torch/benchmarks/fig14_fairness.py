"""Fig. 14: fairness knob ε — JCT speedup falls, fair-share attainment
rises.  Paper: ε=2 gives 69% of jobs their fair-share JCT.  Accept:
fair-share fraction at ε=2 >= fraction at ε=0, and speedup non-increasing
within noise."""
import numpy as np

from .common import N_JOBS, SEEDS, cli, emit, run_sched
from ..sim import JobTraceConfig


# approximate population fraction eligible to each requirement class
# (lognormal caps of PopulationConfig; General is everyone)
_CLASS_FRACTION = {"general": 1.0, "compute_rich": 0.21,
                   "memory_rich": 0.24, "high_performance": 0.09}


def _solo_jct_estimates(jobs, base_rate=1.5):
    """sd_i: contention-free JCT estimate (demand/eligible_rate + response)
    per round, times rounds — eligible rate is class-dependent."""
    out = {}
    for j in jobs:
        rate = base_rate * _CLASS_FRACTION.get(j.requirement.name, 1.0)
        per_round = j.demand_per_round / rate + 2.2 * j.task_time_mean
        out[j.job_id] = j.total_rounds * per_round
    return out


def main(device=None):
    out = {}
    for eps in (0.0, 0.5, 1.0, 2.0):
        sps, fairs = [], []
        for s in SEEDS:
            m_r, w_r, _ = run_sched("random",
                                    JobTraceConfig(num_jobs=N_JOBS, seed=s), s,
                                    device=device)
            m_v, w_v, jobs = run_sched(
                "venn", JobTraceConfig(num_jobs=N_JOBS, seed=s), s,
                device=device, epsilon=eps)
            sps.append(m_r.avg_jct / m_v.avg_jct)
            solo = _solo_jct_estimates(jobs)
            # M = average number of SIMULTANEOUS jobs (Little's law), not the
            # trace size — the paper's fair share T_i = M * sd_i
            m_avg = max(1.0, sum(m_v.jcts.values()) / m_v.makespan)
            fairs.append(m_v.fair_share_met_fraction(solo, num_jobs=m_avg))
        out[eps] = (float(np.mean(sps)), float(np.mean(fairs)))
        emit(f"fig14_eps{eps}", (w_r + w_v) * 1e6 / 2,
             f"speedup={out[eps][0]:.2f}x fair_share_met={out[eps][1]:.2f}")
    print("\n# Fig 14 summary")
    for eps, (sp, fair) in out.items():
        print(f"eps={eps:<4} speedup={sp:.2f}x fair-share-met={fair:.0%}")
    eps_list = sorted(out)
    sp = [out[e][0] for e in eps_list]
    dec = all(sp[i + 1] <= sp[i] * 1.05 for i in range(len(sp) - 1))
    ok = dec and out[2.0][1] >= out[0.0][1] - 0.03
    emit("fig14_validates", 0, f"fairness_tradeoff={ok}")
    return out


if __name__ == "__main__":
    cli(main)
