"""Fig. 12: speedup vs number of jobs.  Paper: gains grow with contention.
Accept: venn speedup at 60 jobs >= speedup at 15 jobs - 0.15."""
import numpy as np

from .common import SEEDS, cli, emit, run_sched
from ..sim import JobTraceConfig


def main(device=None):
    out = {}
    for n in (15, 30, 60):
        sps = []
        for s in SEEDS:
            m_r, w_r, _ = run_sched("random",
                                    JobTraceConfig(num_jobs=n, seed=s), s,
                                    device=device)
            m_v, w_v, _ = run_sched("venn",
                                    JobTraceConfig(num_jobs=n, seed=s), s,
                                    device=device)
            sps.append(m_r.avg_jct / m_v.avg_jct)
        out[n] = float(np.mean(sps))
        emit(f"fig12_jobs{n}", (w_r + w_v) * 1e6 / 2,
             f"speedup={out[n]:.2f}x")
    print("\n# Fig 12 summary: " + " ".join(f"{n}j={v:.2f}x"
                                            for n, v in out.items()))
    ok = out[60] >= out[15] - 0.15
    emit("fig12_validates", 0, f"gain_grows_with_jobs={ok}")
    return out


if __name__ == "__main__":
    cli(main)
