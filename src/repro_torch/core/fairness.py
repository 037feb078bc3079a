"""Starvation prevention — the fairness knob ε (§4.4).

Smallest-demand-first starves large jobs.  Venn bounds each job's scheduling
latency by its *fair share* ``T_i = M * sd_i`` (M = number of simultaneous
jobs, ``sd_i`` = contention-free JCT estimate) and biases the two scheduling
inputs with a multiplier controlled by ``ε ∈ [0, ∞)``:

    d'_i = d_i * (t_i / T_i)^ε          (intra-group demand key)
    q'_j = q_j * (Σ T_i / Σ t_i)^ε      (inter-group queue length)

**Interpretation note** (documented deviation): the paper defines ``t_i`` only
as "the time usage of job J_i at the moment".  Read as *attained service*
(LAS-style, cf. the paper's own Tiresias discussion in §6) both formulas become
directionally consistent: a job that has consumed more of its fair share sees
its effective demand grow (deprioritized within the group), and a group whose
jobs are under-served relative to fair share sees its queue amplified (gains
resources).  ε = 0 reduces exactly to §4.2; ε → ∞ approaches max-min fairness
on normalized attained service.  EXPERIMENTS.md validates the paper's Fig. 14
trade-off (JCT speedup falls, fair-share attainment rises with ε).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

from .types import Job, JobGroup

# Provides sd_i: the job's estimated contention-free JCT (manager supplies it
# from the supply estimator: rounds × (demand/|S_j| + t_response)).
SoloJctFn = Callable[[Job], float]


@dataclass
class FairnessPolicy:
    epsilon: float = 0.0
    # The usage ratio is clamped to [lo, hi] before the ε-power: with raw
    # ratios, a fresh job has t_i ≈ 0 and (t/T)^ε collapses every effective
    # demand to ~0, erasing the smallest-first ordering entirely (measured:
    # avg JCT 3.5x WORSE than random at ε=2).  Clamped, ε biases the order
    # toward under-served jobs without destroying it.
    lo: float = 0.7
    hi: float = 1.45

    def enabled(self) -> bool:
        return self.epsilon > 0.0

    def _clamp(self, r: float) -> float:
        return min(max(r, self.lo), self.hi)

    # ----------------------------------------------------------- intra-group

    def demand_key(self, job: Job, num_jobs: int, solo_jct: SoloJctFn) -> float:
        """d'_i — effective remaining demand used for intra-group ordering.

        Tenant priority divides the key: a priority-p job is ordered as if its
        remaining demand were d/p, so higher tiers are served earlier within
        their group (neutral at the default p = 1.0).  Applied before the ε
        usage bias so fairness still moderates across priorities."""
        d = float(job.remaining_demand) / max(job.priority, 1e-9)
        if not self.enabled():
            return d
        t_fair = max(num_jobs, 1) * max(solo_jct(job), 1e-9)
        usage = self._clamp(job.attained_service / t_fair)
        return d * usage ** self.epsilon

    # ----------------------------------------------------------- inter-group

    def queue_len(self, group: JobGroup, num_jobs: int, solo_jct: SoloJctFn) -> float:
        """q'_j — effective queue length used for inter-group pressure."""
        q = float(group.queue_len)
        if not self.enabled() or q == 0:
            return q
        tot_fair = sum(max(num_jobs, 1) * max(solo_jct(j), 1e-9)
                       for j in group.jobs if j.current is not None)
        tot_used = sum(max(j.attained_service, 0.0)
                       for j in group.jobs if j.current is not None)
        ratio = self._clamp(tot_fair / max(tot_used, 1e-9))
        return q * ratio ** self.epsilon

    # ------------------------------------------------------------- reporting

    @staticmethod
    def fair_share_met(job: Job, num_jobs_avg: float, solo_jct: float) -> Optional[bool]:
        """Did the finished job meet its fair-share JCT  T_i = M * sd_i ?"""
        jct = job.jct()
        if jct is None:
            return None
        return jct <= max(num_jobs_avg, 1.0) * solo_jct
