"""JCT metrics & breakdowns (§5 — the quantities behind Tables 1-4, Figs 5/11)."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from ..core.types import Job, JobStatus


@dataclass
class RoundRecord:
    job_id: int
    round_index: int
    submit: float
    alloc_complete: Optional[float]
    complete: float
    demand: int
    responses: int
    failures: int
    retries: int

    @property
    def scheduling_delay(self) -> float:
        if self.alloc_complete is None:
            return self.complete - self.submit
        return self.alloc_complete - self.submit

    @property
    def response_collection(self) -> float:
        if self.alloc_complete is None:
            return 0.0
        return self.complete - self.alloc_complete


@dataclass
class SimMetrics:
    rounds: List[RoundRecord] = field(default_factory=list)
    aborts: int = 0
    failed_rounds: int = 0
    jcts: Dict[int, float] = field(default_factory=dict)
    unfinished: int = 0
    makespan: float = 0.0
    _jobs: List[Job] = field(default_factory=list)
    # ---- resilience counters (fault injection / recovery / degradation).
    # Kept OUT of summary(): summary() is compared bit-for-bit across drain
    # engines, and e.g. degraded_segments only exists on the array engine.
    submitted_rounds: int = 0      # every _submit_round (incl. retries)
    revoked_responses: int = 0     # in-flight responses killed by blackouts
    recovery_events: int = 0       # crash-restore cycles this metrics lived
    degraded_segments: int = 0     # accel segments served by scalar fallback
    stale_plans_served: int = 0    # replans skipped under the time budget
    skipped_rows: int = 0          # malformed trace rows skipped on replay
    dropped_checkins: int = 0      # check-in rows removed by stream faults
    flaky_retries: int = 0         # ingest read retries (flaky-read model)

    def finalize(self, jobs: List[Job], now: float) -> None:
        self._jobs = list(jobs)
        self.makespan = now
        for j in jobs:
            if j.status is JobStatus.DONE and j.completion_time is not None:
                self.jcts[j.job_id] = j.completion_time - j.arrival_time
            else:
                # pessimistic censoring: count elapsed time for unfinished jobs
                self.jcts[j.job_id] = now - j.arrival_time
                self.unfinished += 1

    # ------------------------------------------------------------- queries

    @property
    def avg_jct(self) -> float:
        return float(np.mean(list(self.jcts.values()))) if self.jcts else float("nan")

    def avg_jct_of(self, job_ids) -> float:
        vals = [self.jcts[i] for i in job_ids if i in self.jcts]
        return float(np.mean(vals)) if vals else float("nan")

    @property
    def avg_scheduling_delay(self) -> float:
        if not self.rounds:
            return float("nan")
        return float(np.mean([r.scheduling_delay for r in self.rounds]))

    @property
    def avg_response_collection(self) -> float:
        if not self.rounds:
            return float("nan")
        return float(np.mean([r.response_collection for r in self.rounds]))

    def speedup_vs(self, baseline: "SimMetrics") -> float:
        return baseline.avg_jct / self.avg_jct

    def fair_share_met_fraction(self, solo_jcts: Dict[int, float],
                                num_jobs: Optional[int] = None) -> float:
        """Fraction of jobs whose JCT <= M * sd_i (§4.4/Fig 14b)."""
        m = num_jobs if num_jobs is not None else len(self.jcts)
        met = [self.jcts[i] <= m * sd for i, sd in solo_jcts.items() if i in self.jcts]
        return float(np.mean(met)) if met else float("nan")

    def resilience(self) -> Dict[str, int]:
        """Fault/recovery counters.  Every entry except ``submitted_rounds``
        (a plain throughput denominator) is exactly zero on a fault-free,
        crash-free run."""
        return {
            "submitted_rounds": self.submitted_rounds,
            "revoked_responses": self.revoked_responses,
            "recovery_events": self.recovery_events,
            "degraded_segments": self.degraded_segments,
            "stale_plans_served": self.stale_plans_served,
            "skipped_rows": self.skipped_rows,
            "dropped_checkins": self.dropped_checkins,
            "flaky_retries": self.flaky_retries,
        }

    def _jct_percentile(self, q: float) -> float:
        vals = list(self.jcts.values())
        return float(np.percentile(vals, q)) if vals else float("nan")

    @property
    def p50_jct(self) -> float:
        return self._jct_percentile(50.0)

    @property
    def p99_jct(self) -> float:
        return self._jct_percentile(99.0)

    @property
    def p99_scheduling_delay(self) -> float:
        if not self.rounds:
            return float("nan")
        return float(np.percentile(
            [r.scheduling_delay for r in self.rounds], 99.0))

    def summary(self) -> Dict[str, float]:
        return {
            "avg_jct": self.avg_jct,
            "p50_jct": self.p50_jct,
            "p99_jct": self.p99_jct,
            "avg_scheduling_delay": self.avg_scheduling_delay,
            "p99_scheduling_delay": self.p99_scheduling_delay,
            "avg_response_collection": self.avg_response_collection,
            "aborts": float(self.aborts),
            "failed_rounds": float(self.failed_rounds),
            "unfinished": float(self.unfinished),
            "makespan": self.makespan,
        }
