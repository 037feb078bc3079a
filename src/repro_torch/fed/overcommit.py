"""Straggler mitigation policies — the fault tolerance Venn delegates to
jobs (§3): overcommit + deadline + quorum.

Google's production FL (Bonawitz et al. 2019, cited §3) over-provisions each
round by ~30% and closes the round at a quorum of reporters.  The policy here
computes the overcommit factor from the job's observed failure/straggle rate
so retried rounds shrink toward the deadline-quorum optimum.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass
class OvercommitPolicy:
    base: float = 1.3               # initial over-provision factor
    min_factor: float = 1.0
    max_factor: float = 2.0
    ema: float = 0.3                # smoothing of observed failure rate

    def __post_init__(self):
        self._fail_rate = 1.0 - 1.0 / self.base

    def observe_round(self, granted: int, responded: int) -> None:
        if granted <= 0:
            return
        rate = 1.0 - responded / granted
        self._fail_rate = (1 - self.ema) * self._fail_rate + self.ema * rate

    def factor(self, quorum_fraction: float = 0.8) -> float:
        """Provision so that expected responders >= quorum of nominal demand:
        factor * (1 - fail_rate) >= quorum  =>  factor = quorum/(1-fail)."""
        safe = max(1e-3, 1.0 - self._fail_rate)
        f = max(quorum_fraction / safe, self.min_factor)
        return min(f, self.max_factor)

    def demand(self, nominal: int, quorum_fraction: float = 0.8) -> int:
        return max(nominal, int(round(nominal * self.factor(quorum_fraction))))
