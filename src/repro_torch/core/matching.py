"""Resource-aware tier-based device-to-job matching — Algorithm 2 (§4.3).

Response collection time is set by the *slowest* qualifying responder, so
matching a served job to devices of one capacity tier shrinks its tail.  The
price is scheduling delay: restricting to one of ``V`` tiers divides the
eligible influx by ~V.  Venn triggers tiered matching only when it wins on JCT:

    V + g_u * c_i  <  1 + c_i,      c_i = t_response / t_schedule,
                                    g_v = t^v_p95 / t^0_p95  (tier speedup)

The tier ``u`` is drawn uniformly per request ("rotating" assignment) so jobs
still see diverse devices across rounds — this is what keeps final accuracy
unaffected (paper Fig. 9).  Device response times follow a log-normal (Wang et
al., 2023); the p95 is used as the statistical tail to exclude failures and
stragglers.  Jobs with no history are profiled first (no tier restriction).
"""
from __future__ import annotations

import math
import random
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .types import Device, Job


def _percentile(sorted_vals: Sequence[float], q: float) -> float:
    if len(sorted_vals) == 0:
        return float("nan")
    idx = min(len(sorted_vals) - 1, max(0, int(math.ceil(q * len(sorted_vals))) - 1))
    return float(sorted_vals[idx])


class JobProfile:
    """Per-job response history: (device speed, response time) samples from
    participants of earlier rounds, used to set tier thresholds adaptively.

    Records are O(1) list appends (truncated to the trailing ``max_samples``
    window lazily) and sorted views are cached as NumPy arrays — the
    scheduler re-reads them on every replan, so refresh cost is one
    vectorized sort."""

    __slots__ = ("max_samples", "_speeds_l", "_rts_l",
                 "_dirty", "_sorted_speeds", "_sorted_rts", "_rts_by_speed")

    def __init__(self, max_samples: int = 2048):
        self.max_samples = max_samples
        self._speeds_l: List[float] = []
        self._rts_l: List[float] = []
        self._dirty = True
        self._sorted_speeds = np.zeros(0)
        self._sorted_rts = np.zeros(0)
        self._rts_by_speed = np.zeros(0)

    def record(self, speed: float, response_time: float) -> None:
        self._speeds_l.append(speed)
        self._rts_l.append(response_time)
        self._dirty = True
        if len(self._rts_l) >= 2 * self.max_samples:
            self._truncate()

    def _truncate(self) -> None:
        m = self.max_samples
        if len(self._rts_l) > m:
            del self._speeds_l[:-m]
            del self._rts_l[:-m]

    @property
    def samples(self) -> List[Tuple[float, float]]:
        """(speed, response_time) pairs, oldest first (compatibility view)."""
        m = self.max_samples
        return list(zip(self._speeds_l[-m:], self._rts_l[-m:]))

    def _refresh(self) -> None:
        if self._dirty:
            self._truncate()
            speeds = np.asarray(self._speeds_l)
            rts = np.asarray(self._rts_l)
            order = np.argsort(speeds)
            self._sorted_speeds = speeds[order]
            self._rts_by_speed = rts[order]
            self._sorted_rts = np.sort(rts)
            self._dirty = False

    def sorted_speeds(self) -> np.ndarray:
        self._refresh()
        return self._sorted_speeds

    def sorted_rts(self) -> np.ndarray:
        self._refresh()
        return self._sorted_rts

    def rts_by_speed(self) -> np.ndarray:
        """Response times ordered by the corresponding device speed."""
        self._refresh()
        return self._rts_by_speed

    @property
    def n(self) -> int:
        return min(len(self._rts_l), self.max_samples)


@dataclass
class TierDecision:
    """Outcome of VENN-MATCH for one served request."""

    tiered: bool
    tier_index: int = 0
    v: int = 1
    speed_lo: float = 0.0          # accepted speed band [lo, hi)
    speed_hi: float = float("inf")
    g_u: float = 1.0
    c_i: float = 0.0

    def accepts(self, device: Device) -> bool:
        if not self.tiered:
            return True
        return self.speed_lo <= device.speed < self.speed_hi


class TierMatcher:
    """Implements Algorithm 2 for the jobs currently served by Algorithm 1."""

    def __init__(self, num_tiers: int = 4, tail_q: float = 0.95,
                 rng: Optional[random.Random] = None):
        if num_tiers < 1:
            raise ValueError("num_tiers >= 1")
        self.v = int(num_tiers)
        self.tail_q = float(tail_q)
        self.rng = rng or random.Random(0)

    # ----------------------------------------------------------------- API

    def decide(self, job: Job, profile: JobProfile,
               t_schedule: float, t_response: float) -> TierDecision:
        """VENN-MATCH(J_i, S'_j): decide whether to restrict the job's influx
        to one randomly drawn capacity tier.

        ``t_schedule``: expected time to acquire the remaining demand at the
        group's currently allocated rate (from the supply estimator).
        ``t_response``: expected (un-tiered) response collection time, p95.
        """
        if self.v <= 1 or profile.n < 4 * self.v or t_schedule <= 0:
            return TierDecision(tiered=False, v=self.v)

        speeds = profile.sorted_speeds()
        u = self.rng.randrange(self.v)                    # line 6: u = randint(0, V)
        lo, hi = self._tier_bounds(speeds, u)
        g_u = self._tier_speedup(profile, lo, hi)
        c_i = t_response / t_schedule                      # line 5
        if self.v + g_u * c_i < c_i + 1.0:                 # line 7 trigger
            return TierDecision(True, u, self.v, lo, hi, g_u, c_i)
        return TierDecision(False, u, self.v, g_u=g_u, c_i=c_i)

    # ------------------------------------------------------------ internals

    def _tier_bounds(self, speeds: Sequence[float], u: int) -> Tuple[float, float]:
        """Adaptive thresholds: equal-mass quantile cuts of the speed
        distribution observed in earlier rounds."""
        n = len(speeds)
        lo_i = (u * n) // self.v
        hi_i = ((u + 1) * n) // self.v
        lo = 0.0 if u == 0 else float(speeds[lo_i])
        hi = float("inf") if u == self.v - 1 else float(speeds[min(hi_i, n - 1)])
        return lo, hi

    def _tier_speedup(self, profile: JobProfile, lo: float, hi: float) -> float:
        """g_v = t^v / t^0 on the p95 tail of observed response times."""
        speeds = profile.sorted_speeds()
        i0 = int(np.searchsorted(speeds, lo, side="left"))
        i1 = int(np.searchsorted(speeds, hi, side="left"))
        tier_rt = np.sort(profile.rts_by_speed()[i0:i1])
        t0 = _percentile(profile.sorted_rts(), self.tail_q)
        if len(tier_rt) == 0 or not math.isfinite(t0) or t0 <= 0:
            return 1.0
        tv = _percentile(tier_rt, self.tail_q)
        return tv / t0
