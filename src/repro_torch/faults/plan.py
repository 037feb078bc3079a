"""Declarative fault plans (the robustness analogue of a scenario spec).

A :class:`FaultPlan` is pure data describing *what goes wrong*: correlated
blackout windows, chunk-level transport chaos (drop / duplicate / reorder),
clock-skewed late check-ins, corrupted sensor readings, and flaky ingest
reads.  It composes onto any :class:`~repro_torch.sim.devices.ChunkStream` via
:class:`~repro_torch.faults.injector.FaultInjector` and arms the simulator-side
response revocation (blackouts knock out devices *mid-task*, not just at
check-in — a correlated failure mode beyond the i.i.d. ``fail_u`` draws).

Window convention matches :mod:`repro_torch.scenarios`: blackout windows are
**horizon fractions** (0.0 = sim start, 1.0 = ``sim.max_time``) until
:meth:`FaultPlan.resolve` converts them to absolute seconds, so a plan keeps
its shape when a runner shrinks the horizon for smoke runs.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple


def _check_prob(name: str, value: float, ctx: str) -> None:
    if not 0.0 <= value <= 1.0:
        raise ValueError(f"{ctx}: {name}={value} must be in [0, 1]")


@dataclass(frozen=True)
class Blackout:
    """A correlated outage window: check-ins inside ``[start, stop)`` are
    dropped with probability ``drop_prob``, and (with ``revoke_in_flight``)
    devices whose response would land inside the window are revoked — they
    went dark mid-task and never report back."""

    start: float
    stop: float
    drop_prob: float = 1.0
    revoke_in_flight: bool = True


@dataclass(frozen=True)
class ChunkChaos:
    """Chunk-level transport faults on the ingest path.  Duplicates and
    adjacent reorders are *recoverable* (the injector's ingest side dedups by
    sequence number and restores order, so they perturb counters but not
    outcomes); drops are real data loss; ``corrupt_speed_prob`` NaNs a
    fraction of speed readings (sensor corruption the matching layer must
    degrade around, not crash on)."""

    drop_prob: float = 0.0
    dup_prob: float = 0.0
    reorder_prob: float = 0.0
    corrupt_speed_prob: float = 0.0


@dataclass(frozen=True)
class ClockSkew:
    """A ``fraction`` of check-ins report late by up to ``max_skew`` seconds
    (absolute, not horizon-scaled).  Skewed rows that cross their chunk's end
    are carried into later chunks so the stream's cross-chunk time ordering
    contract is preserved."""

    fraction: float
    max_skew: float


@dataclass(frozen=True)
class FlakyIngest:
    """Transient read failures on the ingest path: each chunk read fails with
    ``fail_prob`` and is retried up to ``max_retries`` times with exponential
    backoff (``backoff * 2^attempt`` seconds, accounted, not slept).  A read
    that exhausts its retries abandons that chunk — graceful data loss, never
    an exception."""

    fail_prob: float
    max_retries: int = 6
    backoff: float = 1.0


@dataclass(frozen=True)
class FaultPlan:
    """One named bundle of fault events.  ``fractional=True`` (the default)
    means blackout windows are horizon fractions; :meth:`resolve` returns the
    absolute-seconds plan the injector and simulator consume."""

    blackouts: Tuple[Blackout, ...] = ()
    chunk_chaos: Optional[ChunkChaos] = None
    clock_skew: Optional[ClockSkew] = None
    flaky_ingest: Optional[FlakyIngest] = None
    seed: int = 0
    fractional: bool = True

    # ------------------------------------------------------------- validation

    def validate(self) -> None:
        for b in self.blackouts:
            if not b.start < b.stop or b.start < 0.0:
                raise ValueError(
                    f"blackout [{b.start}, {b.stop}) must satisfy "
                    "0 <= start < stop")
            if self.fractional and b.stop > 1.0:
                raise ValueError(
                    f"blackout [{b.start}, {b.stop}): fractional windows "
                    "must end at or before 1.0 (the horizon)")
            _check_prob("drop_prob", b.drop_prob, "blackout")
        cc = self.chunk_chaos
        if cc is not None:
            for name in ("drop_prob", "dup_prob", "reorder_prob",
                         "corrupt_speed_prob"):
                _check_prob(name, getattr(cc, name), "chunk_chaos")
        cs = self.clock_skew
        if cs is not None:
            _check_prob("fraction", cs.fraction, "clock_skew")
            if cs.max_skew < 0.0:
                raise ValueError(f"clock_skew.max_skew={cs.max_skew} < 0")
        fi = self.flaky_ingest
        if fi is not None:
            if not 0.0 <= fi.fail_prob < 1.0:
                raise ValueError(
                    f"flaky_ingest.fail_prob={fi.fail_prob} must be in [0, 1)")
            if fi.max_retries < 0:
                raise ValueError("flaky_ingest.max_retries must be >= 0")
            if fi.backoff < 0.0:
                raise ValueError("flaky_ingest.backoff must be >= 0")

    # -------------------------------------------------------------- resolution

    def resolve(self, horizon: float) -> "FaultPlan":
        """Absolute-seconds copy of this plan (identity if already absolute)."""
        if not self.fractional:
            return self
        self.validate()
        blackouts = tuple(
            replace(b, start=b.start * horizon, stop=b.stop * horizon)
            for b in self.blackouts)
        return replace(self, blackouts=blackouts, fractional=False)

    # ---------------------------------------------------------------- queries

    @property
    def is_empty(self) -> bool:
        """True when the plan injects nothing (an identity wrapper)."""
        return (not self.blackouts and self.chunk_chaos is None
                and self.clock_skew is None and self.flaky_ingest is None)
