"""Declarative scenario specs + registry.

A scenario is a *data* description of an evaluation environment: which jobs
arrive (a :class:`~repro_torch.sim.traces.JobTraceConfig`), how the device
population behaves (a :class:`~repro_torch.sim.devices.PopulationConfig` plus
modulation events), and how long the simulation runs.  The scenario engine
compiles the declaration into a :class:`~repro_torch.sim.devices.ChunkStream`
(:mod:`repro_torch.scenarios.streams`) and a job list — there is no per-scenario
imperative code, so scenarios serialize cleanly, scale with ``--fast``, and
new ones are a single :func:`register` call (see ``library.py``).

All modulation windows use **horizon fractions** (0.0 = sim start, 1.0 =
``sim.max_time``) so a scenario keeps its shape when the runner shrinks the
horizon for smoke runs.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..faults.plan import FaultPlan
from ..sim.devices import PopulationConfig
from ..sim.simulator import SimConfig
from ..sim.traces import JobTraceConfig


# --------------------------------------------------------------------------- #
# Modulation events (all windows are fractions of the sim horizon)
# --------------------------------------------------------------------------- #

@dataclass(frozen=True)
class RateSpike:
    """Multiply the check-in rate by ``multiplier`` inside a window
    (flash-crowd arrivals, e.g. an OS-update reboot wave)."""

    start: float
    stop: float
    multiplier: float


@dataclass(frozen=True)
class FailureStorm:
    """Force an extra i.i.d. failure probability on devices checking in
    inside a window (correlated churn: a backend outage, a bad rollout)."""

    start: float
    stop: float
    fail_prob: float


@dataclass(frozen=True)
class CapacityDrift:
    """Linearly ramp device capability medians between two windows — a fleet
    upgrade mid-run.  At ``start`` factors are 1.0; from ``stop`` on they are
    (``cpu_factor``, ``mem_factor``).  Device speed scales consistently with
    cpu (same exponent as the population model)."""

    start: float
    stop: float
    cpu_factor: float
    mem_factor: float


@dataclass(frozen=True)
class SpeedTail:
    """Slow a random ``fraction`` of devices by ``factor`` (long-tail
    stragglers beyond the log-normal speed noise)."""

    fraction: float
    factor: float


@dataclass(frozen=True)
class TenantTier:
    """A priority tier: ``fraction`` of jobs belong to tenant ``name`` with
    scheduling weight ``priority`` (see ``Job.priority``)."""

    name: str
    fraction: float
    priority: float


# --------------------------------------------------------------------------- #
# Scenario spec
# --------------------------------------------------------------------------- #

@dataclass(frozen=True)
class ScenarioSpec:
    """One named evaluation environment, fully declarative."""

    name: str
    description: str
    jobs: JobTraceConfig = field(default_factory=JobTraceConfig)
    population: PopulationConfig = field(default_factory=PopulationConfig)
    sim: SimConfig = field(default_factory=SimConfig)
    # ---- device-side modulation ----
    diurnal_phases: Tuple[float, ...] = ()       # seconds; >1 phase = timezones
    rate_spikes: Tuple[RateSpike, ...] = ()
    failure_storms: Tuple[FailureStorm, ...] = ()
    capacity_drift: Optional[CapacityDrift] = None
    speed_tail: Optional[SpeedTail] = None
    # ---- job-side hooks ----
    pin_requirement: Optional[str] = None        # all jobs -> one req class
    tenant_tiers: Tuple[TenantTier, ...] = ()
    # ---- fault injection (repro_torch.faults) ----
    # fractional plans share the horizon-fraction window convention above;
    # the runner resolves them against sim.max_time and composes the
    # injector onto the device stream + arms simulator-side revocation
    fault_plan: Optional[FaultPlan] = None

    def validate(self) -> None:
        for w in (*self.rate_spikes, *self.failure_storms):
            if not (0.0 <= w.start < w.stop <= 1.0):
                raise ValueError(
                    f"{self.name}: window [{w.start}, {w.stop}] must satisfy "
                    "0 <= start < stop <= 1 (horizon fractions)")
        d = self.capacity_drift
        if d is not None and not (0.0 <= d.start < d.stop <= 1.0):
            raise ValueError(f"{self.name}: drift window out of range")
        if self.speed_tail is not None and not (0.0 < self.speed_tail.fraction <= 1.0):
            raise ValueError(f"{self.name}: speed_tail.fraction out of (0, 1]")
        if self.tenant_tiers:
            tot = sum(t.fraction for t in self.tenant_tiers)
            if not 0.999 <= tot <= 1.001:
                raise ValueError(
                    f"{self.name}: tenant tier fractions sum to {tot}, not 1")
        if self.fault_plan is not None:
            self.fault_plan.validate()


# --------------------------------------------------------------------------- #
# Registry
# --------------------------------------------------------------------------- #

_REGISTRY: Dict[str, ScenarioSpec] = {}


def register(spec_or_factory):
    """Register a scenario.

    Usable two ways::

        register(ScenarioSpec(name="x", ...))        # direct

        @register                                     # factory (evaluated once)
        def my_scenario() -> ScenarioSpec:
            return ScenarioSpec(name="my_scenario", ...)
    """
    spec = spec_or_factory() if callable(spec_or_factory) else spec_or_factory
    if not isinstance(spec, ScenarioSpec):
        raise TypeError(f"register expects a ScenarioSpec, got {type(spec)!r}")
    spec.validate()
    if spec.name in _REGISTRY:
        raise ValueError(f"duplicate scenario name: {spec.name!r}")
    _REGISTRY[spec.name] = spec
    return spec_or_factory


def get_scenario(name: str) -> ScenarioSpec:
    try:
        return _REGISTRY[name]
    except KeyError:
        known = ", ".join(sorted(_REGISTRY)) or "<none>"
        raise KeyError(f"unknown scenario {name!r}; registered: {known}") from None


def scenario_names() -> List[str]:
    return sorted(_REGISTRY)


def all_scenarios() -> List[ScenarioSpec]:
    return [_REGISTRY[n] for n in scenario_names()]
