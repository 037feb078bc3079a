"""The built-in scenario library (≥8 named evaluation environments).

Each scenario is a declarative :class:`~repro_torch.scenarios.spec.ScenarioSpec`;
:mod:`.spec` holds the schema; a new one is one :func:`register` call.  The
library spans the axes the paper evaluates (§5: workloads, biased mixes,
availability) plus the adversarial patterns platform work like Propius and
multi-job FL schedulers report: arrival spikes, timezone shift, correlated
churn, fleet drift, tenant priorities, requirement-class contention, and
straggler tails.
"""
from __future__ import annotations

from ..faults.plan import (Blackout, ChunkChaos, ClockSkew, FaultPlan,
                           FlakyIngest)
from ..sim.devices import PopulationConfig
from ..sim.simulator import SimConfig
from ..sim.traces import JobTraceConfig
from .spec import (CapacityDrift, FailureStorm, RateSpike, ScenarioSpec,
                   SpeedTail, TenantTier, register)

WEEK = 7 * 24 * 3600.0

# Shared sizing: one simulated week, a moderate multi-job load.  Individual
# scenarios override where the stress pattern needs it.
_JOBS = JobTraceConfig(num_jobs=24)
_SIM = SimConfig(max_time=WEEK)


register(ScenarioSpec(
    name="baseline_even",
    description="Paper-faithful §5.1 testbed: even workload mix, uniform "
                "requirement classes, plain diurnal Poisson population.",
    jobs=_JOBS,
    population=PopulationConfig(base_rate=2.0),
    sim=_SIM,
))

register(ScenarioSpec(
    name="baseline_biased",
    description="§5.4 biased mix: half the jobs pinned to the compute-rich "
                "requirement class, the rest uniform.",
    jobs=JobTraceConfig(num_jobs=24, bias="compute_heavy"),
    population=PopulationConfig(base_rate=2.0),
    sim=_SIM,
))

register(ScenarioSpec(
    name="flash_crowd",
    description="Check-in spikes on a quiet population: two flash crowds "
                "(6x for ~8h, 12x for ~3h) mid-week — schedulers must absorb "
                "bursts without starving the off-peak queue.",
    jobs=_JOBS,
    population=PopulationConfig(base_rate=0.8),
    sim=_SIM,
    rate_spikes=(RateSpike(start=0.30, stop=0.35, multiplier=6.0),
                 RateSpike(start=0.70, stop=0.72, multiplier=12.0)),
))

register(ScenarioSpec(
    name="diurnal_timezones",
    description="Three device regions 8h apart: the diurnal peak flattens "
                "and shifts, stressing the 24h-window supply estimate.",
    jobs=_JOBS,
    population=PopulationConfig(base_rate=2.0, diurnal_amplitude=0.9),
    sim=_SIM,
    diurnal_phases=(0.0, 8 * 3600.0, 16 * 3600.0),
))

register(ScenarioSpec(
    name="churn_storm",
    description="Correlated failures: two storm windows where 50% / 80% of "
                "participating devices drop their task (bad rollout, backend "
                "outage) — rounds must survive via quorum + retry.",
    jobs=_JOBS,
    population=PopulationConfig(base_rate=2.0),
    sim=_SIM,
    failure_storms=(FailureStorm(start=0.25, stop=0.35, fail_prob=0.5),
                    FailureStorm(start=0.60, stop=0.65, fail_prob=0.8)),
))

register(ScenarioSpec(
    name="capacity_drift",
    description="Fleet upgrade mid-run: device cpu/mem medians ramp 2.5x/2x "
                "between 20% and 80% of the horizon, migrating supply from "
                "the general atom into the high-performance one.",
    jobs=_JOBS,
    population=PopulationConfig(base_rate=2.0),
    sim=_SIM,
    capacity_drift=CapacityDrift(start=0.2, stop=0.8,
                                 cpu_factor=2.5, mem_factor=2.0),
))

register(ScenarioSpec(
    name="priority_tenants",
    description="Three tenant tiers (gold 20% / silver 30% / bronze 50%) "
                "with 4x/2x/1x scheduling weights; reports per-tenant JCT.",
    jobs=_JOBS,
    population=PopulationConfig(base_rate=2.0),
    sim=_SIM,
    tenant_tiers=(TenantTier(name="gold", fraction=0.2, priority=4.0),
                  TenantTier(name="silver", fraction=0.3, priority=2.0),
                  TenantTier(name="bronze", fraction=0.5, priority=1.0)),
))

register(ScenarioSpec(
    name="hot_atom",
    description="All jobs pinned to the high-performance requirement class: "
                "a single contended atom, zero intersection slack — the IRS "
                "degenerates to pure intra-group ordering.",
    jobs=JobTraceConfig(num_jobs=24, demand_hi=300),
    population=PopulationConfig(base_rate=2.0),
    sim=_SIM,
    pin_requirement="high_performance",
))

register(ScenarioSpec(
    name="blackout_storm",
    description="Correlated blackouts beyond iid churn: two outage windows "
                "mass-drop check-ins AND revoke in-flight responses (devices "
                "go dark mid-task); adaptive overcommit (§3) re-provisions "
                "retried rounds from the observed failure rate.",
    jobs=_JOBS,
    population=PopulationConfig(base_rate=2.0),
    sim=SimConfig(max_time=WEEK, adaptive_overcommit=True),
    # windows sit early in the horizon (jobs drain the queue well before the
    # hard stop — the horizon is a safety bound, not the busy period)
    fault_plan=FaultPlan(
        blackouts=(Blackout(start=0.010, stop=0.022, drop_prob=0.9),
                   Blackout(start=0.035, stop=0.045, drop_prob=1.0)),
        seed=7),
))

register(ScenarioSpec(
    name="flaky_ingest",
    description="A lossy, reordering ingest path: flaky chunk reads with "
                "retry+backoff, chunk drop/dup/reorder, clock-skewed late "
                "check-ins, and NaN-corrupted speed readings the matcher "
                "must degrade around, not crash on.",
    jobs=_JOBS,
    population=PopulationConfig(base_rate=2.0),
    sim=_SIM,
    fault_plan=FaultPlan(
        chunk_chaos=ChunkChaos(drop_prob=0.02, dup_prob=0.15,
                               reorder_prob=0.15, corrupt_speed_prob=0.01),
        clock_skew=ClockSkew(fraction=0.05, max_skew=1800.0),
        flaky_ingest=FlakyIngest(fail_prob=0.25, max_retries=6, backoff=2.0),
        seed=11),
))

register(ScenarioSpec(
    name="long_tail_stragglers",
    description="30% of devices slowed 6x beyond the log-normal speed noise: "
                "a heavy straggler tail that stresses tier-based matching "
                "and deadline survival.",
    jobs=_JOBS,
    population=PopulationConfig(base_rate=2.0, speed_noise_sigma=0.4),
    sim=_SIM,
    speed_tail=SpeedTail(fraction=0.3, factor=1 / 6.0),
))
