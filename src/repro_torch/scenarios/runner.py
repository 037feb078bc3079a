"""Scenario runner + report layer.

Executes a scenario across schedulers and seeds and renders a JCT /
scheduling-delay / response-collection comparison table — the evaluation
surface scaling PRs are measured on.  Also the home of ``--fast`` scaling
(shrunk horizons/job counts for smoke runs; window *fractions* keep the
scenario's shape) and of trace record/replay orchestration.
"""
from __future__ import annotations

import time
from contextlib import nullcontext
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Sequence

import numpy as np

from .. import obs
from ..core import SCHEDULERS, VennScheduler
from ..core.types import Job
from ..device import resolve_device
from ..faults.injector import FaultInjector
from ..obs.metrics import NULL_REGISTRY
from ..obs.timeline import timeline_records
from ..obs.trace import NULL_TRACER
from ..sim.metrics import SimMetrics
from ..sim.simulator import Simulator
from .spec import ScenarioSpec, get_scenario
from .streams import build_jobs, build_stream
from .trace_io import RecordingStream, TraceReplayStream

DEFAULT_SCHEDS = ("venn", "random")

# --fast sizing (also what REPRO_BENCH_FAST-sized tests use): small enough
# that every registered scenario runs in a few seconds, big enough that the
# scenario's stress pattern still materializes.
FAST_NUM_JOBS = 8
FAST_MAX_TIME = 2.5 * 24 * 3600.0
FAST_DEMAND_HI = 120
FAST_ROUNDS_HI = 8


@dataclass
class RunResult:
    scenario: str
    scheduler: str
    seed: int
    metrics: SimMetrics
    wall: float
    jobs: List[Job] = field(repr=False, default_factory=list)
    # the finished simulator, for its drain counters (check-ins, loop and
    # stream seconds, the array engine's matcher calls and degradations)
    sim: Optional[Simulator] = field(repr=False, default=None)


def fast_scaled(spec: ScenarioSpec) -> ScenarioSpec:
    """Shrink a scenario for smoke runs, preserving its shape."""
    return replace(
        spec,
        jobs=replace(spec.jobs,
                     num_jobs=min(spec.jobs.num_jobs, FAST_NUM_JOBS),
                     demand_hi=min(spec.jobs.demand_hi, FAST_DEMAND_HI),
                     rounds_hi=min(spec.jobs.rounds_hi, FAST_ROUNDS_HI)),
        sim=replace(spec.sim, max_time=min(spec.sim.max_time, FAST_MAX_TIME)),
    )


def run_one(spec: ScenarioSpec, sched_name: str, seed: int,
            record: Optional[str] = None,
            replay: Optional[str] = None,
            engine: Optional[str] = None,
            device=None) -> RunResult:
    """One (scenario, scheduler, seed) simulation.

    ``record`` dumps this run's device stream to a trace file; ``replay``
    substitutes a trace file for the scenario's synthetic stream (the job
    side still comes from the spec).  ``engine`` selects the simulator's
    drain engine (``"python"`` scalar loop or ``"array"`` batched matching —
    identical metrics, different wall-clock).  ``device`` is where the array
    engine's mirror and matcher and VENN's replan resort run, on either
    engine: ``None`` is ``cuda:0`` (an error without a card), ``"cpu"`` the
    host path; the baselines run on the host whatever it says."""
    device = resolve_device(device)
    jobs = build_jobs(spec, seed)
    plan = spec.fault_plan.resolve(spec.sim.max_time) \
        if spec.fault_plan is not None else None
    if replay is not None:
        # seed drives synthesized randomness for traces that omit the
        # resp_z/fail_u columns; recorded traces carry them and ignore it
        stream = TraceReplayStream(replay, seed=seed)
        # no injector on replay: a trace recorded under this scenario
        # already embeds the stream-side faults (recording sits outside the
        # injector), so re-wrapping would apply them twice.  The simulator
        # still takes the plan for blackout response revocation, which is
        # not a stream artifact — record→replay stays bit-identical.
    else:
        stream = build_stream(spec, seed)
        if plan is not None and not plan.is_empty:
            stream = FaultInjector(stream, plan)
    if record is not None:
        stream = RecordingStream(stream, record)
    cls = SCHEDULERS[sched_name]
    sched = cls(seed=seed, device=device) \
        if issubclass(cls, VennScheduler) else cls(seed=seed)
    sim = Simulator(jobs, sched, cfg=spec.sim, stream=stream, engine=engine,
                    faults=plan, device=device)
    t0 = time.time()
    try:
        metrics = sim.run()
    finally:
        # recorder: drain + flush even if the sim stopped early; replay:
        # release the trace file handle if rows remained unread
        close = getattr(stream, "close", None)
        if close is not None:
            close()
    wall = time.time() - t0
    return RunResult(scenario=spec.name, scheduler=sched_name, seed=seed,
                     metrics=metrics, wall=wall, jobs=jobs, sim=sim)


def run_scenario(spec_or_name, scheds: Sequence[str] = DEFAULT_SCHEDS,
                 seeds: Sequence[int] = (0,), fast: bool = False,
                 record: Optional[str] = None,
                 replay: Optional[str] = None,
                 engine: Optional[str] = None,
                 trace_out: Optional[str] = None,
                 metrics_out: Optional[str] = None,
                 audit_out: Optional[str] = None,
                 grant_sample: Optional[int] = None,
                 device=None) -> List[RunResult]:
    """Run a scenario across schedulers × seeds.

    With ``record``, the first scheduler's run is recorded.  The device
    stream depends only on (scenario, seed) — schedulers share it — and the
    recorder drains the stream to the full horizon on close, so one trace
    faithfully represents every scheduler *at that seed*.  Different seeds
    draw different device streams, so recording is limited to single-seed
    runs.

    ``trace_out``/``metrics_out`` turn on :mod:`repro_torch.obs` for the whole
    sweep: ``trace_out`` writes a Perfetto-loadable Chrome trace-event JSON
    (one ``run:<scenario>:<sched>:s<seed>`` span bracketing each run);
    ``metrics_out`` writes a metrics JSONL (histograms/counters plus
    ``kind="timeline"`` per-job JCT-decomposition records).
    ``audit_out`` writes the scheduler flight-recorder JSONL (replan
    snapshots, sampled grant audit, queue-position history; render with
    ``python -m repro_torch.obs contention|audit``) — the stream carries no
    engine- or wall-clock-dependent fields, so it is byte-identical across
    drain engines (``replan_budget_s`` stale serving excepted).
    Observability never changes simulation outcomes — metrics stay
    bit-identical.  ``device`` is :func:`run_one`'s; the runs go one after
    another on the calling thread (calls on one device share its pinned
    transfer stage, so they must not overlap)."""
    spec = get_scenario(spec_or_name) if isinstance(spec_or_name, str) \
        else spec_or_name
    if record is not None and len(seeds) > 1:
        raise ValueError("--record with multiple seeds is ambiguous: each "
                         "seed draws its own device stream; record one seed "
                         "at a time")
    if fast:
        spec = fast_scaled(spec)
    obs_on = (trace_out is not None or metrics_out is not None
              or audit_out is not None)
    audit_kw = {} if grant_sample is None else {"grant_sample": grant_sample}
    ctx = obs.session(tracing=trace_out is not None,
                      metrics=metrics_out is not None,
                      audit=audit_out is not None, **audit_kw) if obs_on \
        else nullcontext((NULL_TRACER, NULL_REGISTRY))
    results: List[RunResult] = []
    tl_records: List[dict] = []
    with ctx as (tr, reg):
        aud = obs.get_audit()
        first = True
        for sched_name in scheds:
            for seed in seeds:
                tok = tr.begin(f"run:{spec.name}:{sched_name}:s{seed}",
                               cat="run") if tr.enabled else None
                if aud.enabled:
                    aud.begin_run(scenario=spec.name, scheduler=sched_name,
                                  seed=seed)
                r = run_one(
                    spec, sched_name, seed,
                    record=record if first else None, replay=replay,
                    engine=engine, device=device)
                if tok is not None:
                    tr.end(tok, wall_s=r.wall)
                results.append(r)
                first = False
                if metrics_out is not None:
                    tl_records.extend(timeline_records(
                        r.metrics, scenario=spec.name, scheduler=sched_name,
                        seed=seed))
        # export inside the session — exiting drops unexported state
        if trace_out is not None:
            tr.write(trace_out)
        if metrics_out is not None:
            reg.write_jsonl(metrics_out, mode="w", extra=tl_records)
        if audit_out is not None:
            aud.write_jsonl(audit_out, mode="w")
    return results


# --------------------------------------------------------------------------- #
# Reporting
# --------------------------------------------------------------------------- #

def _tenant_jcts(r: RunResult) -> Dict[str, float]:
    by_tenant: Dict[str, List[float]] = {}
    for j in r.jobs:
        by_tenant.setdefault(j.tenant, []).append(r.metrics.jcts[j.job_id])
    return {t: float(np.mean(v)) for t, v in sorted(by_tenant.items())}


def comparison_table(results: List[RunResult]) -> str:
    """Render a per-scheduler comparison (seeds averaged) for one scenario."""
    by_sched: Dict[str, List[RunResult]] = {}
    for r in results:
        by_sched.setdefault(r.scheduler, []).append(r)
    header = (f"{'scheduler':<10} {'avg_jct_s':>10} {'p99_jct_s':>10} "
              f"{'sched_delay_s':>13} {'p99_delay_s':>11} "
              f"{'resp_coll_s':>11} {'aborts':>6} {'failed':>6} "
              f"{'unfin':>5} {'wall_s':>7}")
    lines = [header, "-" * len(header)]
    for name, runs in by_sched.items():
        jct = float(np.mean([r.metrics.avg_jct for r in runs]))
        p99j = float(np.mean([r.metrics.p99_jct for r in runs]))
        sd = float(np.mean([r.metrics.avg_scheduling_delay for r in runs]))
        p99d = float(np.mean([r.metrics.p99_scheduling_delay for r in runs]))
        rc = float(np.mean([r.metrics.avg_response_collection for r in runs]))
        ab = float(np.mean([r.metrics.aborts for r in runs]))
        fr = float(np.mean([r.metrics.failed_rounds for r in runs]))
        un = float(np.mean([r.metrics.unfinished for r in runs]))
        wall = float(np.mean([r.wall for r in runs]))
        lines.append(f"{name:<10} {jct:>10.0f} {p99j:>10.0f} {sd:>13.0f} "
                     f"{p99d:>11.0f} {rc:>11.0f} "
                     f"{ab:>6.1f} {fr:>6.1f} {un:>5.1f} {wall:>7.2f}")
    scheds = list(by_sched)
    if len(scheds) > 1:
        ref = scheds[-1]
        ref_jct = float(np.mean([r.metrics.avg_jct for r in by_sched[ref]]))
        for name in scheds[:-1]:
            jct = float(np.mean([r.metrics.avg_jct for r in by_sched[name]]))
            if jct > 0:
                lines.append(f"speedup {name} vs {ref}: {ref_jct / jct:.2f}x")
    # resilience breakdown when any fault/recovery counter fired
    res_keys = [k for k in (results[0].metrics.resilience() if results else {})
                if k != "submitted_rounds"]
    if any(r.metrics.resilience()[k] for r in results for k in res_keys):
        lines.append("")
        lines.append(f"{'scheduler':<10} " + " ".join(
            f"{k:>18}" for k in res_keys))
        for name, runs in by_sched.items():
            vals = [float(np.mean([r.metrics.resilience()[k] for r in runs]))
                    for k in res_keys]
            lines.append(f"{name:<10} " + " ".join(
                f"{v:>18.1f}" for v in vals))
    # per-tenant breakdown when the scenario tags tenants
    tenants = {t for r in results for t in _tenant_jcts(r)}
    if tenants != {"default"}:
        lines.append("")
        lines.append(f"{'scheduler':<10} " + " ".join(
            f"{t + '_jct_s':>12}" for t in sorted(tenants)))
        for name, runs in by_sched.items():
            per: Dict[str, List[float]] = {}
            for r in runs:
                for t, v in _tenant_jcts(r).items():
                    per.setdefault(t, []).append(v)
            lines.append(f"{name:<10} " + " ".join(
                f"{float(np.mean(per.get(t, [float('nan')]))):>12.0f}"
                for t in sorted(tenants)))
    return "\n".join(lines)
