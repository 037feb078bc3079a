"""Check-in hot-path throughput & end-to-end wall-clock, on the port.

The counterpart of the reference's ``benchmarks/bench_hotpath.py``, row for
row, with its keys, row names and sizing (``REPRO_BENCH_FAST=1`` skips the
heavy and tenx rows and shrinks the churn, breakdown and audit rows, as
there).  Every VENN scheduler and simulator here is built on ``device``
(``main(device=None)`` is ``cuda:0`` and an error without a card; ``"cpu"``
the host path): the per-device-loop rows (profiled, medium, heavy,
``replan_breakdown``, ``audit_overhead``) resort VENN's array replan with
``segmented_order`` on it, and the array-drain rows (``tenx``'s array leg,
``replan_r500_j2000``, ``fault_sweep``) match with ``match_segment`` there
too.  Each row keeps the reference's engine, so a history series keeps the
meaning of the reference's series of the same name.  The audit row adds a
statistic of its own, the median of alternating pairs' wall ratios, and its
history goes under a series of its own, ``audit_overhead_paired``.

    python -m repro_torch.benchmarks.bench_hotpath [--device D]

The reference's description of the rows follows.

Measures the vectorized fast path (interned atoms + compiled dispatch plans +
struct-of-arrays device streams) end to end:

* the profiled workload (50 jobs, 30 days, base_rate 1.5) that the
  reference's pre-change scan path ran in ~10.5-11s on its CPU host (21.7s
  on another profiling machine); its bar: <= 4.3s;
* a medium-traffic scenario (base_rate 15, 100 jobs);
* a heavy-traffic scenario (base_rate 50, 200 jobs) that the scan path could
  not afford at all — acceptance: completes in under 60s;
* a **10x-traffic row** (base_rate 500 ~= 43M check-ins/day, a 2000-job trace
  contending for a scarce high-performance tier, a quarter simulated day) run
  under BOTH drain engines: the per-device ``checkin`` loop and the
  ``repro_torch.accel`` array engine.  Reports end-to-end wall plus the isolated
  check-in-loop time (``drain_seconds - stream_seconds``, i.e. excluding the
  engine-independent chunk sampling/classification) — acceptance: metrics
  identical and the array loop >= 3x faster than the per-device loop.

Also times the fault-injection sweep (``blackout_storm``/``flaky_ingest`` vs
the fault-free baseline) so resilience features stay accountable on the hot
path, and a ``replan_breakdown`` row (from :mod:`repro_torch.obs` spans,
category ``sched``) quantifying the replan cost split by sub-phase.

Also an ``audit_overhead`` row: the profiled workload with the
:mod:`repro_torch.obs.audit` flight recorder enabled vs. disabled — metrics must
stay bit-identical and the wall-clock overhead under 5%.

Each scenario reports wall-clock (best of ``reps``), scheduler check-in
rates, and Venn's avg JCT; results are merged into
``BENCH_torch_hotpath.json`` in ``REPRO_BENCH_OUT`` (default: the repo root;
merge, not overwrite: FAST runs skip the expensive rows and must not wipe
them), and the headline numbers are *appended* to
``BENCH_torch_history.jsonl`` there, keyed by commit + workload + host — the
append-only series ``python -m repro_torch.benchmarks.regress`` checks
tolerance bands against.  The reference's ``BENCH_hotpath.json`` and
``BENCH_history.jsonl`` are never written.

Rate keys: ``seen_per_sec`` counts check-ins the scheduler actually examined;
``total_per_sec`` additionally counts liveness-bitmap/idle skips.  (The old
``checkins_per_sec`` alias — which equaled ``total_per_sec`` and inflated
the headline rate with skips — is no longer emitted.)
"""
from __future__ import annotations

import json
import os
import platform
import statistics
import subprocess
import time
from contextlib import nullcontext
from pathlib import Path

import tempfile

from .common import FAST, cli, emit
from .. import obs
from ..core import SCHEDULERS
from ..device import resolve_device
from ..obs.summarize import span_stats
from ..scenarios import fast_scaled, get_scenario, run_one
from ..sim import JobTraceConfig, PopulationConfig, SimConfig, generate_jobs
from ..sim.devices import REQ_HIGHPERF
from ..sim.simulator import Simulator

# the repo root (this module sits at src/repro_torch/benchmarks/): where the
# outputs go by default and where the commit is read
ROOT = Path(__file__).resolve().parents[3]

# The reference's constants, kept so that the keys derived from them exist
# and the port's history series stay self-consistent.  They are walls of the
# REFERENCE package on its own CPU host (the profiled workload on its
# pre-change scan path, 10.46s there and 21.7s on another profiling machine;
# the full replan_r500_j2000 `venn.replan` span total before its array
# replan), not of the port, the card or the card's host: a ratio against
# them is no speedup of the port.
SEED_BASELINE_WALL_S = 10.46
ISSUE_BASELINE_WALL_S = 21.7
SEED_REPLAN_WALL_S = 1.031

# interleaved audit-off/on pairs of the audit row's paired median, after
# the reference's 5 / 4 (see ``_audit_overhead_row``): about 70 s of runs
# at FAST sizing on the card's host, 80 s at full
AUDIT_PAIRS = {True: 60, False: 20}

SCENARIOS = [
    # (label, base_rate, num_jobs, days, reps)
    ("profiled_r1.5_j50", 1.5, 50, 30, 1 if FAST else 3),
    ("medium_r15_j100", 15.0, 100, 30, 1),
    ("heavy_r50_j200", 50.0, 200, 30, 1),
]


def run_scenario(base_rate: float, num_jobs: int, days: int, seed: int = 1,
                 device=None):
    dev = resolve_device(device)
    jobs = generate_jobs(JobTraceConfig(num_jobs=num_jobs, seed=seed))
    sched = SCHEDULERS["venn"](seed=seed, device=dev)
    pop = PopulationConfig(seed=1000 + seed, base_rate=base_rate)
    sim = Simulator(jobs, sched, pop, SimConfig(max_time=days * 24 * 3600.0),
                    device=dev)
    t0 = time.time()
    metrics = sim.run()
    wall = time.time() - t0
    total = sim.checkins_seen + sim.checkins_skipped
    return {
        "wall_s": wall,
        "avg_jct_s": metrics.avg_jct,
        "unfinished": metrics.unfinished,
        "checkins_seen": sim.checkins_seen,
        "checkins_skipped": sim.checkins_skipped,
        "seen_per_sec": sim.checkins_seen / wall,
        "total_per_sec": total / wall,
        "sched_invocations": sched.sched_invocations,
    }


def _tenx_jobs(seed: int = 1):
    """2000 jobs contending for the scarce high-performance tier."""
    jobs = generate_jobs(JobTraceConfig(num_jobs=2000, seed=seed,
                                        mean_interarrival=60.0))
    for j in jobs:
        j.requirement = REQ_HIGHPERF
    return jobs


def run_tenx(engine: str, seed: int = 1, device=None):
    """One 10x-traffic run: base_rate 500 against a capability-poor
    population (the pinned tier is ~0.3% of traffic), a quarter of a
    simulated day (~15M check-ins).  The regime Venn's contention
    heuristic targets: a persistently open scarce tier under platform-scale
    background traffic."""
    dev = resolve_device(device)
    sched = SCHEDULERS["venn"](seed=seed, device=dev)
    pop = PopulationConfig(seed=1000 + seed, base_rate=500.0,
                           cpu_med=1.8, mem_med=1.8)
    sim = Simulator(_tenx_jobs(seed), sched, pop,
                    SimConfig(max_time=0.25 * 24 * 3600.0), engine=engine,
                    device=dev)
    # metrics-only obs session (tracing stays off — a 15M-check-in run's
    # span volume would perturb the row it measures): the registry counters
    # are the stopwatch source, and the decision-latency histogram rides
    # along for free
    with obs.session(tracing=False, metrics=True) as (_, reg):
        t0 = time.time()
        metrics = sim.run()
        wall = time.time() - t0
        drain_s = reg.counter("sim.drain_wall_s").value
        stream_s = reg.counter("sim.stream_wall_s").value
        lat = reg.get("sim.decision_latency_s")
        lat_p50 = lat.percentile(50) if lat is not None else float("nan")
        lat_p99 = lat.percentile(99) if lat is not None else float("nan")
    return {
        "wall_s": wall,
        # the check-in loop proper: drain time minus the engine-independent
        # chunk sampling/classification that happens inside it (engine-side
        # mirror conversion is attributed to the loop).  Sourced from the
        # obs registry counters — same quantities the old ad-hoc
        # drain_seconds/stream_seconds stopwatches tracked.
        "checkin_loop_s": drain_s - stream_s,
        "stream_s": stream_s,
        "decision_latency_p50_us": lat_p50 * 1e6,
        "decision_latency_p99_us": lat_p99 * 1e6,
        # avg JCT is censoring-dominated here (most of the 2000-job trace
        # arrives beyond the bounded horizon); completed rounds is the
        # meaningful progress number
        "rounds_completed": len(metrics.rounds),
        "checkins": sim.checkins_seen + sim.checkins_skipped,
    }, metrics


def _tenx_row(reps: int, device=None):
    """python-engine vs array-engine comparison on the 10x workload."""
    row = {}
    metrics = {}
    for engine in ("python", "array"):
        best = None
        for _ in range(reps):
            r, m = run_tenx(engine, device=device)
            metrics[engine] = m
            if best is None or r["checkin_loop_s"] < best["checkin_loop_s"]:
                best = r
        row[engine] = best
    assert metrics["python"].jcts == metrics["array"].jcts, \
        "array engine must be metric-identical to the per-device loop"
    assert metrics["python"].rounds == metrics["array"].rounds
    row["metrics_identical"] = True
    row["loop_speedup"] = round(
        row["python"]["checkin_loop_s"] / row["array"]["checkin_loop_s"], 2)
    row["e2e_speedup"] = round(
        row["python"]["wall_s"] / row["array"]["wall_s"], 2)
    row["meets_3x_loop_target"] = row["loop_speedup"] >= 3.0
    emit("hotpath_tenx_r500_j2000", row["array"]["wall_s"] * 1e6,
         f"loop={row['loop_speedup']}x e2e={row['e2e_speedup']}x "
         f"identical=True")
    return row


def _replan_breakdown_row(seed: int = 1, device=None):
    """Replan cost split from obs spans.

    Runs the profiled workload with tracing restricted to the ``sched``
    category (replan spans only — the drain hot path stays uninstrumented at
    that granularity, and the filter bounds trace memory) and aggregates the
    ``venn.replan.*`` sub-phase spans: how much wall goes to replans at all,
    and of that, how much to supply refresh vs. IRS vs. tier decisions vs.
    plan lowering.  The split is the prioritization signal for making the
    replan array-native."""
    base_rate, num_jobs, days = (1.5, 20, 10) if FAST else (1.5, 50, 30)
    dev = resolve_device(device)
    jobs = generate_jobs(JobTraceConfig(num_jobs=num_jobs, seed=seed))
    sched = SCHEDULERS["venn"](seed=seed, device=dev)
    pop = PopulationConfig(seed=1000 + seed, base_rate=base_rate)
    sim = Simulator(jobs, sched, pop,
                    SimConfig(max_time=days * 24 * 3600.0), device=dev)
    with obs.session(tracing=True, metrics=True,
                     categories={"sched"}) as (tr, reg):
        t0 = time.time()
        sim.run()
        wall = time.time() - t0
        stats = span_stats(tr.events)
        hist = reg.get("venn.replan_wall_s")
    replan = stats.get("venn.replan", {"count": 0, "total_us": 0.0})
    total_s = replan["total_us"] / 1e6
    phases_s = {
        ph: stats.get(f"venn.replan.{ph}", {"total_us": 0.0})["total_us"] / 1e6
        for ph in ("supply", "irs", "tiers", "compile")
    }
    row = {
        "wall_s": wall,
        "replans": replan["count"],
        "replan_total_s": round(total_s, 4),
        "replan_frac_of_wall": round(total_s / wall, 4) if wall else 0.0,
        "p50_replan_s": hist.percentile(50) if hist is not None else None,
        "p99_replan_s": hist.percentile(99) if hist is not None else None,
        "phases_s": {k: round(v, 4) for k, v in phases_s.items()},
        "phase_frac": {k: round(v / total_s, 3) if total_s else 0.0
                       for k, v in phases_s.items()},
    }
    emit("hotpath_replan_breakdown", total_s * 1e6,
         f"replans={row['replans']} frac_of_wall={row['replan_frac_of_wall']} "
         + " ".join(f"{k}={row['phase_frac'][k]}" for k in phases_s))
    return row


def _replan_churn_row(seed: int = 1, device=None):
    """``replan_r500_j2000``: the replan-bound churn workload.

    The 10x-traffic setup — 2000 jobs churning through rounds against the
    scarce high-performance tier — is replan-bound on the scheduler side:
    every arrival/completion dirties the plan and the next check-in pays a
    full VENN-SCHED run.  This row runs it under BOTH replan backends
    (``replan="scalar"``: reference ``venn_schedule`` + ``compile_plan``;
    ``replan="array"``: the incremental :mod:`repro_torch.accel.replan`
    engine) on the array drain engine with ``sched``-category tracing,
    isolating
    ``venn.replan`` span totals.  Acceptance: bit-identical ``SimMetrics``
    and ``replan_speedup >= 1.8``.  FAST runs a scaled variant (same series
    name, separate ``fast`` series in the regress gate)."""
    dev = resolve_device(device)
    if FAST:
        base_rate, num_jobs, days = 100.0, 300, 0.05
    else:
        base_rate, num_jobs, days = 500.0, 2000, 0.25
    # (label, replan backend, MatchState mirror maintenance) — the third leg
    # re-runs the array side with REPRO_MATCH_DELTA=0 as the full-rebuild
    # mirror baseline of ``mirror_speedup``.
    legs = (("scalar", "scalar", True), ("array", "array", True),
            ("array_full", "array", False))
    reps = 1 if FAST else 2   # best-of: single-run wall clock is noisy
    sides, mets = {}, {}
    for label, mode, delta in legs:
        best = None
        for _ in range(reps):
            jobs = generate_jobs(JobTraceConfig(num_jobs=num_jobs, seed=seed,
                                                mean_interarrival=60.0))
            for j in jobs:
                j.requirement = REQ_HIGHPERF
            sched = SCHEDULERS["venn"](seed=seed, replan=mode, device=dev)
            pop = PopulationConfig(seed=1000 + seed, base_rate=base_rate,
                                   cpu_med=1.8, mem_med=1.8)
            # read by the array engine when Simulator builds it
            prev_delta = os.environ.get("REPRO_MATCH_DELTA")
            os.environ["REPRO_MATCH_DELTA"] = "1" if delta else "0"
            try:
                sim = Simulator(jobs, sched, pop,
                                SimConfig(max_time=days * 24 * 3600.0),
                                engine="array", device=dev)
                with obs.session(tracing=True, metrics=True,
                                 categories={"sched"}) as (tr, reg):
                    t0 = time.time()
                    mets[label] = sim.run()
                    wall = time.time() - t0
                    stats = span_stats(tr.events)
            finally:
                if prev_delta is None:
                    os.environ.pop("REPRO_MATCH_DELTA", None)
                else:
                    os.environ["REPRO_MATCH_DELTA"] = prev_delta
            rep = stats.get("venn.replan", {"count": 0, "total_us": 0.0})
            total_s = rep["total_us"] / 1e6
            eng = sim.engine
            run = {
                "wall_s": wall,
                "replans": rep["count"],
                "replan_wall_s": round(total_s, 4),
                "replans_per_sec": round(rep["count"] / total_s, 1)
                if total_s else 0.0,
                "state_rebuilds": eng.rebuilds,
                "state_patches": eng.patches,
                # combined accel.state_rebuild + accel.state_delta wall
                "state_mirror_s": round(eng.rebuild_s + eng.patch_s, 4),
            }
            if best is None:
                best = run
            else:
                # per-metric best across reps: counts are identical run to
                # run (deterministic sim), timings keep the least-noisy rep
                for k in ("wall_s", "replan_wall_s", "state_mirror_s"):
                    best[k] = min(best[k], run[k])
                best["replans_per_sec"] = max(best["replans_per_sec"],
                                              run["replans_per_sec"])
        sides[label] = best
    assert mets["scalar"].jcts == mets["array"].jcts, \
        "incremental replan must be metric-identical to the scalar path"
    assert mets["scalar"].rounds == mets["array"].rounds
    assert mets["array"].jcts == mets["array_full"].jcts, \
        "delta-patched mirror must be metric-identical to full rebuild"
    assert mets["array"].rounds == mets["array_full"].rounds
    arr = sides["array"]["replan_wall_s"]
    vs_scalar = round(sides["scalar"]["replan_wall_s"] / arr, 2) \
        if arr else float("inf")
    # the reference's speedup key: the full workload divides the reference's
    # constant (its own pre-change replan wall on its CPU host, see above);
    # the FAST variant has no such constant and uses the in-build ratio — a
    # separate series in the regress gate.  The same-run ratio is
    # ``speedup_vs_scalar``.
    speedup = (round(SEED_REPLAN_WALL_S / arr, 2) if arr else float("inf")) \
        if not FAST else vs_scalar
    # mirror maintenance: delta-patched vs full-rebuild-every-token (the
    # bar: >= 2x on the combined state_rebuild+state_delta wall)
    mirror_s = sides["array"]["state_mirror_s"]
    mirror_full_s = sides["array_full"]["state_mirror_s"]
    mirror_speedup = round(mirror_full_s / mirror_s, 2) \
        if mirror_s else float("inf")
    row = {
        **sides["array"],
        "scalar": sides["scalar"],
        "array_full_rebuild": sides["array_full"],
        "metrics_identical": True,
        "replan_speedup": speedup,
        "speedup_vs_scalar": vs_scalar,
        "meets_1p8x_target": speedup >= 1.8,
        "mirror_full_s": mirror_full_s,
        "mirror_speedup": mirror_speedup,
        "meets_2x_mirror_target": mirror_speedup >= 2.0,
    }
    emit("hotpath_replan_r500_j2000", sides["array"]["replan_wall_s"] * 1e6,
         f"replans={row['replans']} "
         f"replan_wall={row['replan_wall_s']:.2f}s "
         f"speedup={speedup}x mirror_speedup={mirror_speedup}x "
         f"patches={row['state_patches']} rebuilds={row['state_rebuilds']} "
         f"identical=True")
    return row


def _scenario_replay_row(device=None):
    """Scenario-engine timing: record one flash_crowd run, time its replay.

    Tracks the trace-replay path (streamed CSV ingest feeding the simulator)
    alongside the synthetic-generator numbers above."""
    spec = get_scenario("flash_crowd")
    if FAST:
        spec = fast_scaled(spec)
    with tempfile.NamedTemporaryFile(suffix=".csv", delete=False) as f:
        trace = f.name
    try:
        rec = run_one(spec, "venn", seed=0, record=trace, device=device)
        rep = run_one(spec, "venn", seed=0, replay=trace, device=device)
        assert rec.metrics.jcts == rep.metrics.jcts, \
            "replay must be bit-identical to the recorded run"
        row = {
            "record_wall_s": rec.wall,
            "replay_wall_s": rep.wall,
            "avg_jct_s": rep.metrics.avg_jct,
            "trace_bytes": os.path.getsize(trace),
        }
        emit("hotpath_scenario_replay", rep.wall * 1e6,
             f"record={rec.wall:.2f}s replay={rep.wall:.2f}s "
             f"bit_identical=True")
        return row
    finally:
        os.unlink(trace)


def _fault_sweep_row(device=None):
    """Fault-injection timing: the two faulted scenarios (blackout_storm,
    flaky_ingest) under the array engine vs the fault-free baseline.

    The ratio is a tracking number, not pure injector overhead (the faulted
    scenarios also lose supply and re-provision rounds), but it bounds what
    the fault layer costs the hot path and pins the resilience counters."""
    base_spec = fast_scaled(get_scenario("baseline_even"))
    base = run_one(base_spec, "venn", seed=0, engine="array", device=device)
    row = {"baseline_even_wall_s": base.wall}
    for name in ("blackout_storm", "flaky_ingest"):
        spec = fast_scaled(get_scenario(name))
        r = run_one(spec, "venn", seed=0, engine="array", device=device)
        res = r.metrics.resilience()
        row[name] = {
            "wall_s": r.wall,
            "wall_vs_baseline": round(r.wall / base.wall, 2),
            "dropped_checkins": res["dropped_checkins"],
            "revoked_responses": res["revoked_responses"],
            "degraded_segments": res["degraded_segments"],
            "flaky_retries": res["flaky_retries"],
        }
        emit(f"hotpath_faults_{name}", r.wall * 1e6,
             f"wall={r.wall:.2f}s ({row[name]['wall_vs_baseline']}x base) "
             f"dropped={res['dropped_checkins']} "
             f"revoked={res['revoked_responses']}")
    return row


def _audit_overhead_row(seed: int = 1, device=None):
    """Flight-recorder cost on the profiled workload: audit on vs. off.

    The acceptance bar for :mod:`repro_torch.obs.audit`: enabling the recorder
    must leave ``SimMetrics`` bit-identical and cost <5%.  The overhead
    fraction is computed from CPU time (``time.process_time``) over
    *interleaved* on/off pairs, taking the min of each side: wall-clock on a
    shared machine swings +-15% between back-to-back identical runs, which
    would drown a 5% signal; interleaving shares the machine phase across
    both sides and min-of-reps strips additive noise.

    The port keeps that statistic under the reference's keys and adds one
    of its own, ``paired_overhead_frac``: the median of the wall-clock
    ratios of :data:`AUDIT_PAIRS` more pairs, the side that runs first
    alternating pair to pair.  On the card's host the process clock ticks
    at 10 ms (2.9 % of a FAST run) and identical runs differ by 5-20 %
    from phase to phase, so the min of 5 pairs a side reads above the 5 %
    cap by chance, in either package; a median of pair ratios does not
    depend on which phase each side's fastest run fell in.  The port's
    history gates the paired median, under a series of its own
    (:func:`append_history`)."""
    base_rate, num_jobs, days = (1.5, 20, 10) if FAST else (1.5, 50, 30)
    reps = 5 if FAST else 4
    dev = resolve_device(device)

    def one(audit: bool):
        jobs = generate_jobs(JobTraceConfig(num_jobs=num_jobs, seed=seed))
        sched = SCHEDULERS["venn"](seed=seed, device=dev)
        pop = PopulationConfig(seed=1000 + seed, base_rate=base_rate)
        sim = Simulator(jobs, sched, pop,
                        SimConfig(max_time=days * 24 * 3600.0), device=dev)
        ctx = obs.session(tracing=False, metrics=False, audit=True) \
            if audit else nullcontext()
        with ctx:
            w0 = time.time()
            c0 = time.process_time()
            metrics = sim.run()
            cpu = time.process_time() - c0
            wall = time.time() - w0
            n_rec = len(obs.get_audit().records) if audit else 0
        return wall, cpu, metrics, n_rec

    cpu_best = {False: float("inf"), True: float("inf")}
    wall_best = {False: float("inf"), True: float("inf")}
    summaries = {}
    records = 0
    for _ in range(reps):
        for audit in (False, True):
            wall, cpu, metrics, n_rec = one(audit)
            cpu_best[audit] = min(cpu_best[audit], cpu)
            wall_best[audit] = min(wall_best[audit], wall)
            summaries[audit] = metrics.summary()
            if audit:
                records = n_rec
    ratios = []
    for i in range(AUDIT_PAIRS[FAST]):
        pair = {}
        for audit in (bool(i % 2), not i % 2):
            pair[audit], _, metrics, _ = one(audit)
            assert metrics.summary() == summaries[audit]
        ratios.append(pair[True] / pair[False])
    assert summaries[True] == summaries[False], \
        "audit capture must leave SimMetrics bit-identical"
    frac = cpu_best[True] / cpu_best[False] - 1.0
    paired = statistics.median(ratios) - 1.0
    row = {
        "wall_off_s": wall_best[False],
        "wall_on_s": wall_best[True],
        "cpu_off_s": cpu_best[False],
        "cpu_on_s": cpu_best[True],
        "audit_overhead_frac": round(max(frac, 0.0), 4),
        "audit_records": records,
        "metrics_identical": True,
        "meets_5pct_target": frac < 0.05,
        "paired_overhead_frac": round(paired, 4),
    }
    emit("hotpath_audit_overhead", cpu_best[True] * 1e6,
         f"overhead={row['audit_overhead_frac'] * 100:.1f}% "
         f"records={records} identical=True "
         f"paired={paired * 100:.1f}%")
    return row


# --------------------------------------------------------------------------- #
# perf-regression history (BENCH_torch_history.jsonl, checked by
# repro_torch.benchmarks.regress)
# --------------------------------------------------------------------------- #

def _git_commit() -> str:
    try:
        return subprocess.check_output(
            ["git", "rev-parse", "--short", "HEAD"],
            cwd=ROOT, text=True,
            stderr=subprocess.DEVNULL).strip()
    except Exception:
        return "unknown"


def _bench_host() -> str:
    # absolute wall-clock is only comparable within one machine; the regress
    # checker scopes those metrics by this tag (override for stable CI pools)
    return os.environ.get("REPRO_BENCH_HOST", platform.node() or "unknown")


def append_history(results: dict, out_dir: Path) -> Path:
    """Append this run's headline numbers to the append-only perf series.

    One JSONL row per workload, keyed by commit + host + timestamp — the
    input contract of ``python -m repro_torch.benchmarks.regress``."""
    commit, host, ts = _git_commit(), _bench_host(), time.time()
    rows = []
    for label in ("profiled_r1.5_j50", "medium_r15_j100", "heavy_r50_j200"):
        r = results.get(label)
        if r:
            rows.append((label, {
                k: r[k] for k in ("wall_s", "seen_per_sec", "total_per_sec",
                                  "avg_jct_s") if k in r}))
    tenx = results.get("tenx_r500_j2000")
    if tenx:
        rows.append(("tenx_r500_j2000", {
            "wall_s": tenx["array"]["wall_s"],
            "checkin_loop_s": tenx["array"]["checkin_loop_s"],
            "loop_speedup": tenx["loop_speedup"],
            "e2e_speedup": tenx["e2e_speedup"]}))
    churn = results.get("replan_r500_j2000")
    if churn:
        rows.append(("replan_r500_j2000", {
            "wall_s": churn["wall_s"],
            "replan_wall_s": churn["replan_wall_s"],
            "replans_per_sec": churn["replans_per_sec"],
            "replan_speedup": churn["replan_speedup"],
            "state_mirror_s": churn["state_mirror_s"],
            "mirror_speedup": churn["mirror_speedup"]}))
    audit = results.get("audit_overhead")
    if audit:
        # the paired median, under a series of its own: the reference's
        # ``audit_overhead`` series holds its min-of-pairs statistic, which
        # the port reports (the row's ``audit_overhead_frac``) but does not
        # gate
        rows.append(("audit_overhead_paired", {
            "wall_s": audit["wall_on_s"],
            "audit_overhead_frac": audit["paired_overhead_frac"]}))
    path = out_dir / "BENCH_torch_history.jsonl"
    with open(path, "a") as fh:
        for workload, metrics in rows:
            fh.write(json.dumps({
                "commit": commit, "ts": round(ts, 2), "host": host,
                "fast": FAST, "workload": workload, "metrics": metrics,
            }) + "\n")
    return path


def main(device=None):
    dev = resolve_device(device)
    results = {}
    for label, base_rate, num_jobs, days, reps in SCENARIOS:
        if FAST and base_rate >= 50:
            continue
        best = None
        for _ in range(reps):
            r = run_scenario(base_rate, num_jobs, days, device=dev)
            if best is None or r["wall_s"] < best["wall_s"]:
                best = r
        results[label] = best
        emit(f"hotpath_{label}", best["wall_s"] * 1e6,
             f"wall={best['wall_s']:.2f}s seen_ps={best['seen_per_sec']:.0f} "
             f"jct={best['avg_jct_s']:.0f}s")

    prof = results.get("profiled_r1.5_j50")
    if prof:
        speedup_local = SEED_BASELINE_WALL_S / prof["wall_s"]
        speedup_issue = ISSUE_BASELINE_WALL_S / prof["wall_s"]
        results["speedup_vs_seed_local"] = round(speedup_local, 2)
        results["speedup_vs_issue_baseline"] = round(speedup_issue, 2)
        results["meets_4p3s_target"] = prof["wall_s"] <= 4.3
        emit("hotpath_speedup", 0,
             f"local={speedup_local:.2f}x issue={speedup_issue:.2f}x "
             f"under_4.3s={prof['wall_s'] <= 4.3}")
    heavy = results.get("heavy_r50_j200")
    if heavy:
        results["heavy_under_60s"] = heavy["wall_s"] < 60.0
        emit("hotpath_heavy_validates", 0,
             f"under_60s={heavy['wall_s'] < 60.0}")

    if not FAST:
        results["tenx_r500_j2000"] = _tenx_row(reps=3, device=dev)

    results["replan_r500_j2000"] = _replan_churn_row(device=dev)
    results["replan_breakdown"] = _replan_breakdown_row(device=dev)
    results["scenario_replay_flash_crowd"] = _scenario_replay_row(device=dev)
    results["fault_sweep"] = _fault_sweep_row(device=dev)
    results["audit_overhead"] = _audit_overhead_row(device=dev)

    out = Path(os.environ.get("REPRO_BENCH_OUT", ROOT))
    out.mkdir(parents=True, exist_ok=True)
    out_path = out / "BENCH_torch_hotpath.json"
    # merge into the existing report: FAST runs skip the expensive rows
    # (tenx, heavy) and must not wipe them from the tracked file
    merged = {}
    if out_path.exists():
        try:
            merged = json.loads(out_path.read_text())
        except ValueError:
            merged = {}
    # drop the deprecated alias wherever a previous run left it
    for row in merged.values():
        if isinstance(row, dict):
            row.pop("checkins_per_sec", None)
    merged.update(results)
    out_path.write_text(json.dumps(merged, indent=2))
    hist = append_history(results, out)
    emit("hotpath_history", 0,
         f"appended to {hist.name} "
         "(check: python -m repro_torch.benchmarks.regress)")
    return results


if __name__ == "__main__":
    cli(main)
