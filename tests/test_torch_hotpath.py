"""The port's hot-path rows (``repro_torch.benchmarks.bench_hotpath``)
against the reference's ``benchmarks/bench_hotpath.py``, row by row.

Both modules run at one reduced sizing a test, by the names they import
only (``torch_parity.shrink_hotpath``: ``FAST``, ``SCENARIOS``,
``JobTraceConfig``, ``PopulationConfig``, ``SimConfig``); the port with
``device="cpu"``.  Every deterministic value is equal — JCTs, check-in,
replan, round and mirror counts, trace bytes, fault counters, audit records,
``metrics_identical`` — and the timings are masked
(``torch_parity.hotpath_masked``), as is ``degraded_segments`` with its
reason.  Each row keeps the reference's engine: the per-device loop for the
scenario and breakdown rows (and the audit row,
``test_torch_hotpath_fast.py``), both engines for ``tenx``, the array drain
for the churn row and the fault sweep.
"""
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from torch_parity import hotpath_both as both  # noqa: E402
from torch_parity import hotpath_masked, shrink_hotpath  # noqa: E402

DAY = 24 * 3600.0


@pytest.mark.parametrize("label", ["profiled_r1.5_j50", "medium_r15_j100",
                                   "heavy_r50_j200"])
def test_scenario_row_equals_reference(label, monkeypatch):
    ref, port = shrink_hotpath(monkeypatch, False, jobs=12, rate=50.0,
                               horizon=DAY / 2)
    row = dict((r[0], r[1:4]) for r in port.SCENARIOS)[label]
    assert row == dict((r[0], r[1:4]) for r in ref.SCENARIOS)[label]
    want, got, _, _ = both(ref.run_scenario, port.run_scenario, *row)
    assert hotpath_masked(got) == hotpath_masked(want)
    assert got["avg_jct_s"] == want["avg_jct_s"] > 0
    assert got["checkins_seen"] > 0 and got["sched_invocations"] > 0


def test_tenx_row_equals_reference_on_both_engines(monkeypatch):
    ref, port = shrink_hotpath(monkeypatch, False, jobs=60, rate=500.0,
                               horizon=3600.0)
    want, got, want_rows, got_rows = both(ref._tenx_row, port._tenx_row, 1)
    assert hotpath_masked(got) == hotpath_masked(want)
    assert got_rows == want_rows == ["hotpath_tenx_r500_j2000"]
    assert got["metrics_identical"] is True
    assert got["array"]["rounds_completed"] == \
        got["python"]["rounds_completed"] > 0
    assert got["array"]["checkins"] > 10 ** 6
    # the decision-latency histogram exists on both engines
    for eng in ("python", "array"):
        assert got[eng]["decision_latency_p99_us"] >= \
            got[eng]["decision_latency_p50_us"] > 0


@pytest.mark.parametrize("fast", [False, True])
def test_replan_churn_row_equals_reference(fast, monkeypatch):
    """Three legs (scalar replan, array replan, array with the full-rebuild
    mirror): replans, mirror rebuilds and patches equal to the reference's
    NumPy mirror on every leg."""
    ref, port = shrink_hotpath(monkeypatch, fast, jobs=60, rate=500.0,
                               horizon=1200.0)
    want, got, want_rows, got_rows = both(ref._replan_churn_row,
                                          port._replan_churn_row)
    assert hotpath_masked(got) == hotpath_masked(want)
    assert got_rows == want_rows == ["hotpath_replan_r500_j2000"]
    assert got["replans"] > 0 and got["state_patches"] > 0
    assert got["array_full_rebuild"]["state_rebuilds"] == got["replans"]
    assert got["array_full_rebuild"]["state_patches"] == 0


@pytest.mark.parametrize("fast", [False, True])
def test_replan_breakdown_row_equals_reference(fast, monkeypatch):
    ref, port = shrink_hotpath(monkeypatch, fast, jobs=20, rate=50.0,
                               horizon=3 * DAY)
    want, got, want_rows, got_rows = both(ref._replan_breakdown_row,
                                          port._replan_breakdown_row)
    assert hotpath_masked(got) == hotpath_masked(want)
    assert got_rows == want_rows == ["hotpath_replan_breakdown"]
    assert got["replans"] > 0
    assert set(got["phases_s"]) == set(want["phases_s"]) == {
        "supply", "irs", "tiers", "compile"}
    assert got["replan_total_s"] > 0


def test_fault_sweep_row_equals_reference(monkeypatch):
    """``degraded_segments`` is masked: the reference's NumPy engine serves
    NaN segments of <= 24 rows without counting them, the port counts every
    one (as the reference's ``jax`` engine does), so it counts at least as
    many."""
    ref, port = shrink_hotpath(monkeypatch, True, jobs=12, rate=50.0,
                               horizon=DAY)
    want, got, want_rows, got_rows = both(ref._fault_sweep_row,
                                          port._fault_sweep_row)
    assert hotpath_masked(got) == hotpath_masked(want)
    assert got_rows == want_rows == ["hotpath_faults_blackout_storm",
                                     "hotpath_faults_flaky_ingest"]
    assert got["blackout_storm"]["dropped_checkins"] > 0
    for name in ("blackout_storm", "flaky_ingest"):
        assert got[name]["degraded_segments"] >= \
            want[name]["degraded_segments"]


def test_masking_keeps_every_deterministic_key():
    """What the comparisons above hold equal, by name."""
    kept = ["avg_jct_s", "unfinished", "checkins_seen", "checkins_skipped",
            "sched_invocations", "rounds_completed", "checkins", "replans",
            "state_rebuilds", "state_patches", "trace_bytes",
            "dropped_checkins", "revoked_responses", "flaky_retries",
            "audit_records", "metrics_identical"]
    masked = ["wall_s", "checkin_loop_s", "stream_s", "seen_per_sec",
              "total_per_sec", "replans_per_sec", "decision_latency_p50_us",
              "loop_speedup", "e2e_speedup", "replan_speedup",
              "speedup_vs_scalar", "mirror_speedup", "state_mirror_s",
              "mirror_full_s", "replan_total_s", "replan_frac_of_wall",
              "p99_replan_s", "phases_s", "phase_frac", "wall_vs_baseline",
              "audit_overhead_frac", "cpu_on_s", "meets_5pct_target",
              "heavy_under_60s", "speedup_vs_issue_baseline",
              "degraded_segments"]
    port_only = ["paired_overhead_frac"]
    got = hotpath_masked({k: 1 for k in kept + masked + port_only})
    assert {k for k, v in got.items() if v == 1} == set(kept)
    assert set(got) == set(kept + masked)
