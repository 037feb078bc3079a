"""The port's hot-path entry (``repro_torch.benchmarks.bench_hotpath.main``)
at full sizing, shrunk (``torch_parity.shrink_hotpath``): the device it
gives every VENN scheduler and simulator it builds, its rows and report
keys; its refusal to run without a card unless asked for the CPU; and the
audit-overhead row against the reference's.  ``main`` writes into
``REPRO_BENCH_OUT`` (a ``tmp_path``).
"""
import contextlib
import io
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from torch_parity import (emitted_names, hotpath_both, hotpath_masked,  # noqa: E402,E501
                          read_jsonl, run_hotpath_main, shrink_hotpath)

DAY = 24 * 3600.0
RECORDS = ("BENCH_hotpath.json", "BENCH_history.jsonl")

# the reference's main at full sizing prints these rows, in this order (its
# FAST run skips the heavy and tenx rows)
FULL_ROWS = ["hotpath_profiled_r1.5_j50", "hotpath_medium_r15_j100",
             "hotpath_heavy_r50_j200", "hotpath_speedup",
             "hotpath_heavy_validates", "hotpath_tenx_r500_j2000",
             "hotpath_replan_r500_j2000", "hotpath_replan_breakdown",
             "hotpath_scenario_replay", "hotpath_faults_blackout_storm",
             "hotpath_faults_flaky_ingest", "hotpath_audit_overhead",
             "hotpath_history"]


def test_full_main_gives_the_device_to_every_scheduler_and_simulator(
        tmp_path, monkeypatch):
    """Full sizing (``FAST`` off: heavy, tenx on both engines, the churn
    row's two reps), shrunk: every VENN scheduler, every simulator and every
    ``run_one`` of the run gets ``cpu``; the rows and the report's keys are
    the reference's full run's (its committed ``BENCH_hotpath.json``)."""
    from repro_torch.core import SCHEDULERS, VennScheduler
    from repro_torch.sim.simulator import Simulator
    _, port = shrink_hotpath(monkeypatch, False, jobs=12, rate=50.0,
                             horizon=DAY / 8)
    seen = {"sched": [], "sim": [], "run_one": []}

    class Venn(VennScheduler):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            seen["sched"].append(str(self.device))

    real_init, real_run_one = Simulator.__init__, port.run_one

    def sim_init(self, jobs, scheduler, *a, **kw):
        seen["sim"].append((str(kw.get("device")),
                            str(scheduler.device)))
        real_init(self, jobs, scheduler, *a, **kw)

    def run_one(*a, **kw):
        seen["run_one"].append(str(kw.get("device")))
        return real_run_one(*a, **kw)

    monkeypatch.setitem(SCHEDULERS, "venn", Venn)
    monkeypatch.setattr(Simulator, "__init__", sim_init)
    monkeypatch.setattr(port, "run_one", run_one)
    got, out = run_hotpath_main(port.main, tmp_path, monkeypatch,
                                device="cpu")

    # 3 scenario rows, tenx 3 reps x 2 engines, churn 2 reps x 3 legs,
    # the breakdown, 2 replay and 3 fault runs, the audit row's reference
    # pairs and paired-median pairs
    assert len(seen["run_one"]) == 5
    assert len(seen["sched"]) == len(seen["sim"]) == \
        3 + 6 + 6 + 1 + 5 + 2 * 4 + 2 * port.AUDIT_PAIRS[False]
    assert set(seen["sched"]) == set(seen["run_one"]) == {"cpu"}
    assert set(seen["sim"]) == {("cpu", "cpu")}
    assert emitted_names(out) == FULL_ROWS
    committed = json.loads((ROOT / "BENCH_hotpath.json").read_text())
    rep = json.loads((tmp_path / "BENCH_torch_hotpath.json").read_text())
    assert set(rep) == set(got) == set(committed)
    assert got["tenx_r500_j2000"]["metrics_identical"] is True
    assert [r["workload"] for r in read_jsonl(
        tmp_path / "BENCH_torch_history.jsonl")] == [
        "profiled_r1.5_j50", "medium_r15_j100", "heavy_r50_j200",
        "tenx_r500_j2000", "replan_r500_j2000", "audit_overhead_paired"]


@pytest.mark.parametrize("fast", [False, True])
def test_audit_overhead_row_equals_reference(fast, monkeypatch):
    """Audit on and off on the per-device loop, interleaved: identical
    metrics, the same record count as the reference's recorder and its
    keys; the port's own ``paired_overhead_frac`` besides (timings
    masked)."""
    ref, port = shrink_hotpath(monkeypatch, fast, jobs=8, rate=50.0,
                               horizon=DAY / 8)
    want, got, want_rows, got_rows = hotpath_both(ref._audit_overhead_row,
                                                  port._audit_overhead_row)
    assert hotpath_masked(got) == hotpath_masked(want)
    assert list(got) == list(want) + ["paired_overhead_frac"]
    assert got_rows == want_rows == ["hotpath_audit_overhead"]
    assert got["audit_records"] > 0 and got["metrics_identical"] is True


def test_audit_row_runs_the_reference_pairs_then_alternating_pairs(
        monkeypatch):
    """The reference's 5 pairs, audit off first in each, then
    ``AUDIT_PAIRS`` pairs whose first side alternates; the row itself
    freezes no part of the heap (the simulator's loop does, next test)."""
    import gc

    from repro_torch import obs
    from repro_torch.sim.simulator import Simulator
    _, port = shrink_hotpath(monkeypatch, True, jobs=4, rate=15.0,
                             horizon=DAY / 8)
    runs = []
    real_run = Simulator.run

    def run(self, *a, **kw):
        runs.append((gc.get_freeze_count(), obs.get_audit().enabled))
        return real_run(self, *a, **kw)
    monkeypatch.setattr(Simulator, "run", run)
    before = gc.get_freeze_count()
    with contextlib.redirect_stdout(io.StringIO()):
        port._audit_overhead_row(device="cpu")
    assert [a for _, a in runs] == [False, True] * 5 \
        + [False, True, True, False] * (port.AUDIT_PAIRS[True] // 2)
    assert max(f for f, _ in runs) <= before, runs


def test_simulator_loop_runs_with_the_heap_before_it_frozen(monkeypatch):
    """``Simulator.step_until`` runs its loop with the heap made before it
    out of every collection and hands it back when it returns: torch's
    import heap, some 10^5 GC-tracked objects, is otherwise scanned by the
    full collections the audit recorder sets off inside the loop, which
    breached the 0.05 cap on the card's host (``PERF.md`` §6).  The
    metrics are those of a run without the freeze."""
    import gc

    from repro_torch.core import SCHEDULERS
    from repro_torch.sim import (JobTraceConfig, PopulationConfig, SimConfig,
                                 generate_jobs)
    from repro_torch.sim.simulator import Simulator

    def sim():
        return Simulator(generate_jobs(JobTraceConfig(num_jobs=4, seed=1)),
                         SCHEDULERS["venn"](seed=1, device="cpu"),
                         PopulationConfig(seed=1001, base_rate=15.0),
                         SimConfig(max_time=DAY / 8), device="cpu")
    inside = []
    real_step = Simulator._step_until

    def step(self, until):
        inside.append(gc.get_freeze_count())
        return real_step(self, until)
    monkeypatch.setattr(Simulator, "_step_until", step)
    gc.collect()
    tracked = len(gc.get_objects())
    got = sim().run().summary()
    assert len(inside) == 1 and inside[0] >= tracked, (inside, tracked)
    assert gc.get_freeze_count() == 0
    monkeypatch.setattr(gc, "freeze", lambda: None)
    assert sim().run().summary() == got


def test_main_without_a_device_raises_before_any_work(tmp_path,
                                                      monkeypatch):
    import torch

    from repro_torch.benchmarks import bench_hotpath, common
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: main() would run on it")
    monkeypatch.setenv("REPRO_BENCH_OUT", str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA"):
        bench_hotpath.main()
    with pytest.raises(RuntimeError, match="CUDA"):
        common.cli(bench_hotpath.main, [])
    assert list(tmp_path.iterdir()) == []


def test_outputs_default_to_the_repo_root_under_the_ports_names():
    from repro_torch.benchmarks import bench_hotpath, regress
    assert bench_hotpath.ROOT == ROOT
    assert regress.DEFAULT_HISTORY.parent == ROOT
    src = Path(bench_hotpath.__file__).read_text()
    assert '"BENCH_torch_hotpath.json"' in src
    assert '"BENCH_torch_history.jsonl"' in src
    for name in RECORDS:
        assert f'"{name}"' not in src
