"""The port's hot-path entry at ``REPRO_BENCH_FAST`` sizing, shrunk
(``torch_parity.shrink_hotpath``), against the reference's: its rows,
printed row names, report and history; the scenario-replay row; a run
merging into an earlier report and appending to an earlier history.

Both ``main``s write into ``REPRO_BENCH_OUT`` (a ``tmp_path``); the
reference's records at the repo root, ``BENCH_hotpath.json`` and
``BENCH_history.jsonl``, keep their bytes.
"""
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from torch_parity import (emitted_names, hotpath_both, hotpath_masked,  # noqa: E402,E501
                          HOTPATH_SERIES, read_jsonl, run_hotpath_main,
                          shrink_hotpath)

DAY = 24 * 3600.0
RECORDS = ("BENCH_hotpath.json", "BENCH_history.jsonl")
FAST_ROWS = ["hotpath_profiled_r1.5_j50", "hotpath_medium_r15_j100",
             "hotpath_speedup", "hotpath_replan_r500_j2000",
             "hotpath_replan_breakdown", "hotpath_scenario_replay",
             "hotpath_faults_blackout_storm", "hotpath_faults_flaky_ingest",
             "hotpath_audit_overhead", "hotpath_history"]
FAST_WORKLOADS = ["profiled_r1.5_j50", "medium_r15_j100",
                  "replan_r500_j2000", "audit_overhead_paired"]


def test_fast_main_equals_reference(tmp_path, monkeypatch):
    before = {n: (ROOT / n).read_bytes() for n in RECORDS}
    ref, port = shrink_hotpath(monkeypatch, True, jobs=12, rate=50.0,
                               horizon=DAY / 4)
    monkeypatch.setenv("REPRO_BENCH_HOST", "parity")
    want, want_out = run_hotpath_main(ref.main, tmp_path / "ref",
                                      monkeypatch)
    got, got_out = run_hotpath_main(port.main, tmp_path / "port",
                                    monkeypatch, device="cpu")
    assert hotpath_masked(got) == hotpath_masked(want)
    assert emitted_names(got_out) == emitted_names(want_out) == FAST_ROWS
    assert "heavy_r50_j200" not in got and "tenx_r500_j2000" not in got

    # the report: the reference's keys and deterministic values
    rep_ref = json.loads((tmp_path / "ref" / "BENCH_hotpath.json")
                         .read_text())
    rep = json.loads((tmp_path / "port" / "BENCH_torch_hotpath.json")
                     .read_text())
    assert list(rep) == list(rep_ref)
    assert hotpath_masked(rep) == hotpath_masked(rep_ref)
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == [
        "BENCH_torch_history.jsonl", "BENCH_torch_hotpath.json"]

    # the history: the reference's row schema, workloads and flags
    h_ref = read_jsonl(tmp_path / "ref" / "BENCH_history.jsonl")
    h = read_jsonl(tmp_path / "port" / "BENCH_torch_history.jsonl")
    assert [HOTPATH_SERIES.get(r["workload"], r["workload"])
            for r in h_ref] == [r["workload"] for r in h] == FAST_WORKLOADS
    for r, w in zip(h, h_ref):
        assert list(r) == list(w)
        assert list(r["metrics"]) == list(w["metrics"])
        assert hotpath_masked(r["metrics"]) == hotpath_masked(w["metrics"])
        assert (r["fast"], r["host"], r["commit"]) == \
            (True, "parity", w["commit"])
    assert len({r["ts"] for r in h}) == 1
    assert "python -m repro_torch.benchmarks.regress" in got_out
    assert {n: (ROOT / n).read_bytes() for n in RECORDS} == before


def test_scenario_replay_row_equals_reference(monkeypatch):
    ref, port = shrink_hotpath(monkeypatch, True, jobs=12, rate=50.0,
                               horizon=DAY)
    want, got, want_rows, got_rows = hotpath_both(ref._scenario_replay_row,
                                                  port._scenario_replay_row)
    assert hotpath_masked(got) == hotpath_masked(want)
    assert got_rows == want_rows == ["hotpath_scenario_replay"]
    assert got["trace_bytes"] > 0


def test_a_fast_run_merges_into_an_earlier_report(tmp_path, monkeypatch):
    """An earlier full report (the reference's committed one, as the port's
    file, a deprecated ``checkins_per_sec`` alias added) keeps the heavy and
    tenx rows a FAST run skips; the rows it ran are replaced, the alias
    dropped; the history is appended to, not rewritten; the port's
    ``regress list`` reads it."""
    from repro_torch.benchmarks import regress
    _, port = shrink_hotpath(monkeypatch, True, jobs=8, rate=15.0,
                             horizon=DAY / 8)
    earlier = json.loads((ROOT / "BENCH_hotpath.json").read_text())
    earlier["heavy_r50_j200"]["checkins_per_sec"] = 1.0
    (tmp_path / "BENCH_torch_hotpath.json").write_text(json.dumps(earlier))
    first = (ROOT / "BENCH_history.jsonl").read_text().splitlines()[-1]
    (tmp_path / "BENCH_torch_history.jsonl").write_text(first + "\n")

    got, _ = run_hotpath_main(port.main, tmp_path, monkeypatch,
                              device="cpu")
    rep = json.loads((tmp_path / "BENCH_torch_hotpath.json").read_text())
    del earlier["heavy_r50_j200"]["checkins_per_sec"]
    for key in ("heavy_r50_j200", "tenx_r500_j2000", "heavy_under_60s"):
        assert rep[key] == earlier[key]
    for key in got:
        assert rep[key] == json.loads(json.dumps(got[key]))
    assert rep["profiled_r1.5_j50"] != earlier["profiled_r1.5_j50"]
    hist = (tmp_path / "BENCH_torch_history.jsonl").read_text().splitlines()
    assert hist[0] == first
    assert [json.loads(ln)["workload"] for ln in hist[1:]] == FAST_WORKLOADS
    assert regress.main(["list", "--history",
                         str(tmp_path / "BENCH_torch_history.jsonl")]) == 0
