"""The port's perf gate (``repro_torch.benchmarks.regress``) against the
reference's ``benchmarks/regress.py``.

The first-run cases of ``tests/test_regress.py`` run against the port's
module; then histories made from a NumPy seed — several workloads, hosts
and ``fast`` flags, regressions in both directions, cap breaches, an
unparseable line, a row without ``ts``, a metric new in the latest run —
go through both modules' ``check`` and ``list``: equal exit codes, equal
stdout and stderr.
"""
import ast
import json
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from benchmarks import regress as ref  # noqa: E402
from repro_torch.benchmarks import regress  # noqa: E402


def _row(workload, metrics, ts, host="testhost", fast=True):
    return {"commit": "abc1234", "ts": ts, "host": host, "fast": fast,
            "workload": workload, "metrics": metrics}


def _write(tmp_path, rows):
    p = tmp_path / "hist.jsonl"
    p.write_text("".join(json.dumps(r) + "\n" for r in rows))
    return p


# ---- tests/test_regress.py's cases, on the port's module

def test_check_on_missing_file_passes_programmatically(tmp_path, capsys):
    missing = tmp_path / "nope.jsonl"
    assert regress.check(missing) == 0
    assert "nothing to check" in capsys.readouterr().out


def test_load_history_on_missing_file_returns_empty(tmp_path):
    assert regress.load_history(tmp_path / "nope.jsonl") == []


def test_first_ever_run_establishes_baseline(tmp_path, capsys):
    p = _write(tmp_path, [_row("w", {"wall_s": 2.0}, ts=1.0)])
    assert regress.check(p) == 0
    assert "no comparable history" in capsys.readouterr().out


def test_new_metric_key_with_stale_priors_is_baseline(tmp_path, capsys):
    p = _write(tmp_path, [
        _row("w", {"wall_s": 2.0}, ts=1.0),
        _row("w", {"wall_s": 2.1, "mirror_speedup": 3.5,
                   "state_mirror_s": 0.4}, ts=2.0),
    ])
    assert regress.check(p) == 0
    out = capsys.readouterr().out
    assert out.count("no comparable history") == 2


def test_new_metric_key_then_regression_is_caught(tmp_path, capsys):
    p = _write(tmp_path, [
        _row("w", {"mirror_speedup": 4.0}, ts=1.0),
        _row("w", {"mirror_speedup": 1.0}, ts=2.0),
    ])
    assert regress.check(p) == 1
    assert "regressed beyond" in capsys.readouterr().out


def test_mirror_metrics_are_tracked_with_correct_directions():
    assert regress.TRACKED["state_mirror_s"] == ("lower", "host")
    assert regress.TRACKED["mirror_speedup"] == ("higher", "any")


def test_cap_only_metric_ignores_relative_band(tmp_path, capsys):
    p = _write(tmp_path, [
        _row("w", {"audit_overhead_frac": 0.0016}, ts=1.0),
        _row("w", {"audit_overhead_frac": 0.032}, ts=2.0),
    ])
    assert regress.check(p) == 0
    assert "cap-only" in capsys.readouterr().out


def test_cap_only_metric_still_enforces_cap(tmp_path, capsys):
    p = _write(tmp_path, [
        _row("w", {"audit_overhead_frac": 0.0016}, ts=1.0),
        _row("w", {"audit_overhead_frac": 0.30}, ts=2.0),
    ])
    assert regress.check(p) == 1
    assert "breaches absolute cap" in capsys.readouterr().out


# ---- the port's own series, and the reference's constants

def test_the_port_keeps_the_references_gate_and_its_own_history():
    assert regress.TRACKED == ref.TRACKED
    assert regress.CAPS == ref.CAPS and regress.CAP_ONLY == ref.CAP_ONLY
    assert regress.DEFAULT_TOL == ref.DEFAULT_TOL
    assert regress.DEFAULT_HISTORY == ROOT / "BENCH_torch_history.jsonl"
    assert ref.DEFAULT_HISTORY == ROOT / "BENCH_history.jsonl"
    # stdlib only: neither torch nor the reference
    tree = ast.parse(Path(regress.__file__).read_text())
    imported = {a.name.split(".")[0] for n in ast.walk(tree)
                if isinstance(n, ast.Import) for a in n.names}
    imported |= {n.module.split(".")[0] for n in ast.walk(tree)
                 if isinstance(n, ast.ImportFrom)}
    assert imported <= set(sys.stdlib_module_names) | {"__future__"}, \
        imported


def test_cli_on_a_missing_history_and_its_tolerance(tmp_path, capsys):
    missing = str(tmp_path / "nope.jsonl")
    assert regress.main(["check", "--history", missing]) == 0
    assert "no history file" in capsys.readouterr().out
    p = _write(tmp_path, [_row("w", {"wall_s": 2.0}, ts=1.0),
                          _row("w", {"wall_s": 2.9}, ts=2.0)])
    assert regress.main(["check", "--history", str(p)]) == 0
    assert regress.main(["check", "--history", str(p), "--tol", "0.2"]) == 1


# ---- seeded histories through both modules

WORKLOADS = ("profiled_r1.5_j50", "medium_r15_j100", "tenx_r500_j2000",
             "replan_r500_j2000", "audit_overhead")
HOSTS = ("card", "vm", "ci")
METRICS = tuple(ref.TRACKED) + ("avg_jct_s", "e2e_speedup")


def seeded_history(seed):
    """JSONL text of a few runs: every run shares one ``ts``; metric values
    log-normal around 1 (a 50 % band is crossed both ways), the audit
    fraction uniform in [0, 0.08) (the 0.05 cap breached now and then);
    a garbage line, a row without ``ts``, a row without metrics, and a
    metric the latest run alone carries."""
    rng = np.random.default_rng(seed)
    lines = []
    runs = int(rng.integers(2, 6))
    for run in range(runs):
        ts = 1000.0 + 10.0 * run
        host = str(rng.choice(HOSTS))
        fast = bool(rng.integers(2))
        for w in rng.permutation(WORKLOADS)[:int(rng.integers(1, 6))]:
            names = rng.permutation(METRICS)[:int(rng.integers(1, 6))]
            m = {str(k): float(rng.lognormal(0.0, 0.5)) for k in names}
            if "audit_overhead_frac" in m:
                m["audit_overhead_frac"] = float(rng.uniform(0, 0.08))
            if run == runs - 1 and rng.uniform() < 0.5:
                m["mirror_speedup"] = float(rng.lognormal(0.0, 0.5))
            if rng.uniform() < 0.1:
                m["note"] = "text"
            if rng.uniform() < 0.1:
                m["replans_per_sec"] = int(rng.integers(0, 3))
            row = _row(str(w), m, ts, host=host,
                       fast=fast if rng.uniform() < 0.8 else not fast)
            lines.append(json.dumps(row))
    lines.insert(int(rng.integers(0, len(lines) + 1)), "{not json")
    no_ts = _row(str(rng.choice(WORKLOADS)), {"wall_s": 1.0}, 0.0)
    del no_ts["ts"]
    lines.insert(int(rng.integers(0, len(lines) + 1)), json.dumps(no_ts))
    lines.insert(int(rng.integers(0, len(lines) + 1)),
                 json.dumps({"workload": "w", "metrics": [1]}))
    lines.insert(int(rng.integers(0, len(lines) + 1)), "")
    return "\n".join(lines) + "\n"


def _both(capsys, argv):
    got = []
    for mod in (ref, regress):
        rc = mod.main(argv)
        cap = capsys.readouterr()
        got.append((rc, cap.out, cap.err))
    return got


@pytest.mark.parametrize("seed", range(12))
def test_seeded_histories_give_the_references_verdicts(seed, tmp_path,
                                                       capsys):
    p = tmp_path / "hist.jsonl"
    p.write_text(seeded_history(seed))
    for argv in (["check", "--history", str(p)],
                 ["check", "--history", str(p), "--tol", "0.2"],
                 ["list", "--history", str(p)],
                 ["list", "--history", str(p), "--workload",
                  WORKLOADS[seed % len(WORKLOADS)]]):
        want, got = _both(capsys, argv)
        assert got == want, argv
    assert "unparseable row skipped" in want[2]


def test_seeded_histories_cover_both_verdicts_and_the_cap(tmp_path, capsys):
    """The sweep above is not vacuous: across its seeds the reference both
    passes and fails, on a band and on the cap."""
    seen = {"pass": 0, "band": 0, "cap": 0}
    for seed in range(12):
        p = tmp_path / f"h{seed}.jsonl"
        p.write_text(seeded_history(seed))
        rc = ref.check(p)
        out = capsys.readouterr().out
        seen["pass"] += rc == 0
        seen["band"] += "regressed beyond" in out
        seen["cap"] += "breaches absolute cap" in out
    assert all(seen.values()), seen
