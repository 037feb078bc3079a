"""Perf-regression checker over ``BENCH_torch_history.jsonl`` (the port's
perf gate), the counterpart of the reference's ``benchmarks/regress.py``.

``repro_torch.benchmarks.bench_hotpath`` appends one row per workload per
run::

    {"commit": "abc1234", "ts": 1754650000.0, "host": "ci", "fast": true,
     "workload": "profiled_r1.5_j50", "metrics": {"wall_s": 1.9, ...}}

This module compares the **latest** run (newest ``ts``) against the best
prior value in the series and fails when a tracked metric regressed beyond
its tolerance band, or breached an absolute cap.  The series is the port's
own: the reference's ``BENCH_history.jsonl`` holds walls of another package
on another host and is never read here.

Two comparison scopes:

* **host-scoped** metrics (``wall_s``, ``seen_per_sec``, ``checkin_loop_s``)
  are absolute wall-clock numbers — only comparable between runs on the
  same machine.  Rows are matched on the ``host`` tag (``REPRO_BENCH_HOST``
  env override, e.g. ``ci`` for a homogeneous runner pool; defaults to the
  hostname).  No comparable prior row → the metric passes with a note.
* **any-scoped** metrics (``loop_speedup``, ``audit_overhead_frac``) are
  relative ratios measured on one machine against itself, so every prior
  row is comparable.

``fast`` rows (``REPRO_BENCH_FAST=1``) and full rows are separate series —
a smoke run must never be compared against a full run's numbers.

Tolerance is generous by default (``--tol 0.5`` = 50% worse than best-prior
fails) because single-run wall-clock on shared CI runners is noisy; the gate
exists to catch order-of-magnitude cliffs (an accidentally disabled fast
path, a per-check-in hook), not 5% drift.  ``audit_overhead_frac`` is
gated by an **absolute cap** of 0.05 only — the flight recorder's <5%
budget holds on every machine regardless of history, and a relative band
is meaningless for a near-zero ratio (one lucky 0.2% run would fail every
later honest 3% run).

Usage::

    python -m repro_torch.benchmarks.regress check [--history PATH] [--tol F]
    python -m repro_torch.benchmarks.regress list  [--history PATH] [--workload W]

``check`` exits non-zero on any regression (that is the CI contract).
"""
from __future__ import annotations

import argparse
import json
import os
import platform
import sys
from pathlib import Path
from typing import Dict, List, Optional, Tuple

# the repo root: this module sits at src/repro_torch/benchmarks/
DEFAULT_HISTORY = Path(__file__).resolve().parents[3] / \
    "BENCH_torch_history.jsonl"
DEFAULT_TOL = 0.5

# metric -> (direction, scope): direction "lower"/"higher" is the good way;
# scope "host" compares only same-host prior rows, "any" compares all
TRACKED: Dict[str, Tuple[str, str]] = {
    "wall_s": ("lower", "host"),
    "seen_per_sec": ("higher", "host"),
    "checkin_loop_s": ("lower", "host"),
    "loop_speedup": ("higher", "any"),
    "replan_wall_s": ("lower", "host"),
    "replans_per_sec": ("higher", "host"),
    "replan_speedup": ("higher", "any"),
    "state_mirror_s": ("lower", "host"),
    "mirror_speedup": ("higher", "any"),
    "audit_overhead_frac": ("lower", "any"),
}

# absolute ceilings enforced on the latest run even with no history at all
CAPS: Dict[str, float] = {
    "audit_overhead_frac": 0.05,
}

# metrics whose gate is the cap alone: near-zero ratios (a lucky 0.2%
# overhead run would make every later honest 3% run fail a *relative*
# band despite being far inside the real budget)
CAP_ONLY = frozenset({"audit_overhead_frac"})


def bench_host() -> str:
    return os.environ.get("REPRO_BENCH_HOST", platform.node() or "unknown")


def load_history(path: Path) -> List[dict]:
    # first run on a fresh checkout: no history yet means a clean baseline,
    # not a failure (callers other than main() reach here directly)
    if not path.exists():
        return []
    rows = []
    with open(path) as fh:
        for i, line in enumerate(fh):
            line = line.strip()
            if not line:
                continue
            try:
                row = json.loads(line)
            except ValueError:
                print(f"warning: {path}:{i + 1}: unparseable row skipped",
                      file=sys.stderr)
                continue
            if isinstance(row, dict) and "workload" in row \
                    and isinstance(row.get("metrics"), dict):
                rows.append(row)
    return rows


def _series(rows: List[dict]) -> Dict[Tuple[str, bool], List[dict]]:
    """Group by (workload, fast) and sort each series by timestamp."""
    by: Dict[Tuple[str, bool], List[dict]] = {}
    for r in rows:
        by.setdefault((r["workload"], bool(r.get("fast"))), []).append(r)
    for series in by.values():
        series.sort(key=lambda r: r.get("ts", 0.0))
    return by


def _best_prior(prior: List[dict], metric: str, direction: str,
                scope: str, host: str) -> Optional[float]:
    vals = [r["metrics"][metric] for r in prior
            if metric in r["metrics"]
            and (scope == "any" or r.get("host") == host)]
    if not vals:
        return None
    return min(vals) if direction == "lower" else max(vals)


def check(history: Path, tol: float = DEFAULT_TOL) -> int:
    """Compare the latest run against best-prior per series; 0 = clean."""
    rows = load_history(history)
    if not rows:
        print(f"no history rows in {history}; nothing to check")
        return 0
    latest_ts = max(r.get("ts", 0.0) for r in rows)
    # one bench invocation appends all its rows with a single timestamp
    failures: List[str] = []
    checked = 0
    for (workload, fast), series in sorted(_series(rows).items()):
        latest = series[-1]
        if latest.get("ts", 0.0) != latest_ts:
            continue  # workload not part of the latest run (e.g. FAST skip)
        prior = series[:-1]
        host = latest.get("host", "unknown")
        tag = f"{workload}{' [fast]' if fast else ''}"
        for metric, val in sorted(latest["metrics"].items()):
            if metric not in TRACKED or not isinstance(val, (int, float)):
                continue
            direction, scope = TRACKED[metric]
            cap = CAPS.get(metric)
            if cap is not None and val > cap:
                failures.append(
                    f"{tag}: {metric}={val:.4g} breaches absolute cap "
                    f"{cap:.4g}")
                checked += 1
                continue
            if metric in CAP_ONLY:
                print(f"  {tag}: {metric}={val:.4g} within absolute cap "
                      f"{cap:.4g} (cap-only metric)")
                checked += 1
                continue
            best = _best_prior(prior, metric, direction, scope, host)
            if best is None:
                print(f"  {tag}: {metric}={val:.4g} — no comparable "
                      f"history ({scope}-scoped), pass")
                checked += 1
                continue
            if direction == "lower":
                bad = best > 0 and val > best * (1.0 + tol)
                delta = (val / best - 1.0) if best > 0 else 0.0
            else:
                bad = val < best * (1.0 - tol)
                delta = (val / best - 1.0) if best > 0 else 0.0
            verdict = "REGRESSION" if bad else "ok"
            print(f"  {tag}: {metric}={val:.4g} vs best {best:.4g} "
                  f"({delta:+.1%}) {verdict}")
            if bad:
                failures.append(
                    f"{tag}: {metric}={val:.4g} regressed beyond "
                    f"{tol:.0%} band vs best prior {best:.4g}")
            checked += 1
    if not checked:
        print("latest run carries no tracked metrics; nothing to check")
        return 0
    if failures:
        print(f"\n{len(failures)} regression(s):")
        for f in failures:
            print(f"  FAIL {f}")
        return 1
    print(f"\nall {checked} tracked metric(s) within tolerance "
          f"(tol={tol:.0%})")
    return 0


def list_history(history: Path, workload: Optional[str] = None) -> int:
    rows = load_history(history)
    if workload is not None:
        rows = [r for r in rows if r["workload"] == workload]
    if not rows:
        print("no matching rows")
        return 0
    for (wl, fast), series in sorted(_series(rows).items()):
        print(f"\n== {wl}{' [fast]' if fast else ''} ==")
        for r in series:
            m = " ".join(f"{k}={v:.4g}" for k, v in sorted(
                r["metrics"].items()) if isinstance(v, (int, float)))
            print(f"  {r.get('commit', '?'):<10} host={r.get('host', '?'):<12}"
                  f" ts={r.get('ts', 0.0):.0f}  {m}")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.benchmarks.regress",
        description="perf-regression gate over BENCH_torch_history.jsonl")
    sub = p.add_subparsers(dest="cmd", required=True)
    chk = sub.add_parser("check", help="latest run vs best prior; "
                                       "exit 1 on regression")
    chk.add_argument("--history", type=Path, default=DEFAULT_HISTORY)
    chk.add_argument("--tol", type=float, default=DEFAULT_TOL,
                     help="relative tolerance band (default 0.5 = 50%%)")
    lst = sub.add_parser("list", help="print the history series")
    lst.add_argument("--history", type=Path, default=DEFAULT_HISTORY)
    lst.add_argument("--workload", default=None)
    args = p.parse_args(argv)
    if not args.history.exists():
        print(f"no history file at {args.history}; nothing to check")
        return 0
    if args.cmd == "check":
        return check(args.history, tol=args.tol)
    return list_history(args.history, workload=args.workload)


if __name__ == "__main__":
    sys.exit(main())
