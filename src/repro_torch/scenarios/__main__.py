"""CLI for the scenario engine.

Examples::

    python -m repro_torch.scenarios list
    python -m repro_torch.scenarios run flash_crowd --sched venn,random
    python -m repro_torch.scenarios run --all --fast
    python -m repro_torch.scenarios run churn_storm --record storm.csv --sched venn
    python -m repro_torch.scenarios replay baseline_even storm.csv --sched venn
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import List, Optional

from . import library  # noqa: F401  (populates the registry)
from .runner import DEFAULT_SCHEDS, comparison_table, run_scenario
from .spec import all_scenarios, get_scenario, scenario_names


def _scheds(arg: str) -> List[str]:
    return [s.strip() for s in arg.split(",") if s.strip()]


def _seeds(arg: str) -> List[int]:
    return [int(s) for s in arg.split(",") if s.strip()]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m repro_torch.scenarios",
                                description="Venn scenario engine")
    sub = p.add_subparsers(dest="cmd", required=True)

    sub.add_parser("list", help="list registered scenarios")

    run = sub.add_parser("run", help="run scenario(s) across schedulers/seeds")
    run.add_argument("name", nargs="?", help="scenario name (or --all)")
    run.add_argument("--all", action="store_true", dest="run_all",
                     help="run every registered scenario")
    run.add_argument("--sched", type=_scheds, default=list(DEFAULT_SCHEDS),
                     help="comma-separated schedulers (default: venn,random)")
    run.add_argument("--seeds", type=_seeds, default=[0],
                     help="comma-separated seeds (default: 0)")
    run.add_argument("--fast", action="store_true",
                     help="shrunk smoke-run sizing")
    run.add_argument("--record", default=None, metavar="PATH",
                     help="record the first run's device stream to a trace "
                          "file (.csv or .jsonl)")
    run.add_argument("--engine", choices=("python", "array"), default="python",
                     help="simulator drain engine: per-device scalar loop or "
                          "batched array matching (repro_torch.accel) — identical "
                          "metrics, different wall-clock")
    run.add_argument("--trace-out", default=None, metavar="PATH",
                     help="write a Chrome trace-event JSON of the runs "
                          "(open in Perfetto; summarize with "
                          "`python -m repro_torch.obs summarize PATH`)")
    run.add_argument("--metrics-out", default=None, metavar="PATH",
                     help="write a metrics JSONL (histograms, counters, "
                          "per-job JCT-decomposition timeline records)")
    run.add_argument("--audit-out", default=None, metavar="PATH",
                     help="write the scheduler flight-recorder JSONL "
                          "(replan snapshots, sampled grant audit, "
                          "queue-position history; render with "
                          "`python -m repro_torch.obs contention|audit PATH`)")
    run.add_argument("--grant-sample", type=int, default=None,
                     metavar="N",
                     help="audit every Nth round-opening grant (default 1 "
                          "= one grant per round — only meaningful with "
                          "--audit-out)")

    rep = sub.add_parser("replay", help="run a scenario's jobs over a "
                                        "recorded device trace")
    rep.add_argument("name", help="scenario providing the job side")
    rep.add_argument("trace", help="trace file (.csv or .jsonl)")
    rep.add_argument("--sched", type=_scheds, default=list(DEFAULT_SCHEDS))
    rep.add_argument("--seeds", type=_seeds, default=[0])
    rep.add_argument("--fast", action="store_true")
    rep.add_argument("--engine", choices=("python", "array"), default="python")
    for sp in (run, rep):
        sp.add_argument("--device", default=None, metavar="DEV",
                        help="torch device of the array engine's matcher "
                             "and VENN's replan resort (default: cuda:0; "
                             "`cpu` runs the host path)")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.cmd == "list":
        for spec in all_scenarios():
            print(f"{spec.name:<22} {spec.description}")
        return 0
    if args.cmd == "run":
        if args.run_all:
            names = scenario_names()
        elif args.name:
            names = [args.name]
        else:
            print("error: give a scenario name or --all", file=sys.stderr)
            return 2
        def per_scenario(path: Optional[str], name: str) -> Optional[str]:
            # one output file per scenario (never silently overwrite);
            # split on the basename only — dots in directories stay put
            if path is None or len(names) == 1:
                return path
            p = Path(path)
            new = f"{p.stem}.{name}{p.suffix}" if p.suffix \
                else f"{p.name}.{name}"
            return str(p.with_name(new))

        for name in names:
            spec = get_scenario(name)
            record = per_scenario(args.record, name)
            trace_out = per_scenario(args.trace_out, name)
            metrics_out = per_scenario(args.metrics_out, name)
            audit_out = per_scenario(args.audit_out, name)
            try:
                results = run_scenario(spec, scheds=args.sched,
                                       seeds=args.seeds, fast=args.fast,
                                       record=record, engine=args.engine,
                                       trace_out=trace_out,
                                       metrics_out=metrics_out,
                                       audit_out=audit_out,
                                       grant_sample=args.grant_sample,
                                       device=args.device)
            except ValueError as e:
                print(f"error: {e}", file=sys.stderr)
                return 2
            print(f"\n== {spec.name} ==  {spec.description}")
            if record is not None:
                print(f"(device stream recorded to {record})")
            if trace_out is not None:
                print(f"(trace written to {trace_out} — "
                      f"`python -m repro_torch.obs summarize {trace_out}`)")
            if metrics_out is not None:
                print(f"(metrics written to {metrics_out})")
            if audit_out is not None:
                print(f"(scheduler audit written to {audit_out} — "
                      f"`python -m repro_torch.obs contention {audit_out}`)")
            print(comparison_table(results))
        return 0
    if args.cmd == "replay":
        spec = get_scenario(args.name)
        results = run_scenario(spec, scheds=args.sched, seeds=args.seeds,
                               fast=args.fast, replay=args.trace,
                               engine=args.engine, device=args.device)
        print(f"\n== {spec.name} (replay: {args.trace}) ==")
        print(comparison_table(results))
        return 0
    return 2


if __name__ == "__main__":
    sys.exit(main())
