"""``python -m repro_torch.obs`` — summarize recorded traces, metrics, and audits.

Subcommands:

* ``summarize TRACE [METRICS]`` — top spans by self-time from a Chrome
  trace-event JSON; histogram/counter tables and per-job JCT timelines from
  a metrics JSONL when given.
* ``validate TRACE`` — strict shape check of a trace file (exit 1 on the
  first offending event).
* ``timeline METRICS`` — only the per-job JCT-decomposition bars.
* ``contention AUDIT`` — IRS contention graph of one replan snapshot plus
  per-atom pressure sparklines from a scheduler audit JSONL
  (``--audit-out``).
* ``audit AUDIT [--job J]`` — audit-stream statistics, or an
  "explain job J" report (queue-position history with the contending jobs
  ahead, sampled grants with slot/tier-band detail).
* ``merge METRICS...`` — merge several metrics JSONL files into one summary
  table (counters sum, histograms merge bucket-wise, layout mismatches are
  an error); ``--out`` also writes the merged records as JSONL.

The input files are the artifacts of
``python -m repro_torch.scenarios run <name> --trace-out t.json --metrics-out
m.jsonl --audit-out a.jsonl``.
"""
from __future__ import annotations

import argparse
import json
import sys

from .audit import read_audit
from .contention import (audit_summary_table, contention_graph, explain_job,
                         pressure_timelines)
from .summarize import (counters_table, hist_table, summarize_metrics,
                        summarize_trace)
from .timeline import render_timelines, timelines_from_records
from .metrics import merge_records, read_jsonl
from .trace import load_trace


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="Summarize repro_torch.obs traces, metrics, and audit streams.")
    sub = p.add_subparsers(dest="cmd", required=True)

    ps = sub.add_parser("summarize", help="top spans + histogram tables")
    ps.add_argument("trace", help="Chrome trace-event JSON (--trace-out)")
    ps.add_argument("metrics", nargs="?", default=None,
                    help="metrics JSONL (--metrics-out)")
    ps.add_argument("--top", type=int, default=20,
                    help="number of spans to show (default 20)")

    pv = sub.add_parser("validate", help="validate a trace file's shape")
    pv.add_argument("trace")

    pt = sub.add_parser("timeline", help="per-job JCT decomposition bars")
    pt.add_argument("metrics", help="metrics JSONL (--metrics-out)")

    pc = sub.add_parser("contention",
                        help="IRS contention graph + pressure timelines "
                             "from an audit JSONL")
    pc.add_argument("audit", help="scheduler audit JSONL (--audit-out)")
    pc.add_argument("--replan", type=int, default=None,
                    help="replan seq to graph (default: the last snapshot)")
    pc.add_argument("--atoms", type=int, default=12,
                    help="atoms shown in the pressure timelines "
                         "(top-N by peak pressure, default 12)")

    pa = sub.add_parser("audit",
                        help="audit-stream statistics / explain one job")
    pa.add_argument("audit", help="scheduler audit JSONL (--audit-out)")
    pa.add_argument("--job", type=int, default=None,
                    help="render an 'explain job J' report instead of "
                         "stream statistics")

    pm = sub.add_parser("merge",
                        help="merge metrics JSONL files into one summary")
    pm.add_argument("metrics", nargs="+",
                    help="two or more metrics JSONL files")
    pm.add_argument("--out", default=None, metavar="PATH",
                    help="also write the merged records as JSONL")

    args = p.parse_args(argv)

    if args.cmd == "summarize":
        print(summarize_trace(args.trace, limit=args.top))
        if args.metrics:
            print()
            print(summarize_metrics(args.metrics))
        return 0

    if args.cmd == "validate":
        try:
            doc = load_trace(args.trace)
        except ValueError as e:
            print(f"INVALID: {e}", file=sys.stderr)
            return 1
        print(f"OK: {len(doc['traceEvents'])} events")
        return 0

    if args.cmd == "timeline":
        tls = timelines_from_records(read_jsonl(args.metrics))
        if not tls:
            print("(no timeline records — was the run made with "
                  "--metrics-out?)", file=sys.stderr)
            return 1
        print(render_timelines(tls))
        return 0

    if args.cmd == "contention":
        recs = read_audit(args.audit)
        print(contention_graph(recs, replan=args.replan))
        print()
        print(pressure_timelines(recs, top=args.atoms))
        return 0

    if args.cmd == "audit":
        recs = read_audit(args.audit)
        if args.job is not None:
            print(explain_job(recs, args.job))
        else:
            print(audit_summary_table(recs))
        return 0

    if args.cmd == "merge":
        try:
            merged = merge_records([read_jsonl(f) for f in args.metrics])
        except ValueError as e:
            print(f"merge error: {e}", file=sys.stderr)
            return 1
        print(f"merged {len(args.metrics)} metrics files:")
        print()
        print(hist_table(merged))
        print()
        print(counters_table(merged))
        if args.out:
            with open(args.out, "w") as fh:
                for rec in merged:
                    fh.write(json.dumps(rec) + "\n")
            print(f"\n(merged records written to {args.out})")
        return 0

    return 2


if __name__ == "__main__":
    raise SystemExit(main())
