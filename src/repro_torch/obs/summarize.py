"""Trace/metrics summarization backing ``python -m repro_torch.obs``.

Works on the artifacts the runner writes: a Chrome trace-event JSON
(``--trace-out``) and/or a metrics JSONL (``--metrics-out``).  The headline
view is *top spans by self-time*: per (pid, tid), complete ("X") spans are
swept in timestamp order with a stack, and each span's duration minus the
duration of its immediate children is attributed to it — so a ``venn.replan``
parent doesn't double-count the ``venn.replan.irs`` time nested inside it.
"""
from __future__ import annotations

import math
from collections import defaultdict
from typing import Dict, Iterable, List, Optional

from .metrics import Histogram, read_jsonl
from .timeline import render_timelines, timelines_from_records
from .trace import load_trace

__all__ = ["hist_table", "span_stats", "summarize_metrics",
           "summarize_trace", "top_spans_table"]


def span_stats(events: Iterable[dict]) -> Dict[str, dict]:
    """Aggregate "X" spans: per name → count, total_us, self_us, max_us.

    Self-time: for each (pid, tid) lane, sweep spans by start time keeping a
    stack of open spans; a span's duration is subtracted from the self-time
    of its innermost enclosing parent.  Instants contribute a count only.
    """
    stats: Dict[str, dict] = {}

    def entry(name: str) -> dict:
        st = stats.get(name)
        if st is None:
            st = stats[name] = {"count": 0, "total_us": 0.0, "self_us": 0.0,
                                "max_us": 0.0, "instants": 0}
        return st

    lanes: Dict[tuple, List[dict]] = defaultdict(list)
    for ev in events:
        ph = ev.get("ph")
        if ph == "X":
            lanes[(ev.get("pid"), ev.get("tid"))].append(ev)
        elif ph in ("i", "I"):
            entry(ev["name"])["instants"] += 1

    for lane in lanes.values():
        # sort by start asc, then end desc so parents precede their children
        # when both start at the same timestamp
        lane.sort(key=lambda e: (e["ts"], -(e["ts"] + e.get("dur", 0.0))))
        stack: List[dict] = []  # open spans: {"end", "name", "child_us"}
        for ev in lane:
            ts = ev["ts"]
            dur = float(ev.get("dur", 0.0))
            end = ts + dur
            while stack and stack[-1]["end"] <= ts:
                stack.pop()
            if stack:
                stack[-1]["child_us"] += dur
            st = entry(ev["name"])
            st["count"] += 1
            st["total_us"] += dur
            if dur > st["max_us"]:
                st["max_us"] = dur
            frame = {"end": end, "name": ev["name"], "child_us": 0.0}
            stack.append(frame)
            # self-time is settled when the frame pops; settle eagerly by
            # accounting (dur - child_us) at close time instead
            ev["_frame"] = frame
        for ev in lane:
            frame = ev.pop("_frame")
            entry(ev["name"])["self_us"] += max(
                0.0, float(ev.get("dur", 0.0)) - frame["child_us"])
    return stats


def _fmt_us(us: float) -> str:
    if not math.isfinite(us):
        return "nan"
    if us >= 1e6:
        return f"{us / 1e6:.3f}s"
    if us >= 1e3:
        return f"{us / 1e3:.2f}ms"
    return f"{us:.1f}us"


def top_spans_table(stats: Dict[str, dict], limit: int = 20) -> str:
    """Render span stats as a self-time-sorted table."""
    rows = sorted(stats.items(), key=lambda kv: -kv[1]["self_us"])[:limit]
    if not rows:
        return "(no spans)"
    name_w = max(24, max(len(n) for n, _ in rows))
    lines = [f"{'span':<{name_w}} {'count':>8} {'self':>10} "
             f"{'total':>10} {'max':>10} {'inst':>6}"]
    for name, st in rows:
        lines.append(
            f"{name:<{name_w}} {st['count']:>8} {_fmt_us(st['self_us']):>10} "
            f"{_fmt_us(st['total_us']):>10} {_fmt_us(st['max_us']):>10} "
            f"{st['instants']:>6}")
    return "\n".join(lines)


def hist_table(snaps: List[dict]) -> str:
    """Render histogram snapshots (from metrics JSONL) as a percentile table.

    Histograms whose name ends in ``_s`` record seconds and are shown in
    human time units; anything else is a plain number (e.g. iteration
    counts)."""
    rows = [s for s in snaps if s.get("kind") == "histogram"]
    if not rows:
        return "(no histograms)"
    name_w = max(24, max(len(s["name"]) for s in rows))
    lines = [f"{'histogram':<{name_w}} {'count':>10} {'mean':>10} "
             f"{'p50':>10} {'p95':>10} {'p99':>10} {'max':>10}"]
    for s in sorted(rows, key=lambda s: s["name"]):
        h = Histogram.from_snapshot(s)
        vmax = h.vmax if math.isfinite(h.vmax) else float("nan")
        vals = (h.mean, h.percentile(50), h.percentile(95),
                h.percentile(99), vmax)
        if s["name"].endswith("_s"):
            cells = [_fmt_us(v * 1e6) for v in vals]
        else:
            cells = [f"{v:.3g}" for v in vals]
        lines.append(f"{s['name']:<{name_w}} {h.count:>10} "
                     + " ".join(f"{c:>10}" for c in cells))
    lines.append("  (`*_s` histograms record seconds, shown in time units)")
    return "\n".join(lines)


def counters_table(snaps: List[dict]) -> str:
    rows = [s for s in snaps if s.get("kind") in ("counter", "gauge")]
    if not rows:
        return "(no counters)"
    name_w = max(24, max(len(s["name"]) for s in rows))
    lines = [f"{'counter/gauge':<{name_w}} {'value':>16}"]
    for s in sorted(rows, key=lambda s: s["name"]):
        v = s["value"]
        txt = f"{v:.6g}" if isinstance(v, float) else str(v)
        lines.append(f"{s['name']:<{name_w}} {txt:>16}")
    return "\n".join(lines)


def summarize_trace(path: str, limit: int = 20) -> str:
    doc = load_trace(path)
    events = doc["traceEvents"]
    stats = span_stats(events)
    other = doc.get("otherData", {})
    head = (f"trace: {path} — {len(events)} events, "
            f"{other.get('dropped_events', 0)} dropped")
    return "\n".join([head, "", "top spans by self-time:",
                      top_spans_table(stats, limit=limit)])


def summarize_metrics(path: str, jobs: bool = True) -> str:
    recs = read_jsonl(path)
    parts = [f"metrics: {path} — {len(recs)} records", "",
             hist_table(recs), "", counters_table(recs)]
    if jobs:
        tls = timelines_from_records(recs)
        if tls:
            parts += ["", render_timelines(tls)]
    return "\n".join(parts)
