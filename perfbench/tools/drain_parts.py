"""The drain's parts in a traced run of a cell: where the time inside
``step_until`` goes, by the program's own counters and spans.

    python3 perfbench/tools/drain_parts.py --workload even.drain \
        --seed <n> --seconds 51 [--sim 0|1]

A traced run of the harness (``harness.run_cell(..., trace=True)``) with
three additions, made in this process only:

* the capture records the program's ``sim`` spans too (``sim.drain``,
  ``sim.chunk_load``, ``sim.event.<kind>``), and names chunk loads by the
  program's span instead of wrapping ``_load_next_chunk``; the program
  keeps the drain's parts only for a tracer that records ``sim``, so
  ``--sim 0`` (the capture as the harness has it) reads none of them and
  costs the recording;
* idle gaps are split by overlap (:func:`name_gaps`): each instant of a gap
  goes to the innermost span covering it, and idle time inside a
  ``step_until`` slice that no program span covers stays ``sim.step_until``;
* the counters gain the drain's parts (``Simulator.drain_parts()`` and the
  scheduler's ``replan_seconds``), read by :data:`READERS` into five
  per-layer quantities.

Not part of a run: the benchmark's harness records neither the ``sim``
category nor these counters (``PERF.md`` §7 names the edits that would wire
them in).  Prints one JSON line: the run's result line with ``parts`` added.
Needs a CUDA device unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import resource
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]

OUTSIDE = "harness (between slices)"


def innermost(spans):
    """Non-overlapping ``(a, b, name)`` pieces of the spans' union: at each
    instant, the span that began last among those covering it (for nested
    spans, the innermost)."""
    out = []
    stack = []                      # (end, name), the innermost last
    t = -math.inf

    def close_until(x):
        nonlocal t
        while stack:
            end, name = stack[-1]
            if end <= t:
                stack.pop()
            elif end <= x:
                out.append((t, end, name))
                t = end
                stack.pop()
            else:
                break

    for a, b, name in sorted(spans, key=lambda s: (s[0], -s[1])):
        close_until(a)
        if stack and a > t:
            out.append((t, a, stack[-1][1]))
        t = max(t, a)
        stack.append((b, name))
    close_until(math.inf)
    return out


def name_gaps(gaps, spans) -> dict:
    """Idle seconds by the innermost span covering each instant of each gap
    (``gaps``: sorted, disjoint ``(a, b, seconds)``, ``a`` and ``b`` on the
    spans' clock; ``seconds`` the gap's length on its own clock, which its
    pieces are scaled to).  Uncovered time is :data:`OUTSIDE`; the names
    sum to the gaps' total."""
    pieces = innermost(spans)
    out: dict = {}
    j = 0
    for a, b, seconds in gaps:
        if b <= a:
            out[OUTSIDE] = out.get(OUTSIDE, 0.0) + seconds
            continue
        scale = seconds / (b - a)
        while j < len(pieces) and pieces[j][1] <= a:
            j += 1
        covered = 0.0
        k = j
        while k < len(pieces) and pieces[k][0] < b:
            lo, hi = max(a, pieces[k][0]), min(b, pieces[k][1])
            if hi > lo:
                name = pieces[k][2]
                out[name] = out.get(name, 0.0) + (hi - lo) * scale
                covered += hi - lo
            k += 1
        if b - a > covered:
            out[OUTSIDE] = out.get(OUTSIDE, 0.0) + (b - a - covered) * scale
    return out


def _per(num, den, unit=1e9):
    return num / den * unit if den else None


def _bookkeeping(r):
    """The array drain's seconds less every named part inside it."""
    return (r["drain_s"] - r["stream_s"] - r["replan_seconds"]
            - r["rebuild_s"] - r["patch_s"] - r["matcher_s"]
            - r["scalar_seconds"] - r["grant_seconds"] - r["idle_seconds"])


def _events(r, what):
    return sum(v for k, v in r.items() if k.startswith(what + "."))


READERS = {
    # control events: _on_job_arrival, _pop_response, _on_deadline,
    # _complete_round and the scheduler's on_* hooks, ns an event
    "event_ns_per_event": lambda r: _per(_events(r, "event_seconds"),
                                         _events(r, "events")),
    # grants: _grant with sched.on_grant, ns a grant
    "grant_ns_per_grant": lambda r: _per(r["grant_seconds"], r["grants"]),
    # the scalar route: _drain_array_scalar and head-miss checkins, less
    # their grants and replans, ns a row examined
    "scalar_ns_per_row": lambda r: _per(
        r["scalar_seconds"], r["scalar_rows"] + r["head_misses"]),
    # segment bookkeeping, ns an engine.prepare call
    "segment_ns_per_segment": lambda r: _per(_bookkeeping(r),
                                             r["drain_segments"]),
    # drain routing: rows the vectorised route decided (after its cuts)
    # over rows examined, % (the benchmark's matcher_row_share counts the
    # rows handed to it over all rows decided)
    "vector_row_share": lambda r: _per(
        r["vector_rows"],
        r["vector_rows"] + r["scalar_rows"] + r["head_misses"], 100.0),
}


def counters(base):
    """``program.counters`` with the drain's parts summed over episodes."""
    def read(episodes):
        c = base(episodes)
        c["replan_seconds"] = 0.0
        for ep in episodes:
            for k, v in ep.sim.drain_parts().items():
                c[k] = c.get(k, 0) + v
            c["replan_seconds"] += ep.sched.replan_seconds
        return c
    return read


def capture_class(base, with_sim: bool, got: dict):
    """The harness's capture with the additions above; its readings are
    also left in ``got["r"]``."""
    class PartsCapture(base):
        def start(self):
            super().start()
            if with_sim:
                self.tracer.categories = self.tracer.categories | {"sim"}

        def watch(self, episode):
            if not with_sim:
                super().watch(episode)

        def readings(self):
            d = super().readings()
            d["trace_events"] = len(self.events)
            d["step_until_s"] = sum(b - a for n, a, b in self.spans
                                    if n == "sim.step_until")
            got["r"] = d
            return d

        def _name_gaps(self, gaps, to_host):
            t0 = self.tracer_t0
            spans = [(t0 + e["ts"] / 1e6, t0 + (e["ts"] + e["dur"]) / 1e6,
                      e["name"]) for e in self.events]
            spans += [(a, b, n) for n, a, b in self.spans]
            return name_gaps([(to_host(a), to_host(b), (b - a) / 1e6)
                              for a, b in gaps], spans)
    return PartsCapture


def parts(r) -> dict:
    """The five quantities and the sums they come from, for the traced
    window's readings ``r`` (None where the program kept no parts)."""
    kept = r["drain_segments"] > 0
    out = {name: read(r) if kept else None for name, read in READERS.items()}
    events = _events(r, "event_seconds")
    own = {"events": events, "grants": r["grant_seconds"],
           "scalar route": r["scalar_seconds"],
           "idle skips": r["idle_seconds"],
           "segment bookkeeping": _bookkeeping(r),
           "stream": r["stream_s"], "matcher": r["matcher_s"],
           "mirror": r["rebuild_s"] + r["patch_s"],
           "replan": r["replan_seconds"],
           "loop": r["step_seconds"] - r["drain_s"] - events}
    gaps = r["device"]["gap_names"]
    idle = r["device"]["window_s"] - r["device"]["busy_s"]
    out.update({
        "self_s": own if kept else None,
        "self_sum_s": sum(own.values()) if kept else None,
        "step_until_s": r["step_until_s"],
        "counts": {k: r[k] for k in r if k.startswith("events.")
                   or k in ("grants", "scalar_segments", "scalar_rows",
                            "head_misses", "vector_segments",
                            "vector_rows", "idle_skips", "idle_rows",
                            "drain_segments", "decided", "matcher_calls",
                            "replans")},
        "idle_gaps": dict(sorted(gaps.items(), key=lambda kv: -kv[1])),
        "idle_named_s": sum(gaps.values()), "idle_s": idle,
        "window_s": r["window_s"],
        "decided_per_s": r["decided"] / r["window_s"],
        "trace_events": r["trace_events"],
        "peak_rss_bytes": resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss * 1024})
    return out


def run(workload: str, seed: int, seconds: float, with_sim: bool = True,
        device=None, overrides=None) -> dict:
    """One traced run with the additions above; its result line's object
    with ``parts`` added."""
    sys.path.insert(0, str(HERE))
    sys.path.insert(0, str(HERE.parent / "src"))
    import harness
    import program
    import tracing
    base_counters, base_capture = program.counters, tracing.Capture
    got: dict = {}
    program.counters = counters(base_counters)
    tracing.Capture = capture_class(base_capture, with_sim, got)
    try:
        res = harness.run_cell(workload, seed, seconds, True,
                               time.perf_counter(), device=device,
                               overrides=overrides)
    finally:
        program.counters, tracing.Capture = base_counters, base_capture
    res["parts"] = parts(got["r"])
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--sim", type=int, choices=(0, 1), default=1)
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    # the layout run.py reads (one string-hash seed), one host thread
    if os.environ.get("PYTHONHASHSEED") != "0":
        os.environ["PYTHONHASHSEED"] = "0"
        os.execv(sys.executable, [sys.executable] + sys.argv)
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ.setdefault(var, "1")
    import torch
    if args.device is None and not torch.cuda.is_available():
        print("no CUDA device (--device cpu for the host path)",
              file=sys.stderr)
        return 2
    res = run(args.workload, args.seed, args.seconds, bool(args.sim),
              device=args.device)
    for line in res.pop("_log"):
        print(line, file=sys.stderr, flush=True)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
