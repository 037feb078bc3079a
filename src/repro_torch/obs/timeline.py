"""Per-job JCT decomposition timelines (the paper's Fig. 11-style breakdown).

Venn's contribution is measured as a *decomposition* of job completion time:
per round, how long the request queued for devices (scheduling delay, the
quantity the scheduler controls) vs. how long responses took to collect
(response collection, the quantity devices control).  ``SimMetrics`` already
records the raw per-round events (submit → alloc-complete → quorum); this
module folds them into per-job timelines:

* :class:`RoundSlice` — one round's ``submit``/``alloc_complete``/``complete``
  triple with the derived delay/collection split;
* :class:`JobTimeline` — a job's arrival/completion bracket, its ordered
  round slices, and the JCT decomposition
  ``jct = scheduling_delay_s + response_collection_s + other_s`` (where
  *other* is time outside any round: arrival→first submit, retry gaps);
* :func:`build_timelines` — fold a finished ``SimMetrics`` (duck-typed: only
  ``rounds``/``jcts``/``_jobs`` are read) into timelines;
* :func:`timeline_records` — flatten timelines to ``kind="timeline"`` JSON
  records for the metrics JSONL;
* :func:`render_timelines` — ASCII stacked-bar rendering for the CLI
  (``#`` scheduling delay, ``=`` response collection, ``.`` other).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional

__all__ = ["JobTimeline", "RoundSlice", "build_timelines",
           "render_timelines", "timeline_records", "timelines_from_records"]


@dataclass
class RoundSlice:
    round_index: int
    submit: float
    alloc_complete: Optional[float]
    complete: float

    @property
    def scheduling_delay(self) -> float:
        end = self.complete if self.alloc_complete is None else self.alloc_complete
        return max(0.0, end - self.submit)

    @property
    def response_collection(self) -> float:
        if self.alloc_complete is None:
            return 0.0
        return max(0.0, self.complete - self.alloc_complete)


@dataclass
class JobTimeline:
    job_id: int
    arrival: float
    completion: Optional[float]        # None = censored (unfinished at end)
    jct: float                         # censored jobs: elapsed at makespan
    rounds: List[RoundSlice] = field(default_factory=list)

    @property
    def scheduling_delay_s(self) -> float:
        return sum(r.scheduling_delay for r in self.rounds)

    @property
    def response_collection_s(self) -> float:
        return sum(r.response_collection for r in self.rounds)

    @property
    def other_s(self) -> float:
        """JCT not inside any recorded round: arrival→first submit, gaps
        between a round completing and the next submitting (retry backoff,
        control-plane latency)."""
        return max(0.0, self.jct - self.scheduling_delay_s
                   - self.response_collection_s)

    def to_record(self, **tags) -> dict:
        rec = {
            "kind": "timeline",
            "job_id": self.job_id,
            "arrival": self.arrival,
            "completion": self.completion,
            "jct": self.jct,
            "scheduling_delay_s": self.scheduling_delay_s,
            "response_collection_s": self.response_collection_s,
            "other_s": self.other_s,
            "num_rounds": len(self.rounds),
            "rounds": [
                {"round": r.round_index, "submit": r.submit,
                 "alloc_complete": r.alloc_complete, "complete": r.complete}
                for r in self.rounds
            ],
        }
        rec.update(tags)
        return rec


def build_timelines(metrics) -> Dict[int, JobTimeline]:
    """Fold a finished ``SimMetrics``-like object into per-job timelines.

    Duck-typed: reads ``metrics.rounds`` (objects with ``job_id``,
    ``round_index``, ``submit``, ``alloc_complete``, ``complete``),
    ``metrics.jcts`` and, when present, ``metrics._jobs`` for arrival and
    completion times.  Jobs with no recorded rounds still get a timeline
    (all of their JCT is *other*).
    """
    arrivals: Dict[int, float] = {}
    completions: Dict[int, Optional[float]] = {}
    for j in getattr(metrics, "_jobs", ()) or ():
        arrivals[j.job_id] = j.arrival_time
        completions[j.job_id] = j.completion_time

    out: Dict[int, JobTimeline] = {}
    for jid, jct in sorted(metrics.jcts.items()):
        arr = arrivals.get(jid, 0.0)
        out[jid] = JobTimeline(job_id=jid, arrival=arr,
                               completion=completions.get(jid), jct=jct)
    for r in metrics.rounds:
        tl = out.get(r.job_id)
        if tl is None:   # round for a job missing from jcts: synthesize
            tl = out[r.job_id] = JobTimeline(
                job_id=r.job_id, arrival=r.submit, completion=None,
                jct=r.complete - r.submit)
        tl.rounds.append(RoundSlice(
            round_index=r.round_index, submit=r.submit,
            alloc_complete=r.alloc_complete, complete=r.complete))
    for tl in out.values():
        tl.rounds.sort(key=lambda s: (s.submit, s.round_index))
    return out


def timeline_records(metrics, **tags) -> List[dict]:
    """Timelines as JSONL-ready records, tagged (e.g. scenario/sched/seed)."""
    return [tl.to_record(**tags)
            for tl in build_timelines(metrics).values()]


def timelines_from_records(records: Iterable[dict]) -> List[JobTimeline]:
    """Rebuild timelines from ``kind="timeline"`` JSONL records."""
    out = []
    for rec in records:
        if rec.get("kind") != "timeline":
            continue
        tl = JobTimeline(job_id=rec["job_id"], arrival=rec["arrival"],
                         completion=rec.get("completion"), jct=rec["jct"])
        for r in rec.get("rounds", ()):
            tl.rounds.append(RoundSlice(
                round_index=r["round"], submit=r["submit"],
                alloc_complete=r.get("alloc_complete"),
                complete=r["complete"]))
        out.append(tl)
    return out


def render_timelines(timelines, width: int = 48) -> str:
    """ASCII Fig. 11-style stacked bars, one row per job.

    ``#`` scheduling delay · ``=`` response collection · ``.`` other;
    bars share one scale (longest JCT = full width).  ``*`` marks censored
    (unfinished) jobs.
    """
    if isinstance(timelines, dict):
        tls = [timelines[k] for k in sorted(timelines)]
    else:
        tls = sorted(timelines, key=lambda t: t.job_id)
    if not tls:
        return "(no jobs)"
    max_jct = max((t.jct for t in tls), default=0.0) or 1.0
    lines = [
        "JCT decomposition  (# sched delay · = response collection · . other)",
        f"{'job':>6} {'jct_s':>12} {'sched%':>7} {'resp%':>7}  bar",
    ]
    for t in tls:
        n = max(1, int(round(width * t.jct / max_jct)))
        n_sched = int(round(n * (t.scheduling_delay_s / t.jct))) if t.jct else 0
        n_resp = int(round(n * (t.response_collection_s / t.jct))) if t.jct else 0
        n_sched = min(n_sched, n)
        n_resp = min(n_resp, n - n_sched)
        bar = "#" * n_sched + "=" * n_resp + "." * (n - n_sched - n_resp)
        pct_s = 100.0 * t.scheduling_delay_s / t.jct if t.jct else 0.0
        pct_r = 100.0 * t.response_collection_s / t.jct if t.jct else 0.0
        mark = "*" if t.completion is None else " "
        lines.append(
            f"{t.job_id:>6} {t.jct:>12.1f} {pct_s:>6.1f}% {pct_r:>6.1f}% "
            f"{mark}{bar}")
    if any(t.completion is None for t in tls):
        lines.append("  * = unfinished at end of run (censored JCT)")
    return "\n".join(lines)
