"""Process-local metrics registry: counters, gauges, log-bucket histograms.

Like the tracer (``repro_torch.obs.trace``), the registry is a process-global read
through a module attribute: ``REGISTRY`` is the :data:`NULL_REGISTRY`
singleton (``enabled`` False, every method a no-op) until
:func:`repro_torch.obs.enable` installs a live :class:`MetricsRegistry`.
Instrumentation sites either call the no-op methods directly or guard a
slightly more expensive record with ``if reg.enabled:``.

Histograms use log-spaced buckets (``buckets_per_decade`` per factor of 10
between ``lo`` and ``hi``, plus underflow/overflow), so p50/p95/p99 of
long-tailed latencies are cheap — O(buckets) memory regardless of sample
count — and two histograms with the same layout merge by adding counts.
Percentiles are estimated as the geometric midpoint of the bucket containing
the target rank, clamped to the exactly-tracked ``[min, max]`` observed
range, so single-value histograms report that value exactly.

``record(value, n=k)`` adds a weighted observation: the simulator uses this
to attribute a drain segment's wall time across its ``k`` check-ins without
timing each check-in individually (observe, don't perturb).

Export: ``snapshot()`` → plain dict; ``write_jsonl(path)`` appends one JSON
object per metric, tagged with ``kind`` — the ``m.jsonl`` format read back by
``python -m repro_torch.obs summarize``.
"""
from __future__ import annotations

import json
import math
from typing import Dict, List, Optional

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "NULL_REGISTRY", "NullRegistry", "REGISTRY", "merge_records",
           "read_jsonl"]


class Counter:
    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        self.value += amount

    def snapshot(self) -> dict:
        return {"kind": "counter", "name": self.name, "value": self.value}


class Gauge:
    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = float(value)

    def snapshot(self) -> dict:
        return {"kind": "gauge", "name": self.name, "value": self.value}


class Histogram:
    """Log-spaced-bucket histogram with exact min/max/sum tracking.

    Bucket ``i`` (0-based, after the underflow bucket) covers
    ``[lo * 10**(i/bpd), lo * 10**((i+1)/bpd))``.  Values below ``lo`` land
    in the underflow bucket, values ``>= hi`` in the overflow bucket.
    Non-positive and non-finite values are clamped into underflow/overflow
    (a histogram of latencies never raises mid-run).
    """

    __slots__ = ("name", "lo", "hi", "bpd", "_log_lo", "counts",
                 "count", "total", "vmin", "vmax")

    def __init__(self, name: str, lo: float = 1e-7, hi: float = 1e3,
                 buckets_per_decade: int = 10):
        if not (lo > 0.0 and hi > lo):
            raise ValueError(f"need 0 < lo < hi, got lo={lo} hi={hi}")
        self.name = name
        self.lo = lo
        self.hi = hi
        self.bpd = buckets_per_decade
        self._log_lo = math.log10(lo)
        n_mid = int(math.ceil((math.log10(hi) - self._log_lo) * buckets_per_decade))
        # [underflow] + n_mid log-spaced + [overflow]
        self.counts = [0] * (n_mid + 2)
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    def _index(self, value: float) -> int:
        if not (value > 0.0) or math.isnan(value):  # <=0, nan -> underflow
            return 0
        if math.isinf(value) or value >= self.hi:
            return len(self.counts) - 1
        if value < self.lo:
            return 0
        i = int((math.log10(value) - self._log_lo) * self.bpd)
        return min(i + 1, len(self.counts) - 2)

    def record(self, value: float, n: int = 1) -> None:
        """Add ``n`` observations of ``value`` (weighted recording)."""
        value = float(value)
        self.counts[self._index(value)] += n
        self.count += n
        if not math.isnan(value):
            self.total += value * n
            if value < self.vmin:
                self.vmin = value
            if value > self.vmax:
                self.vmax = value

    def _bucket_bounds(self, i: int):
        """(lo, hi) of bucket ``i``; underflow/overflow use observed extremes."""
        if i == 0:
            return (self.vmin if math.isfinite(self.vmin) else 0.0, self.lo)
        if i == len(self.counts) - 1:
            return (self.hi, self.vmax if math.isfinite(self.vmax) else self.hi)
        lo = 10.0 ** (self._log_lo + (i - 1) / self.bpd)
        hi = 10.0 ** (self._log_lo + i / self.bpd)
        return (lo, hi)

    def percentile(self, q: float) -> float:
        """Estimate the q-th percentile (q in [0, 100]) as the geometric
        midpoint of the covering bucket, clamped to observed [min, max]."""
        if self.count == 0:
            return float("nan")
        rank = q / 100.0 * self.count
        acc = 0
        idx = len(self.counts) - 1
        for i, c in enumerate(self.counts):
            acc += c
            if acc >= rank and c > 0:
                idx = i
                break
        blo, bhi = self._bucket_bounds(idx)
        if blo <= 0.0:
            mid = bhi / 2.0
        else:
            mid = math.sqrt(blo * bhi)
        return max(self.vmin, min(self.vmax, mid))

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else float("nan")

    def merge(self, other: "Histogram") -> None:
        """Add ``other``'s counts into this histogram.

        Raises :class:`ValueError` (never silently misbins) when the bucket
        layouts differ — (lo, hi, buckets_per_decade) mismatch, or a bucket
        count array of the wrong length (e.g. a corrupted snapshot)."""
        if (other.lo, other.hi, other.bpd) != (self.lo, self.hi, self.bpd) \
                or len(other.counts) != len(self.counts):
            raise ValueError(
                f"cannot merge histogram {other.name!r} into {self.name!r}: "
                f"bucket layouts differ — (lo, hi, buckets_per_decade, "
                f"n_buckets) {(self.lo, self.hi, self.bpd, len(self.counts))}"
                f" vs {(other.lo, other.hi, other.bpd, len(other.counts))}")
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.count += other.count
        self.total += other.total
        self.vmin = min(self.vmin, other.vmin)
        self.vmax = max(self.vmax, other.vmax)

    def snapshot(self) -> dict:
        return {
            "kind": "histogram", "name": self.name,
            "lo": self.lo, "hi": self.hi, "buckets_per_decade": self.bpd,
            "counts": list(self.counts), "count": self.count,
            "sum": self.total,
            "min": self.vmin if math.isfinite(self.vmin) else None,
            "max": self.vmax if math.isfinite(self.vmax) else None,
            "p50": self.percentile(50), "p95": self.percentile(95),
            "p99": self.percentile(99),
        }

    @classmethod
    def from_snapshot(cls, snap: dict) -> "Histogram":
        h = cls(snap["name"], lo=snap["lo"], hi=snap["hi"],
                buckets_per_decade=snap["buckets_per_decade"])
        h.counts = list(snap["counts"])
        h.count = snap["count"]
        h.total = snap["sum"]
        h.vmin = snap["min"] if snap["min"] is not None else math.inf
        h.vmax = snap["max"] if snap["max"] is not None else -math.inf
        return h


class NullRegistry:
    """Disabled registry: the chain ``reg.counter(n).inc()`` is all no-ops."""

    __slots__ = ()
    enabled = False

    def counter(self, name: str) -> "NullRegistry":
        return self

    def gauge(self, name: str) -> "NullRegistry":
        return self

    def histogram(self, name: str, **kw) -> "NullRegistry":
        return self

    def inc(self, amount: float = 1.0) -> None:
        pass

    def set(self, value: float) -> None:
        pass

    def record(self, value: float, n: int = 1) -> None:
        pass


NULL_REGISTRY = NullRegistry()

# the process-global registry; instrumentation sites read this attribute
REGISTRY = NULL_REGISTRY


class MetricsRegistry:
    """Live registry: get-or-create named metrics, snapshot/export them."""

    enabled = True

    def __init__(self):
        self._metrics: Dict[str, object] = {}

    def counter(self, name: str) -> Counter:
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = Counter(name)
        return m

    def gauge(self, name: str) -> Gauge:
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = Gauge(name)
        return m

    def histogram(self, name: str, lo: float = 1e-7, hi: float = 1e3,
                  buckets_per_decade: int = 10) -> Histogram:
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = Histogram(
                name, lo=lo, hi=hi, buckets_per_decade=buckets_per_decade)
        return m

    def get(self, name: str):
        return self._metrics.get(name)

    def names(self) -> List[str]:
        return sorted(self._metrics)

    def snapshot(self) -> List[dict]:
        return [self._metrics[n].snapshot() for n in sorted(self._metrics)]

    def write_jsonl(self, path: str, mode: str = "a",
                    extra: Optional[List[dict]] = None) -> str:
        """Append one JSON object per metric (plus ``extra`` records, e.g.
        per-job timeline rows) — the ``m.jsonl`` summarize format."""
        with open(path, mode) as fh:
            for snap in self.snapshot():
                fh.write(json.dumps(snap) + "\n")
            for rec in (extra or ()):
                fh.write(json.dumps(rec) + "\n")
        return path


def merge_records(streams: List[List[dict]]) -> List[dict]:
    """Merge several metrics-JSONL record lists into one snapshot list.

    Counters with the same name sum; gauges take the last value seen (a
    gauge is a point-in-time reading — summing would be meaningless);
    histograms merge bucket-wise via :meth:`Histogram.merge`, which raises
    on layout mismatch.  Non-metric records (timelines, audit rows) are
    skipped and counted in the trailing ``kind="merge_info"`` record.
    """
    counters: Dict[str, float] = {}
    gauges: Dict[str, float] = {}
    hists: Dict[str, Histogram] = {}
    skipped = 0
    inputs = 0
    for recs in streams:
        inputs += 1
        for rec in recs:
            kind = rec.get("kind")
            if kind == "counter":
                counters[rec["name"]] = counters.get(rec["name"], 0.0) \
                    + rec["value"]
            elif kind == "gauge":
                gauges[rec["name"]] = rec["value"]
            elif kind == "histogram":
                h = Histogram.from_snapshot(rec)
                if rec["name"] in hists:
                    hists[rec["name"]].merge(h)
                else:
                    hists[rec["name"]] = h
            else:
                skipped += 1
    out: List[dict] = []
    for name in sorted(counters):
        out.append({"kind": "counter", "name": name, "value": counters[name]})
    for name in sorted(gauges):
        out.append({"kind": "gauge", "name": name, "value": gauges[name]})
    for name in sorted(hists):
        out.append(hists[name].snapshot())
    out.append({"kind": "merge_info", "inputs": inputs,
                "merged": len(out), "skipped_records": skipped})
    return out


def read_jsonl(path: str) -> List[dict]:
    """Read a metrics JSONL file back into a list of records (blank lines
    skipped)."""
    out = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out
