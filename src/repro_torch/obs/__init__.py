"""repro_torch.obs — zero-overhead-when-disabled observability for the repro.

Four pieces, one switch:

* :mod:`repro_torch.obs.trace` — span/event tracer → Chrome trace-event JSON
  (open in Perfetto: https://ui.perfetto.dev);
* :mod:`repro_torch.obs.metrics` — counters / gauges / log-bucket histograms
  (cheap mergeable p50/p95/p99) → metrics JSONL;
* :mod:`repro_torch.obs.audit` — the scheduler flight recorder (replan, grant
  and queue-position records → audit JSONL);
* :mod:`repro_torch.obs.timeline` — per-job JCT decomposition (Fig. 11-style).

Instrumented modules fetch the globals lazily::

    from ..obs import trace as _trace, metrics as _metrics
    ...
    tr = _trace.TRACER
    if tr.enabled:
        tok = tr.begin("sim.drain", cat="sim")
        ...
        tr.end(tok, rows=rows)

When disabled (the default) ``TRACER``/``REGISTRY`` are null singletons:
the cost at an instrumentation site is one module-attribute fetch plus a
bool test — no allocation, no clock read, no branch into slow code.  The
invariant enforced by ``tests/test_obs.py``: enabling observability never
changes simulation outcomes (``SimMetrics`` stays bit-identical on both
drain engines), and disabling it leaves ``bench_hotpath`` wall time within
noise (<2%).

Use :func:`enable`/:func:`disable` or the :func:`session` context manager::

    with obs.session(tracing=True, metrics=True) as (tracer, registry):
        run(...)
        tracer.write("t.json")
        registry.write_jsonl("m.jsonl")

``python -m repro_torch.obs summarize t.json [m.jsonl]`` prints top-spans by
self-time, histogram percentile tables, and per-job timelines; its other
verbs (``validate``, ``timeline``, ``contention``, ``audit``, ``merge``) are
listed in :mod:`repro_torch.obs.__main__`.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Optional

from . import audit as _audit_mod
from . import metrics as _metrics_mod
from . import trace as _trace_mod
from .audit import (AuditRecorder, DEFAULT_GRANT_SAMPLE, NULL_AUDIT,
                    read_audit)
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      NULL_REGISTRY, merge_records, read_jsonl)
from .timeline import (JobTimeline, RoundSlice, build_timelines,
                       render_timelines, timeline_records)
from .trace import NULL_TRACER, Tracer, load_trace, validate_trace

__all__ = [
    "AuditRecorder", "Counter", "Gauge", "Histogram", "JobTimeline",
    "MetricsRegistry", "RoundSlice", "Tracer", "build_timelines", "disable",
    "enable", "get_audit", "get_registry", "get_tracer", "load_trace",
    "merge_records", "read_audit", "read_jsonl", "render_timelines",
    "session", "timeline_records", "validate_trace",
]


def enable(tracing: bool = True, metrics: bool = True,
           max_events: int = 1_000_000,
           categories=None,
           audit: bool = False,
           grant_sample: int = DEFAULT_GRANT_SAMPLE):
    """Install a live tracer and/or registry as the process globals.

    Returns ``(tracer, registry)`` — the null singletons for whichever side
    stays disabled.  Idempotent in the sense that each call installs *fresh*
    instances (previous events/metrics are not carried over); pair with
    :func:`disable` or use :func:`session`.

    ``audit=True`` additionally installs a scheduler flight recorder
    (:class:`~repro_torch.obs.audit.AuditRecorder`; fetch it with
    :func:`get_audit`, export with ``write_jsonl``).  ``grant_sample``
    audits every Nth round-opening grant — 1 (the default) records one
    grant per round.
    """
    if tracing:
        _trace_mod.TRACER = Tracer(max_events=max_events,
                                   categories=categories)
    if metrics:
        _metrics_mod.REGISTRY = MetricsRegistry()
    if audit:
        _audit_mod.AUDIT = AuditRecorder(grant_sample=grant_sample)
    return _trace_mod.TRACER, _metrics_mod.REGISTRY


def disable() -> None:
    """Restore the null singletons (drops any recorded events/metrics that
    were not exported)."""
    _trace_mod.TRACER = NULL_TRACER
    _metrics_mod.REGISTRY = NULL_REGISTRY
    _audit_mod.AUDIT = NULL_AUDIT


def get_tracer():
    return _trace_mod.TRACER


def get_registry():
    return _metrics_mod.REGISTRY


def get_audit():
    return _audit_mod.AUDIT


@contextmanager
def session(tracing: bool = True, metrics: bool = True,
            max_events: int = 1_000_000,
            categories=None,
            audit: bool = False,
            grant_sample: int = DEFAULT_GRANT_SAMPLE):
    """Scoped observability: enable on entry, always disable on exit.

    Export inside the block — exiting drops unexported state::

        with obs.session() as (tr, reg):
            run(...)
            tr.write("t.json")

    With ``audit=True`` the flight recorder is scoped too; grab it inside
    the block with :func:`get_audit` and ``write_jsonl`` before exiting.
    """
    prev_tr, prev_reg = _trace_mod.TRACER, _metrics_mod.REGISTRY
    prev_aud = _audit_mod.AUDIT
    try:
        yield enable(tracing=tracing, metrics=metrics,
                     max_events=max_events, categories=categories,
                     audit=audit, grant_sample=grant_sample)
    finally:
        _trace_mod.TRACER = prev_tr
        _metrics_mod.REGISTRY = prev_reg
        _audit_mod.AUDIT = prev_aud
