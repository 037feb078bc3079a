"""Span/event tracer exporting Chrome trace-event JSON (Perfetto-loadable).

The tracer is a process-global: instrumentation sites read the module
attribute ``TRACER``, which is the :data:`NULL_TRACER` singleton until
:func:`repro_torch.obs.enable` swaps a real :class:`Tracer` in.  The contract that
keeps the hot path free:

* **disabled** — ``TRACER`` is :data:`NULL_TRACER` (``enabled`` is False);
  guarded sites cost one module-attribute lookup plus a bool check, and the
  unguarded convenience API (``span``/``begin``/``end``/``instant``) is a
  no-op method on a ``__slots__ = ()`` singleton.  No event storage exists.
* **enabled** — spans/instants are appended to an in-memory list of Chrome
  trace events (``ph="X"`` complete spans with microsecond ``ts``/``dur`` on
  the tracer's monotonic clock, ``ph="i"`` instants), tagged with the
  emitting thread id.  Instrumentation only ever *reads* simulation state, so
  enabling tracing never changes scheduling outcomes — ``SimMetrics`` stays
  bit-identical (enforced by ``tests/test_obs.py``).

Timestamps use ``time.perf_counter`` (monotonic), zeroed at tracer creation.
``begin``/``end`` returns an explicit token so spans can cross ``return``
statements without a ``with`` block; ``span`` is the context-manager form.
An event cap (``max_events``) bounds memory on pathological runs — overflow
is dropped and counted, never raised.  ``categories`` restricts recording to
a set of span categories (e.g. ``{"sched"}`` to record only replan spans on
an otherwise expensive run).

Export: ``write(path)`` dumps ``{"traceEvents": [...]}`` — the JSON object
format of the Chrome trace-event spec, loadable in Perfetto
(https://ui.perfetto.dev) or ``chrome://tracing``.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional

__all__ = ["NULL_SPAN", "NULL_TRACER", "NullTracer", "Tracer", "TRACER",
           "load_trace", "validate_trace"]

_VALID_PH = frozenset("XBEiIMC")


class _NullSpan:
    """Reusable no-op context manager returned by the disabled tracer."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def add(self, **args) -> None:
        pass


NULL_SPAN = _NullSpan()


class NullTracer:
    """Disabled tracer: every method is a no-op, nothing is allocated."""

    __slots__ = ()
    enabled = False

    def span(self, name: str, cat: str = "repro", **args) -> _NullSpan:
        return NULL_SPAN

    def begin(self, name: str, cat: str = "repro", **args) -> None:
        return None

    def end(self, token, **args) -> None:
        pass

    def instant(self, name: str, cat: str = "repro", **args) -> None:
        pass

    def complete(self, name: str, start_us: float, dur_us: float,
                 cat: str = "repro", **args) -> None:
        pass

    def now_us(self) -> float:
        return 0.0

    def us(self, t: float) -> float:
        return 0.0


NULL_TRACER = NullTracer()

# the process-global tracer; instrumentation sites read this attribute
TRACER = NULL_TRACER


class _Span:
    """Context-manager span (the ``with tracer.span(...)`` form)."""

    __slots__ = ("_tr", "_tok")

    def __init__(self, tr: "Tracer", name: str, cat: str, args: dict):
        self._tr = tr
        self._tok = tr.begin(name, cat, **args)

    def add(self, **args) -> None:
        if self._tok is not None:
            self._tok[2].update(args)

    def __enter__(self) -> "_Span":
        return self

    def __exit__(self, etype, exc, tb) -> bool:
        if etype is not None and self._tok is not None:
            self._tok[2]["error"] = etype.__name__
        self._tr.end(self._tok)
        return False


class Tracer:
    """Recording tracer: spans + instants into Chrome trace-event dicts."""

    enabled = True

    def __init__(self, max_events: int = 1_000_000,
                 categories=None,
                 clock=time.perf_counter):
        self._clock = clock
        self._t0 = clock()
        self.pid = os.getpid()
        self.events: List[dict] = []
        self.max_events = max_events
        self.dropped = 0
        self.categories = frozenset(categories) if categories else None

    # ------------------------------------------------------------- clocks

    def now_us(self) -> float:
        """Microseconds since tracer creation (monotonic)."""
        return (self._clock() - self._t0) * 1e6

    def us(self, t: float) -> float:
        """Convert a raw ``perf_counter`` timestamp to tracer microseconds."""
        return (t - self._t0) * 1e6

    # -------------------------------------------------------------- spans

    def span(self, name: str, cat: str = "repro", **args) -> _Span:
        return _Span(self, name, cat, args)

    def begin(self, name: str, cat: str = "repro", **args):
        """Open a span; returns a token for :meth:`end` (None if the span's
        category is filtered out — ``end(None)`` is a no-op)."""
        if self.categories is not None and cat not in self.categories:
            return None
        return [name, cat, args, self._clock(), threading.get_ident()]

    def end(self, token, **args) -> None:
        if token is None:
            return
        name, cat, targs, t0, tid = token
        if args:
            targs.update(args)
        ev = {"name": name, "ph": "X", "ts": self.us(t0),
              "dur": (self._clock() - t0) * 1e6,
              "pid": self.pid, "tid": tid, "cat": cat}
        if targs:
            ev["args"] = targs
        self._emit(ev)

    def complete(self, name: str, start_us: float, dur_us: float,
                 cat: str = "repro", **args) -> None:
        """Emit a complete span from externally measured times (µs on this
        tracer's clock — see :meth:`us`)."""
        if self.categories is not None and cat not in self.categories:
            return
        ev = {"name": name, "ph": "X", "ts": start_us, "dur": dur_us,
              "pid": self.pid, "tid": threading.get_ident(), "cat": cat}
        if args:
            ev["args"] = args
        self._emit(ev)

    def instant(self, name: str, cat: str = "repro", **args) -> None:
        if self.categories is not None and cat not in self.categories:
            return
        ev = {"name": name, "ph": "i", "s": "t", "ts": self.now_us(),
              "pid": self.pid, "tid": threading.get_ident(), "cat": cat}
        if args:
            ev["args"] = args
        self._emit(ev)

    def _emit(self, ev: dict) -> None:
        if len(self.events) >= self.max_events:
            self.dropped += 1
            return
        self.events.append(ev)

    # ------------------------------------------------------------- export

    @property
    def num_events(self) -> int:
        return len(self.events)

    def export(self) -> Dict:
        """The Chrome trace-event JSON object format."""
        return {
            "traceEvents": list(self.events),
            "displayTimeUnit": "ms",
            "otherData": {"tool": "repro_torch.obs", "pid": self.pid,
                          "dropped_events": self.dropped},
        }

    def write(self, path: str) -> str:
        with open(path, "w") as fh:
            json.dump(self.export(), fh)
        return path


# --------------------------------------------------------------------------- #
# Loading / validation (the round-trip side, used by the CLI and tests)
# --------------------------------------------------------------------------- #

def load_trace(path: str) -> Dict:
    """Load a trace file; accepts both the JSON object format and a bare
    event array, normalized to ``{"traceEvents": [...]}``."""
    with open(path) as fh:
        doc = json.load(fh)
    if isinstance(doc, list):
        doc = {"traceEvents": doc}
    validate_trace(doc)
    return doc


def validate_trace(doc) -> List[dict]:
    """Validate the Chrome trace-event shape; raises ``ValueError`` with the
    first offending event.  Returns the event list."""
    if not isinstance(doc, dict):
        raise ValueError(f"trace must be a JSON object, got {type(doc).__name__}")
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        raise ValueError("trace has no 'traceEvents' array")
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            raise ValueError(f"traceEvents[{i}] is not an object")
        ph = ev.get("ph")
        if ph not in _VALID_PH:
            raise ValueError(f"traceEvents[{i}]: bad phase {ph!r}")
        if not isinstance(ev.get("name"), str):
            raise ValueError(f"traceEvents[{i}]: missing/invalid name")
        for key in ("ts", "pid", "tid"):
            if not isinstance(ev.get(key), (int, float)):
                raise ValueError(f"traceEvents[{i}]: missing/invalid {key!r}")
        if ev["ts"] < 0:
            raise ValueError(f"traceEvents[{i}]: negative ts")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                raise ValueError(f"traceEvents[{i}]: X event needs dur >= 0")
        args = ev.get("args")
        if args is not None and not isinstance(args, dict):
            raise ValueError(f"traceEvents[{i}]: args must be an object")
    return events
