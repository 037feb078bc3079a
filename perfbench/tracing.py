"""The traced run's capture: what the per-layer readers read.

Over the traced window (the first :data:`TRACE_WINDOW_S` seconds of the
measured window, cut at a slice boundary) it records:

* the program's own counters, as deltas over the window: check-ins decided,
  the simulator's drain and stream wall seconds, the matcher's calls and
  seconds, the mirror's rebuild and patch seconds;
* the program's spans of category ``sched`` and ``accel`` (``venn.replan``,
  ``accel.match``, ``accel.state_delta``, ``accel.state_rebuild``), through
  its own tracer; each ``accel.match`` span carries the rows of the segment
  the drain handed to the matcher;
* spans of the benchmark's own around calls into the program: each
  ``step_until`` slice and each chunk the simulator loads (``stream``);
* the arguments of each call into the two kernels, kept as they are
  (the engine's stopwatch times the matcher's call) and turned into the
  launch's shapes (rows, slots, requests, atoms) once the window closed;
* ``torch.profiler``'s device trace (kernels, copies, sets; device
  activity only), exported by the profiler and read here, with two marker
  kernels that tie its clock to the host's.

The profiler's own bookkeeping grows with the events it records, so the
window is kept short; a rate read over it holds for the cell, since every
slice of an episode runs the same code.
"""
from __future__ import annotations

import bisect
import json
import os
import time
from contextlib import contextmanager

TRACE_WINDOW_S = 10.0
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
MARKER = "spin_kernel"
DEFAULT_GAP = "drain loop and grants"
OUTSIDE = "harness (between slices)"


class Capture:
    def __init__(self, out_path: str, counters, device):
        self.out_path = out_path
        self.device = device
        self.counters = counters        # () -> dict of summed counters
        self.active = False
        self.ok = False
        self._undo = []

    # ------------------------------------------------------------ control

    def start(self) -> None:
        """Start tracing; the traced window opens when this returns (the
        profiler's own start-up stays outside it)."""
        from torch.profiler import ProfilerActivity, profile
        from repro_torch import obs
        self.spans = []                 # (name, t0, t1) on perf_counter
        self.calls = {"match_segment": [], "segmented_order": []}
        self._wrap_launches()
        self.tracer, _ = obs.enable(tracing=True, metrics=False,
                                    categories={"sched", "accel"},
                                    max_events=2_000_000)
        self.prof = profile(activities=[
            ProfilerActivity.CUDA if self.device.type == "cuda"
            else ProfilerActivity.CPU])
        self.prof.__enter__()
        self.mark0 = self._mark()
        self.c0 = self.counters()
        self.t0 = time.perf_counter()
        self.active = True

    def stop(self) -> None:
        from repro_torch import obs
        self._sync()
        self.t1 = time.perf_counter()
        self.c1 = self.counters()
        self.mark1 = self._mark()
        self.prof.__exit__(None, None, None)
        self.events = [e for e in self.tracer.events if e.get("ph") == "X"]
        self.tracer_t0 = self.tracer._t0
        obs.disable()
        for undo in self._undo:
            undo()
        self.active = False
        t = time.perf_counter()
        self.prof.export_chrome_trace(self.out_path)
        self.export_s = time.perf_counter() - t
        with open(self.out_path) as f:
            self.trace_events = json.load(f).get("traceEvents", [])
        os.remove(self.out_path)
        # the profiler now and then records no device activity at all (a
        # trace without the marker kernels): the caller traces again
        self.ok = self.device.type != "cuda" or len(self._marks()) >= 2

    def _marks(self):
        return sorted(e["ts"] for e in self.trace_events
                      if e.get("cat") == "kernel"
                      and MARKER in e.get("name", ""))

    def due(self, now: float) -> bool:
        """True once the traced window has run its length."""
        return self.active and now - self.t0 >= TRACE_WINDOW_S

    def _sync(self) -> None:
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _mark(self) -> float:
        """A marker kernel launched on an idle device at a known host
        time: it ties the profiler's clock to the host's (the launch's
        latency, some microseconds, is the error)."""
        import torch
        if self.device.type != "cuda":
            return time.perf_counter()
        torch.cuda.synchronize(self.device)
        t = time.perf_counter()
        torch.cuda._sleep(100)
        torch.cuda.synchronize(self.device)
        return t

    @contextmanager
    def span(self, name: str):
        if not self.active:
            yield
            return
        t = time.perf_counter()
        try:
            yield
        finally:
            self.spans.append((name, t, time.perf_counter()))

    def watch(self, episode) -> None:
        """Span each chunk the episode's simulator loads (its stream and
        classification) while the capture runs."""
        sim = episode.sim
        inner = sim._load_next_chunk
        cap = self

        def load_next_chunk():
            if not cap.active:
                return inner()
            t = time.perf_counter()
            try:
                return inner()
            finally:
                cap.spans.append(("stream.chunk_load", t,
                                  time.perf_counter()))

        sim._load_next_chunk = load_next_chunk

    def _wrap_launches(self) -> None:
        """Keep each launch's arguments as they are: the engine's own
        stopwatch times the call into the matcher, so nothing is worked
        out from them until :meth:`readings`."""
        from repro_torch.accel import engine
        from repro_torch.accel.kernels import replan_order
        match = engine.match_chunk_torch
        order = replan_order.segmented_order_staged
        calls = self.calls

        def match_chunk_torch(atom_ids, speeds, state, *a, **kw):
            calls["match_segment"].append(
                (atom_ids, len(state.remaining), state.d_cand_req.shape[1],
                 kw.get("live") is not None))
            return match(atom_ids, speeds, state, *a, **kw)

        def segmented_order_staged(keys, ties, device):
            calls["segmented_order"].append(len(keys))
            return order(keys, ties, device)

        engine.match_chunk_torch = match_chunk_torch
        replan_order.segmented_order_staged = segmented_order_staged
        self._undo = [
            lambda: setattr(engine, "match_chunk_torch", match),
            lambda: setattr(replan_order, "segmented_order_staged", order)]

    def _shapes(self) -> dict:
        """Each launch's shapes (rows, slots, requests, distinct atoms,
        live rows sent), from the arguments kept in the window."""
        import numpy as np
        match = [(len(ids), int(k), r, len(np.unique(ids)), live)
                 for ids, r, k, live in self.calls["match_segment"]
                 if len(ids) and r]
        order = [n for n in self.calls["segmented_order"] if n]
        return {"match_segment": match, "segmented_order": order}

    # ------------------------------------------------------------ reading

    def readings(self) -> dict:
        """Everything the per-layer readers take, for the traced window."""
        if not self.ok:
            raise RuntimeError("the profiler recorded no device activity "
                               "in any traced window of the run")
        d = {k: self.c1[k] - self.c0.get(k, 0) for k in self.c1}
        d["window_s"] = self.t1 - self.t0
        reps = [e for e in self.events if e["name"] == "venn.replan"]
        d["replans"] = len(reps)
        d["replan_s"] = sum(e["dur"] for e in reps) / 1e6
        # a segment the engine sent back for a wider export is handed over
        # again after the rebuild, and counted there
        d["matcher_route_rows"] = sum(
            e["args"]["rows"] for e in self.events
            if e["name"] == "accel.match"
            and e["args"].get("outcome") != "need_wider_export")
        d["shapes"] = self._shapes()
        d["device"] = self._device()
        d["trace_export_s"] = self.export_s
        return d

    def _device(self) -> dict:
        evs = self.trace_events
        marks = self._marks()
        if len(marks) < 2:          # no device trace (a run on the CPU)
            marks = [self.mark0 * 1e6, self.mark1 * 1e6]
        # profiler clock (us) = host perf_counter * 1e6 + offset, the
        # offset drifting linearly between the two markers
        off0 = marks[0] - self.mark0 * 1e6
        off1 = marks[-1] - self.mark1 * 1e6
        span = max(self.mark1 - self.mark0, 1e-9)

        def to_dev(t):
            return t * 1e6 + off0 + (off1 - off0) * (t - self.mark0) / span

        def to_host(u):
            # invert to_dev (linear in t)
            a = 1e6 + (off1 - off0) / span
            return (u - off0 + (off1 - off0) * self.mark0 / span) / a

        lo, hi = to_dev(self.t0), to_dev(self.t1)
        dev = [(e["ts"], e["ts"] + e.get("dur", 0.0), e["name"])
               for e in evs if e.get("cat") in DEVICE_CATS
               and e.get("ph") == "X"]
        dev = [(max(a, lo), min(b, hi), n) for a, b, n in dev
               if b > lo and a < hi]
        kernels: dict = {}
        for a, b, n in dev:
            k = kernels.setdefault(n, [0, 0.0])
            k[0] += 1
            k[1] += (b - a) / 1e6
        # busy time: the union of the device intervals
        busy = 0.0
        gaps = []
        cur = lo
        for a, b, _ in sorted(dev):
            if a > cur:
                gaps.append((cur, a))
            if b > cur:
                busy += b - max(a, cur)
                cur = b
        if hi > cur:
            gaps.append((cur, hi))
        return {"busy_s": busy / 1e6, "window_s": (hi - lo) / 1e6,
                "kernels": kernels, "gap_names": self._name_gaps(gaps, to_host),
                "clock_drift_us": off1 - off0}

    def _name_gaps(self, gaps, to_host) -> dict:
        """Idle seconds by the host span the gap's midpoint fell in, on the
        host's clock: a span of the program's or a chunk load if one
        covers it, else the drain loop if a ``step_until`` slice does,
        else the harness between slices.  The inner spans do not nest."""
        t0 = self.tracer_t0
        inner = [(t0 + e["ts"] / 1e6, t0 + (e["ts"] + e["dur"]) / 1e6,
                  e["name"]) for e in self.events]
        inner += [(a, b, n) for n, a, b in self.spans
                  if n != "sim.step_until"]
        inner.sort()
        outer = sorted((a, b) for n, a, b in self.spans
                       if n == "sim.step_until")
        i_starts = [s[0] for s in inner]
        o_starts = [s[0] for s in outer]
        out: dict = {}
        for a, b in gaps:
            mid = to_host((a + b) / 2)
            i = bisect.bisect_right(i_starts, mid) - 1
            j = bisect.bisect_right(o_starts, mid) - 1
            if i >= 0 and inner[i][1] >= mid:
                name = inner[i][2]
            elif j >= 0 and outer[j][1] >= mid:
                name = DEFAULT_GAP
            else:
                name = OUTSIDE
            out[name] = out.get(name, 0.0) + (b - a) / 1e6
        return out
