"""Event-driven simulator of the multi-job collaborative-learning environment.

Implements the lifecycle of Figure 6: jobs submit per-round resource requests
(①), devices check in over time (①), the scheduler assigns one job per device
(②), devices execute and respond or drop (③–⑤).  Rounds complete when
``quorum_fraction × demand`` responses arrive before the deadline; otherwise
the round aborts and the request is resubmitted (fault tolerance is the job's
concern, §3 — the simulator models it with quorum + deadline + retry).

Control events (heapq-ordered by time, then a monotone sequence id):

* ``JOB_ARRIVAL``     — job enters, submits round-0 request
* ``RESPONSE``        — the response that completes one request's round
* ``DEADLINE``        — response-collection deadline for one request attempt
* ``FAULT``           — a blackout begins (revokes responses in flight)

**Responses are data, delivered when something reads them.**  A granted
device's response waits in its request's buffer, a min-heap of (response
time, sequence, device, ...) rows.  Its effects (``sched.on_response``, the
request's counts) are read in a few places only, and each delivers the
responses due there, in the order handling them one event each would have:
before a replan (the hook the scheduler is bound to), at a request's fill,
at its deadline and at its completing response, at a blackout's start, and
at every pause of :meth:`Simulator.step_until`, where the state and the
clock are then what one event a response left.  A round needs one control
entry at most: when the request fills, every one of its responses is in the
buffer, so the one at which the responses reach quorum is known and is armed
as its ``RESPONSE`` entry, unless the deadline comes first.  At the
deadline's very time the event model handled first the responses whose
entries it had armed before the fill pushed the deadline's; the deadline
handles those itself.  So ``on_response`` may only record what the next
replan reads: a call that marks the plan dirty raises.

Device check-ins do **not** go through the heap: they arrive as time-sorted
struct-of-arrays chunks (:class:`~repro_torch.sim.devices.DeviceChunk`) pulled from
any :class:`~repro_torch.sim.devices.ChunkStream` (synthetic generator, scenario
stream, or trace replay) and merged against the heap by timestamp.  Each chunk
is classified to interned atom ids in one vectorized pass (re-classified in
place if the scheduler's requirement set grows mid-chunk) and handed to the
scheduler via ``begin_chunk`` (which batch-feeds the supply estimator).  Two
interchangeable **drain engines** then consume the merged stream:

* ``engine=None``/``"python"`` — the scalar fast path: one ``sched.checkin``
  per live check-in.  While no request is outstanding the cursor skips
  straight to the next control event, and while the scheduler's liveness
  bitmap marks a check-in's atom *dead* the check-in is skipped without a
  scheduler call at all.
* ``engine="array"`` — the :mod:`repro_torch.accel` engine: whole drain segments
  (check-in runs between control events) are matched in one vectorized call
  against a struct-of-arrays mirror of the scheduler state, and only granted
  rows touch Python objects; short runs take a scalar route.  Grant
  sequences and metrics are bit-identical to the scalar path; uncovered
  atoms fall back to one scalar ``checkin`` (the MISS/replan protocol).

Either way a ``Device`` object is only materialized for granted check-ins,
and all grant side effects flow through the shared :meth:`Simulator._grant`.
"""
from __future__ import annotations

import gc
import heapq
import itertools
import math
import time
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from ..accel.engine import NeedWiderExport, SCALAR_SEG_ROWS, SEG_ROWS
from ..core.baselines import BaseScheduler
from ..core.types import Device, Job, JobRequest, JobStatus
from ..obs import audit as _obsaudit
from ..obs import metrics as _obsmetrics
from ..obs import trace as _obstrace
from .devices import (ChunkStream, DeviceChunk, DeviceGenerator,
                      GeneratorStream, PopulationConfig, fails_from,
                      response_time_from)
from .metrics import RoundRecord, SimMetrics

JOB_ARRIVAL, RESPONSE, DEADLINE, FAULT = 0, 1, 2, 3

# control-event kinds, indexed by event kind; their spans are
# ``sim.event.<kind>`` (repro_torch.obs taxonomy)
EVENT_KINDS = ("arrival", "response", "deadline", "fault")
_EVENT_SPAN = tuple("sim.event." + k for k in EVENT_KINDS)

# The drain's parts (:meth:`Simulator.drain_parts`): counts, and self times
# that do not overlap one another or the stream, matcher, mirror and replan
# stopwatches.  Kept only while the metrics registry is on or the tracer
# records category ``sim``; each is mirrored into the registry as the
# counter ``sim.<name>``.
_PARTS = ("step_seconds", "grants", "grant_seconds", "scalar_segments",
          "scalar_rows", "head_misses", "scalar_seconds", "vector_segments",
          "vector_rows", "idle_skips", "idle_rows", "idle_seconds",
          "drain_segments", "responses_delivered")

# raised when a delivery marks the plan dirty (see the module docstring)
_DIRTY = ("on_response marked the plan dirty: the simulator delivers "
          "responses where they are read, so response feedback may only "
          "record what the next replan reads")


@dataclass
class SimConfig:
    max_time: float = 14 * 24 * 3600.0      # hard stop (simulated seconds)
    max_round_retries: int = 12             # give up on a round after this many aborts
    seed: int = 0
    # §3 mitigation: size request demand adaptively per job from the observed
    # failure rate (OvercommitPolicy), seeded by Job.overcommit.  Off by
    # default — the static path honors Job.overcommit directly and is
    # bit-identical to the pre-policy simulator when overcommit == 1.0.
    adaptive_overcommit: bool = False


class Simulator:
    def __init__(self, jobs: List[Job], scheduler: BaseScheduler,
                 population: Optional[PopulationConfig] = None,
                 cfg: Optional[SimConfig] = None,
                 stream: Optional[ChunkStream] = None,
                 engine: Optional[str] = None,
                 record_grants: bool = False,
                 faults: Optional[object] = None,
                 device=None):
        self.jobs = jobs
        self.sched = scheduler
        self.cfg = cfg or SimConfig()
        if stream is None:
            self.devgen: Optional[DeviceGenerator] = DeviceGenerator(
                population or PopulationConfig())
            stream = GeneratorStream(self.devgen, self.cfg.max_time)
        else:
            if population is not None:
                raise ValueError("pass either population or stream, not both")
            self.devgen = getattr(stream, "gen", None)
        self.stream = stream
        if engine in (None, "python"):
            self.engine = None
        elif engine == "array":
            # the matcher on ``device`` (None: cuda:0, and an error if
            # there is none; "cpu" only when the caller asks for it)
            from ..accel.engine import ArrayMatchEngine
            self.engine = ArrayMatchEngine(device=device)
        elif hasattr(engine, "prepare") and hasattr(engine, "match"):
            self.engine = engine            # a pre-configured engine instance
        else:
            raise ValueError(f"unknown engine {engine!r} "
                             "(expected 'python', 'array', or an engine "
                             "instance)")
        # fault plan (a repro_torch.faults.plan.FaultPlan, duck-typed): the
        # simulator only consumes blackout windows for response revocation;
        # the stream-side faults live in the repro_torch.faults.injector
        # .FaultInjector that wraps ``stream`` (scenarios/runner.py::run_one)
        if faults is not None:
            faults = faults.resolve(self.cfg.max_time)
            self._fault_rng = np.random.default_rng(
                faults.seed + 0x5EED)
        else:
            self._fault_rng = None
        self.faults = faults
        self._oc_policies: dict = {}    # job_id -> OvercommitPolicy
        self._started = False
        self._finished = False
        # optional (time, job_id, round_index) log of every grant, for
        # engine-equivalence tests and debugging
        self.grant_log: Optional[list] = [] if record_grants else None
        self._seq = itertools.count()
        self._heap: List[Tuple[float, int, int, object]] = []
        self.metrics = SimMetrics()
        self.now = 0.0
        self.checkins_seen = 0        # check-ins examined by the scheduler
        self.checkins_skipped = 0     # check-ins skipped (idle or dead atom)
        self.drain_seconds = 0.0      # wall time in the drain engine (the
        #                               check-in matching loop, per engine)
        self.stream_seconds = 0.0     # wall time producing + classifying
        #                               chunks (shared, engine-independent)
        # ---- the drain's parts (_PARTS), while metrics or sim spans are on
        self._clocked = False         # this step_until call keeps them
        self.step_seconds = 0.0       # wall time inside step_until
        self.event_counts = [0] * len(EVENT_KINDS)     # control events, and
        self.event_seconds = [0.0] * len(EVENT_KINDS)  # their handling, by kind
        self.grants = 0               # _grant calls, and their wall time
        self.grant_seconds = 0.0
        self.scalar_segments = 0      # array drain's scalar route: calls of
        self.scalar_rows = 0          # _drain_array_scalar, their rows less
        self.head_misses = 0          # MISS rows, the MISS rows, and their
        self.scalar_seconds = 0.0     # self time (less grants and replans)
        self.vector_segments = 0      # segments the matcher decided (one
        self.vector_rows = 0          # engine.match each), and their rows
        self.idle_skips = 0           # idle skips, the rows they skipped,
        self.idle_rows = 0            # and their self time (less the
        self.idle_seconds = 0.0       # chunk loads inside them)
        self.drain_segments = 0       # engine.prepare calls
        self.responses_delivered = 0  # responses delivered as data (never
        #                               an event of their own)
        self.delivery_seconds = 0.0   # wall time of the deliveries before
        #                               replans, at fills and at pauses,
        #                               always kept: it is taken off the
        #                               drain's and the grants' time
        # ---- responses in flight
        self._awaiting: dict = {}     # live requests (their buffers), in
        #                               submission order
        self._due: List[float] = []   # the time of every response granted
        #                               and not yet passed (_pass): where
        #                               the event model had its entries,
        self._gone: dict = {}         # less those it never had (time ->
        #                               count), a response of a round over
        #                               or revoked that it had not armed
        scheduler.bind(self._deliver_before)

    def __setstate__(self, d):
        # the scheduler's hook is not pickled (BaseScheduler.__getstate__)
        self.__dict__.update(d)
        self.sched.bind(self._deliver_before)

    # ------------------------------------------------------------------ api

    def run(self) -> SimMetrics:
        self.start()
        return self.finish()

    def start(self) -> None:
        """Arm the event loop (idempotent).  Split from :meth:`run` so the
        simulation can be paused at arbitrary times (``step_until``),
        snapshotted, and resumed — the crash-recovery substrate."""
        if self._started:
            return
        self._started = True
        for job in self.jobs:
            self._push(job.arrival_time, JOB_ARRIVAL, job)
        if self.faults is not None:
            for b in self.faults.blackouts:
                if b.revoke_in_flight and b.start <= self.cfg.max_time:
                    self._push(b.start, FAULT, b)
        self._done = 0
        self._open = 0                  # outstanding requests with remaining demand
        self._chunk: Optional[DeviceChunk] = None
        self._times: list = []          # list mirrors of the chunk arrays —
        self._cursor = 0                # Python-float indexing is ~3x cheaper
        self._chunk_version = -1        # than NumPy scalar indexing here
        self._load_next_chunk()

    def step_until(self, until: Optional[float] = None) -> bool:
        """Advance the simulation to ``min(until, cfg.max_time)``.

        Returns True when the simulation is *finished* (all jobs done, the
        event sources are exhausted, or the horizon was crossed); False means
        it paused at the bound and can be resumed (or snapshotted) there.

        The loop runs with the heap made before it frozen (``gc.freeze``):
        this process holds torch's import-time heap, several times a
        NumPy-only process's in GC-tracked objects, and a full collection
        set off inside the loop (objects a long run retains set them off)
        would scan all of it.  The heap goes back to
        the collector when the call returns, and with it whatever the
        caller had frozen: ``gc.unfreeze`` hands back all or nothing.
        """
        gc.freeze()
        try:
            return self._step_until(until)
        finally:
            gc.unfreeze()

    def _step_until(self, until: Optional[float]) -> bool:
        # observability globals, fetched once per step_until call (enable
        # observability before driving the loop — obs.session around run).
        # Disabled cost inside the loop: a cached-bool test or two a drain
        # segment, grant and control event.  The drain's parts are kept
        # when they have a reader: the registry, or a tracer that records
        # the sim spans (a tracer filtered to other categories skips them)
        tr = _obstrace.TRACER
        reg = _obsmetrics.REGISTRY
        clocked = self._clocked = reg.enabled or tr.records("sim")
        if not clocked:
            return self._loop(until, tr, reg, False)
        before = self.drain_parts() if reg.enabled else None
        t0 = time.perf_counter()
        try:
            return self._loop(until, tr, reg, True)
        finally:
            self.step_seconds += time.perf_counter() - t0
            if before is not None:
                for k, v in self.drain_parts().items():
                    if v != before[k]:
                        reg.counter("sim." + k).inc(v - before[k])

    def _loop(self, until: Optional[float], tr, reg, clocked: bool) -> bool:
        self.start()
        heap = self._heap
        heappop = heapq.heappop
        max_time = self.cfg.max_time
        bound = max_time if until is None else min(until, max_time)
        n_jobs = len(self.jobs)
        drain = self._drain_array if self.engine is not None \
            else self._drain_python
        handle = (self._on_job_arrival, self._on_response_entry,  # by kind
                  self._on_deadline, self._on_blackout)
        perf = time.perf_counter
        obs_on = tr.enabled or reg.enabled
        engine_name = "array" if self.engine is not None else "python"
        while self._done < n_jobs:
            # ---- drain device check-ins until the heap takes priority ----
            t0 = perf()
            seen0 = self.checkins_seen
            deliver0 = self.delivery_seconds
            stopped = drain(bound)
            dt = perf() - t0 - (self.delivery_seconds - deliver0)
            self.drain_seconds += dt
            if obs_on:
                rows = self.checkins_seen - seen0
                if reg.enabled:
                    reg.counter("sim.drain_wall_s").inc(dt)
                    if rows:
                        reg.counter("sim.checkins_seen").inc(rows)
                        # per-check-in decision latency, attributed from the
                        # segment wall time (observe, don't perturb the loop)
                        reg.histogram("sim.decision_latency_s",
                                      lo=1e-9, hi=1.0).record(dt / rows,
                                                              n=rows)
                if rows and tr.enabled:
                    tr.complete("sim.drain", tr.us(t0), dt * 1e6, cat="sim",
                                rows=rows, engine=engine_name, sim_now=self.now)
            if stopped:
                # a check-in crossed the bound; only a horizon crossing ends
                # the simulation — a pause bound leaves it resumable, unless
                # the event model ended at a response entry between the two
                nxt = self._pause(bound)
                return bound >= max_time \
                    or max_time < nxt < self._times[self._cursor]
            # ---- one control event (peek first: an event past the bound
            # stays queued so a paused simulation loses nothing) ----
            if clocked:
                te = perf()                 # the event's stopwatch, its pop
            if not heap:                    # from the heap included
                nxt = self._pause(bound)
                return nxt == math.inf or nxt > max_time
            t = heap[0][0]
            if t > bound:
                # ends as the event model ended: at its next entry, which
                # may be a response's
                return min(t, self._pause(bound)) > max_time
            _, _, kind, payload = heappop(heap)
            self._pass(t)
            self.now = t
            if not clocked:
                handle[kind](payload)       # type: ignore[operator]
                continue
            handle[kind](payload)           # type: ignore[operator]
            # the span is recorded from the stopwatch's own clock reads, so
            # recording it adds nothing to the event's seconds
            dt = perf() - te
            self.event_counts[kind] += 1
            self.event_seconds[kind] += dt
            if tr.enabled:
                tr.complete(_EVENT_SPAN[kind], tr.us(te), dt * 1e6,
                            cat="sim", sim_t=t)
        return True

    def drain_parts(self) -> dict:
        """The drain's parts (counted and timed while the metrics registry
        is on or the tracer records category ``sim``):
        ``_PARTS`` by name, and per control-event kind ``events.<kind>`` and
        ``event_seconds.<kind>``.  The self times (``*_seconds``) do not
        overlap one another, the stream (``stream_seconds``), the matcher
        and mirror (the engine's ``matcher_s``, ``rebuild_s``, ``patch_s``)
        or the replans (the scheduler's ``replan_seconds``).  What the array
        drain's ``drain_seconds`` holds besides them is its segment
        bookkeeping: ``engine.prepare`` less replan and mirror, the miss
        scan, the segment bounds, the matcher's host work around its call;
        what ``step_seconds`` holds besides the drain and the events is the
        loop's own.  ``responses_delivered`` counts the responses delivered
        as data, beside ``events.response``, the completing responses;
        the deliveries before replans and at pauses are timed in
        ``delivery_seconds``, which is not in ``drain_seconds`` (those at a
        deadline, a completion or a blackout are in their event's time)."""
        d = {k: getattr(self, k) for k in _PARTS}
        for kind, n, sec in zip(EVENT_KINDS, self.event_counts,
                                self.event_seconds):
            d["events." + kind] = n
            d["event_seconds." + kind] = sec
        return d

    def finish(self) -> SimMetrics:
        """Run to completion and finalize metrics (idempotent)."""
        self.start()
        if not self._finished:
            self.step_until(None)
            self._collect_resilience()
            self.metrics.finalize(self.jobs, self.now)
            self._finished = True
        return self.metrics

    # --------------------------------------------------- drain: scalar path

    def _drain_python(self, bound: float) -> bool:
        """Per-check-in drain until the next control event takes priority.
        Returns True when a check-in crossed ``bound`` (horizon or pause
        point); the cursor stays on the crossing row so a paused drain
        resumes exactly where it stopped.

        The check-in scan is inlined (it runs millions of times per simulated
        month); grant side effects go through the shared ``_grant``."""
        heap = self._heap
        sched = self.sched
        sched_checkin = sched.checkin
        sched_live = sched.live_atoms
        index = sched.index
        grant = self._grant
        inf = math.inf
        while True:
            if self._chunk is None:
                return False
            # the atom partition only refines inside on_request (a heap
            # event), so one version check per drain segment suffices
            if index.version != self._chunk_version:
                self._classify_chunk(self._chunk, self._cursor)
            times, cpu, mem = self._times, self._cpu, self._mem
            spd, aids = self._speed, self._aids
            n_times = len(times)
            cursor = self._cursor
            seg_start = cursor
            seg_dead = 0
            last_t = None
            stop = False
            # liveness bitmap: None while the plan is dirty (first checkin
            # replans; we refresh once after it).  The list object is mutated
            # in place by the scheduler across mid-drain replans.
            live = sched_live()
            live_refreshed = False
            # the heap is only pushed to (never popped) inside this drain, so
            # its top is cached and refreshed after each grant
            heap_t = heap[0][0] if heap else inf
            while cursor < n_times:
                dev_t = times[cursor]
                if heap_t < dev_t:
                    break
                if dev_t > bound:
                    stop = True
                    break
                if not self._open:
                    # every outstanding request is already filled (or none
                    # exist): no check-in can be granted; jump the cursor to
                    # the next control event in one step
                    self._cursor = cursor
                    self.checkins_seen += cursor - seg_start - seg_dead
                    self.checkins_skipped += seg_dead
                    self._skip_idle(min(heap_t, bound))
                    times, cpu, mem = self._times, self._cpu, self._mem
                    spd, aids = self._speed, self._aids
                    n_times = len(times)
                    cursor = self._cursor
                    seg_start = cursor
                    seg_dead = 0
                    continue
                aid = aids[cursor]
                if live is not None and aid < len(live) and not live[aid]:
                    # dead atom: no pending request can accept this device
                    # (e.g. a tiered phase where only one atom's speed band
                    # is still being collected) — skip the scheduler call
                    cursor += 1
                    seg_dead += 1
                    last_t = dev_t
                    continue
                speed = spd[cursor]
                req = sched_checkin(aid, cpu[cursor], mem[cursor],
                                    speed, dev_t)
                if live is None and not live_refreshed:
                    # a dirty plan was just recompiled inside checkin; pick up
                    # the fresh bitmap (once per segment — stays None for
                    # schedulers without liveness)
                    live = sched_live()
                    live_refreshed = True
                i = cursor
                cursor += 1
                last_t = dev_t
                if (req is None or req.granted >= req.demand
                        or req.complete_time is not None):
                    continue                           # device leaves unused
                if grant(req, i, dev_t, speed):        # a fill arms events
                    heap_t = heap[0][0]
            self._cursor = cursor
            self.checkins_seen += cursor - seg_start - seg_dead
            self.checkins_skipped += seg_dead
            if last_t is not None:
                self.now = last_t       # ungranted check-ins don't store
                #                         self.now each step; sync at seg end
            if stop:
                return True
            if cursor >= n_times and self._chunk is not None:
                self._load_next_chunk()
                if self._chunk is not None:
                    continue
            return False

    # ---------------------------------------------------- drain: array path

    def _drain_array(self, bound: float) -> bool:
        """Batched drain (``engine="array"``): match whole segments of
        check-ins in one :mod:`repro_torch.accel` call, then apply grants in time
        order, truncating exactly where a newly armed control event (or a
        fill that empties ``_open``) would have preempted the scalar loop.
        Outcomes are bit-identical to ``_drain_python``."""
        heap = self._heap
        engine = self.engine
        sched = self.sched
        index = sched.index
        grant = self._grant
        inf = math.inf
        clocked = self._clocked
        perf = time.perf_counter
        while True:
            if self._chunk is None:
                return False
            if index.version != self._chunk_version:
                self._classify_chunk(self._chunk, self._cursor)
            times = self._times
            cursor = self._cursor
            if cursor >= len(times):
                self._load_next_chunk()
                if self._chunk is None:
                    return False
                continue
            heap_t = heap[0][0] if heap else inf
            dev_t = times[cursor]
            if heap_t < dev_t:
                return False                    # control events first
            if dev_t > bound:
                return True                     # crossed the bound: stop
            top = self._pass(dev_t)             # responses due: data
            if heap_t < top:
                top = heap_t
            if not self._open:
                if clocked:
                    t = perf()
                    mark = (self.stream_seconds, self.checkins_skipped)
                self._skip_idle(min(top, bound))
                if clocked:
                    self._note_idle(t, mark)
                continue
            ck = self._chunk
            seg_bound = top if top < bound else bound
            hi = int(np.searchsorted(ck.times, seg_bound, side="right"))
            if hi > cursor + SEG_ROWS:          # bound the dense working set
                hi = cursor + SEG_ROWS
            # scheduler's lazy replan runs at the first check-in's time,
            # exactly when the scalar path's first checkin would trigger it
            state = engine.prepare(sched, dev_t)
            if clocked:
                self.drain_segments += 1
            aids_np = ck.atom_ids
            # rows from the first MISS on take the scalar route, which takes
            # the MISS itself (its checkin replans mid-drain)
            miss = state.first_miss(aids_np[cursor:hi], index.num_atoms)
            if miss >= 0:
                hi = cursor + miss
            if hi - cursor < SCALAR_SEG_ROWS:
                if clocked:
                    t = perf()
                    mark = (self.grant_seconds, sched.replan_seconds,
                            self.delivery_seconds)
                missed = self._drain_array_scalar(state, cursor, top, bound)
                if clocked:
                    self.scalar_segments += 1
                    self.scalar_rows += self._cursor - cursor - missed
                    self.head_misses += missed
                    self._note_scalar(t, mark)
                continue
            try:
                res = engine.match(aids_np[cursor:hi], ck.speed[cursor:hi],
                                   start=cursor)
            except NeedWiderExport:
                continue        # engine widened its cap: rebuild + re-match
            choice = res.choice
            seg_end = hi
            due = self._due
            for p in np.flatnonzero(res.granted).tolist():
                i = cursor + p
                if i >= seg_end:
                    break
                t_i = times[i]
                rix = int(choice[p])
                filled = grant(state.requests[rix], i, t_i, self._speed[i])
                state.consume(rix)
                if filled and not self._open:
                    # every outstanding request filled: the scalar loop
                    # would idle-skip the rest of the segment
                    seg_end = i + 1
                    break
                new_top = due[0]
                if filled and heap[0][0] < new_top:
                    new_top = heap[0][0]        # only a fill arms events
                if new_top < top:
                    # the grant's response (or the fill's events) came
                    # before the old segment bound: check-ins after it
                    # belong to the next segment
                    top = new_top
                    cut = int(np.searchsorted(ck.times, new_top,
                                              side="right"))
                    if cut < seg_end:
                        seg_end = cut
            self._cursor = seg_end
            self.checkins_seen += seg_end - cursor
            self.now = times[seg_end - 1]
            if clocked:
                self.vector_segments += 1
                self.vector_rows += seg_end - cursor

    def _note_idle(self, t0: float, mark: tuple) -> None:
        """Count one idle skip begun at ``t0``; ``mark`` holds the stream
        seconds and skipped check-ins before it."""
        self.idle_skips += 1
        self.idle_rows += self.checkins_skipped - mark[1]
        self.idle_seconds += time.perf_counter() - t0 \
            - (self.stream_seconds - mark[0])

    def _note_scalar(self, t0: float, mark: tuple) -> None:
        """Add the scalar route's self time since ``t0``: ``mark`` holds the
        grant, replan and delivery seconds before it."""
        self.scalar_seconds += time.perf_counter() - t0 \
            - (self.grant_seconds - mark[0]) \
            - (self.sched.replan_seconds - mark[1]) \
            - (self.delivery_seconds - mark[2])

    def _drain_array_scalar(self, state, cursor: int, top: float,
                            bound: float) -> bool:
        """Scalar tail of the array drain for segments too small to amortize
        a vectorized match: per-row ``checkin`` with the state's candidate
        bitmap standing in for the scheduler's liveness list (same dead-atom
        set: covered atoms with no candidate slot).  Grants are mirrored
        into the state so later vectorized segments stay exact; if a grant
        surfaces a request the state does not know (a mid-row replan), the
        state is invalidated and the caller's next ``prepare`` rebuilds it.

        The route goes on past a response that comes due before the next
        row (``top``: the first, or the next control event), which it passes
        as data (:meth:`_pass`).  It ends at the first row past the next
        control event or ``bound``, at the chunk's end and at a fill that
        empties ``_open``; and after a response passed, where the rows
        before the next one or ``bound`` fill a vectorized segment, so that
        the caller routes them to the matcher.  A row whose atom the state
        does not cover (a MISS) is the route's last: its ``checkin``
        replans, which the state does not follow, so the state is
        invalidated after it.  Returns whether the route took a MISS."""
        heap = self._heap
        due = self._due
        sched = self.sched
        grant = self._grant
        times, aids = self._times, self._aids
        cpu, mem, spd = self._cpu, self._mem, self._speed
        has_cand = state.has_cand_list
        covered = state.covered.tolist()
        n_cov = len(has_cand)
        n_times = len(times)
        # rows after stop_t (the next response or event, or bound) wait for
        # a response passed or end the route
        stop_t = top if top < bound else bound
        i = cursor
        missed = False
        while i < n_times:
            t_i = times[i]
            if t_i > stop_t:
                if t_i > bound or heap and heap[0][0] < t_i:
                    break                       # past the bound, or a
                #                                 control event first
                top = self._pass(t_i)
                if heap and heap[0][0] < top:
                    top = heap[0][0]
                stop_t = top if top < bound else bound
                j = i + SCALAR_SEG_ROWS - 1
                if j < n_times and times[j] <= stop_t:
                    break                       # a run for the matcher
            aid = aids[i]
            if aid >= n_cov or not has_cand[aid]:
                if aid < n_cov and covered[aid]:
                    i += 1                      # dead atom
                    continue
                missed = True                   # a MISS: its checkin
                n_times = i + 1                 # replans, so it ends the route
            speed = spd[i]
            req = sched.checkin(aid, cpu[i], mem[i], speed, t_i)
            i += 1
            if (req is None or req.granted >= req.demand
                    or req.complete_time is not None):
                continue
            filled = grant(req, i - 1, t_i, speed)
            rix = state.request_index(req)
            if rix is None:                     # request unknown to the
                self.engine.invalidate()        # state (mid-row replan)
                break
            state.consume(rix)
            if filled and not self._open:
                break
            top = due[0]                        # the grant's response,
            if filled and heap[0][0] < top:     # or a fill's events
                top = heap[0][0]
            if top < stop_t:
                stop_t = top
        if missed:
            self.engine.invalidate()
        self._cursor = i
        self.checkins_seen += i - cursor
        if times[i - 1] > self.now:             # the last row came after
            self.now = times[i - 1]             # the last response passed
        return missed

    # ------------------------------------------------------------ internals

    def _grant(self, req: JobRequest, i: int, dev_t: float, speed: float
               ) -> bool:
        """Apply one granted check-in (chunk row ``i`` at ``dev_t``):
        materialize the ``Device``, buffer its response, handle request
        fill (its deadline, and the entry of the response completing it).
        The single place grant side effects happen — shared by both drain
        engines.  Returns True iff the request just filled."""
        clocked = self._clocked
        if clocked:
            t0 = time.perf_counter()
        if not req.granted:
            # flight recorder: grant sequences are bit-identical across
            # engines, so this (and not the drain loop) is where the grant
            # audit stream hangs.  Only a round's *opening* grant is audit-
            # eligible — the one cheap ``req.granted`` test above keeps the
            # per-grant cost below even an AUDIT-enabled check, and audit
            # work scales with rounds, not grants.  The hook runs before
            # the ``granted`` increment so the recorder's slot scan
            # classifies the pre-grant fill state.
            aud = _obsaudit.AUDIT
            if aud.enabled:
                r = aud.rounds_seen
                aud.rounds_seen = r + 1
                if not r % aud.grant_sample:
                    aud.grant(r, req, self._aids[i], dev_t, speed)
        self.now = dev_t
        dev = Device(caps={"cpu": self._cpu[i], "mem": self._mem[i]},
                     speed=speed, checkin_time=dev_t, atom_id=self._aids[i])
        req.granted += 1
        # incremental-replan hook: grants are the one pending-set/demand-key
        # mutation that flows through neither on_request nor on_complete
        # (a fill drops the job from pending_jobs() before any completion
        # hook fires).  Runs after the increment so the scheduler sees the
        # post-grant remaining demand.  No-op for the baselines.
        self.sched.on_grant(req)
        filled = req.granted >= req.demand
        if filled:
            self._open -= 1
        job = req.job
        if job.first_service_time is None:
            job.first_service_time = dev_t
        rt = response_time_from(speed, self._resp_z[i], job.task_time_mean,
                                job.task_time_sigma)
        ok = not fails_from(speed, self._fail_u[i], self.stream.fail_base,
                            self.stream.fail_slow_boost)
        # merged into the buffer's heap at its next delivery (_deliver)
        t_resp = dev_t + rt
        seq = next(self._seq)
        req.resp_new.append((t_resp, seq, dev, rt, ok))
        heapq.heappush(self._due, t_resp)
        if filled and req.alloc_complete_time is None:
            req.alloc_complete_time = dev_t        # scheduling delay ends
            job.status = JobStatus.COLLECTING
            # the responses due before the fill, so that the buffer and the
            # entries armed are the event model's when it pushed the
            # deadline: those at the deadline's time go first (_on_deadline)
            t1 = time.perf_counter()
            self._deliver(req, dev_t)
            t1 = time.perf_counter() - t1
            self.delivery_seconds += t1
            if clocked:
                t0 += t1
            deadline = dev_t + job.deadline
            req.resp_ties = req.resp_armed.count(deadline)
            heapq.heappush(self._heap, (deadline, next(self._seq), DEADLINE,
                                        req))
            self._arm(req)
        if self.grant_log is not None:
            self.grant_log.append((dev_t, job.job_id, req.round_index))
        if clocked:
            self.grants += 1
            self.grant_seconds += time.perf_counter() - t0
        return filled

    def _push(self, t: float, kind: int, payload: object) -> None:
        heapq.heappush(self._heap, (t, next(self._seq), kind, payload))

    # ---- responses: data in their request's buffer, delivered when read ----

    def _deliver(self, req: JobRequest, t: float, through: bool = False
                 ) -> None:
        """Apply ``req``'s buffered responses due before ``t`` (``through``:
        and at ``t``) in time, then grant, order, each as its own RESPONSE
        event of the event model applied it: ``sched.on_response`` at its
        time, then the request's counts.

        Grants not yet merged into the buffer's heap are merged first, each
        after the responses due strictly before its check-in (a row comes
        before an event at its time), so the heap keeps the layout that one
        event a response left: a blackout's draws walk it.  Every grant
        merged came at or before ``t``.  Each time a response became the
        heap's head, the event model armed an entry at its time: the times
        go to ``resp_armed``."""
        buf = req.resp_buf
        new = req.resp_new
        arm = req.resp_armed.append
        sched = self.sched
        on_response = sched.on_response
        dirty = sched.plan_dirty
        heappop = heapq.heappop
        n = 0
        for e in new:
            g = e[2].checkin_time
            while buf and buf[0][0] < g:
                r_t, _, dev, rt, ok = heappop(buf)
                on_response(req, dev, rt, ok, r_t)
                if ok:
                    req.responses += 1
                else:
                    req.failures += 1
                n += 1
                if buf:
                    arm(buf[0][0])
            if not buf or e[0] < buf[0][0]:
                arm(e[0])
            heapq.heappush(buf, e)
        new.clear()
        while buf:
            h = buf[0][0]
            if h > t or h == t and not through:
                break
            r_t, _, dev, rt, ok = heappop(buf)
            on_response(req, dev, rt, ok, r_t)
            if ok:
                req.responses += 1
            else:
                req.failures += 1
            n += 1
            if buf:
                arm(buf[0][0])
        if n:
            if not dirty and sched.plan_dirty:
                raise RuntimeError(_DIRTY)
            if self._clocked:
                self.responses_delivered += n

    def _settle(self, req: JobRequest, t: float, n: float) -> bool:
        """At ``req``'s deadline or completing entry (time ``t``): deliver
        its responses due before ``t``, then those due at ``t``, one event
        each and at most ``n`` of them, until the round reaches quorum.
        Returns whether it did (the request is filled)."""
        self._deliver(req, t)
        buf, arm = req.resp_buf, req.resp_armed.append
        sched = self.sched
        dirty = sched.plan_dirty
        done = False
        k = 0
        while k < n and buf and buf[0][0] == t:
            _, _, dev, rt, ok = heapq.heappop(buf)
            sched.on_response(req, dev, rt, ok, t)
            if ok:
                req.responses += 1
            else:
                req.failures += 1
            k += 1
            if req.responses >= req.quorum:
                done = True
                break
            if buf:                             # the event model re-armed
                arm(buf[0][0])
        if k:
            if not dirty and sched.plan_dirty:
                raise RuntimeError(_DIRTY)
            if self._clocked:
                self.responses_delivered += k
        return done

    def _deliver_before(self, t: float) -> None:
        """The scheduler's replan hook: every live request's responses due
        before ``t``, the time of the check-in the replan serves (the
        events before it come first, those at its time after it)."""
        t0 = time.perf_counter()
        deliver = self._deliver
        for req in self._awaiting:
            buf = req.resp_buf
            if req.resp_new or buf and buf[0][0] < t:
                deliver(req, t)
        self.delivery_seconds += time.perf_counter() - t0

    def _pause(self, bound: float) -> float:
        """Leave the state as handling every event up to ``bound`` one at a
        time left it, where :meth:`step_until` returns: deliver every
        response due by then, and pass them (:meth:`_pass`), which sets the
        clock.  Returns the time of the event model's next response entry
        (``inf``: none)."""
        t0 = time.perf_counter()
        deliver = self._deliver
        for req in self._awaiting:
            buf = req.resp_buf
            if req.resp_new or buf and buf[0][0] <= bound:
                deliver(req, bound, True)
        nxt = self._pass(math.nextafter(bound, math.inf))
        self.delivery_seconds += time.perf_counter() - t0
        return nxt

    def _pass(self, t: float) -> float:
        """The drain or the loop has come to ``t``: drop the responses due
        before it from ``_due``.  The event model handled their entries one
        event each, which moved the clock to their times.  Returns the time
        of its next response entry (``inf``: none)."""
        due, gone = self._due, self._gone
        heappop = heapq.heappop
        while due:
            v = due[0]
            if gone and v in gone:              # no entry in the event model
                heappop(due)
                if gone[v] == 1:
                    del gone[v]
                else:
                    gone[v] -= 1
                continue
            if v >= t:
                return v
            heappop(due)
            if v > self.now:
                self.now = v
        return math.inf

    def _arm(self, req: JobRequest) -> None:
        """Arm ``req``'s RESPONSE entry, now that it is filled and its
        responses before now are delivered (at its fill, or again after a
        blackout revoked some of them), at the response that completes its
        round: in the buffer's order, the first at which the responses reach
        quorum.  If that is not before the deadline, the deadline decides
        the round (:meth:`_on_deadline`) and no entry is armed."""
        need = req.quorum - req.responses
        done = math.inf
        for e in sorted(req.resp_buf):
            if e[4]:
                need -= 1
            if need <= 0:
                done = e[0]
                break
        if done >= req.alloc_complete_time + req.job.deadline:
            done = math.inf
        elif done != req.resp_t:                # an entry armed earlier
            self._push(done, RESPONSE, req)     # goes stale
        req.resp_t = done

    def _close(self, req: JobRequest) -> None:
        """``req``'s round is over, its grants all merged: the rest of its
        buffer is dropped unread.  The event model's entries for those it
        had armed still came due (stale); the others go to ``_gone``."""
        del self._awaiting[req]
        if req.resp_buf:
            self._forget(req.resp_buf, set(req.resp_armed))
        req.resp_buf = req.resp_new = req.resp_armed = None
        req.resp_t = math.inf

    def _forget(self, rows, armed) -> None:
        """The responses ``rows`` leave their buffer unread: those at a time
        where the event model armed no entry (``armed``, a set of times) had
        none (``_gone``)."""
        gone = self._gone
        for e in rows:
            if e[0] not in armed:
                gone[e[0]] = gone.get(e[0], 0) + 1

    # ---- device stream (struct-of-arrays chunks) ----

    def _load_next_chunk(self) -> None:
        """Pull chunks from the stream until one has check-ins (or it ends)."""
        t0 = time.perf_counter()
        s0 = self.stream_seconds
        try:
            self._load_next_chunk_inner()
        finally:
            self.stream_seconds += time.perf_counter() - t0
            tr = _obstrace.TRACER
            if tr.enabled:
                # span over the engine-comparable stream time (the inner
                # loop backs the scalar mirror conversion out of the total)
                tr.complete("sim.chunk_load", tr.us(t0),
                            (self.stream_seconds - s0) * 1e6, cat="sim",
                            rows=self._chunk.n if self._chunk is not None
                            else 0)
            reg = _obsmetrics.REGISTRY
            if reg.enabled:
                reg.counter("sim.stream_wall_s").inc(
                    self.stream_seconds - s0)

    def _load_next_chunk_inner(self) -> None:
        self._chunk = None
        self._times = self._cpu = self._mem = []
        self._speed = self._resp_z = self._fail_u = self._aids = []
        while True:
            ck = self.stream.next_chunk()
            if ck is None:
                return
            if ck.n == 0:
                continue
            self._classify_chunk(ck, 0)
            self.sched.begin_chunk(ck.times, ck.atom_ids)
            self._chunk = ck
            if self.engine is None:
                # scalar drain: Python-float list indexing is ~3x cheaper
                # than NumPy scalar indexing on the per-device hot loop.
                # The mirror conversion is engine-side work, not chunk
                # production — back it out of stream_seconds so the
                # drain-vs-stream split stays engine-comparable.
                tm = time.perf_counter()
                self._times = ck.times.tolist()
                self._cpu = ck.cpu.tolist()
                self._mem = ck.mem.tolist()
                self._speed = ck.speed.tolist()
                self._resp_z = ck.resp_z.tolist()
                self._fail_u = ck.fail_u.tolist()
                self._aids = ck.atom_ids.tolist()
                self.stream_seconds -= time.perf_counter() - tm
            else:
                # array drain touches only segment boundaries and grants:
                # the arrays serve directly, skipping the per-chunk tolist
                self._times = ck.times
                self._cpu = ck.cpu
                self._mem = ck.mem
                self._speed = ck.speed
                self._resp_z = ck.resp_z
                self._fail_u = ck.fail_u
                self._aids = ck.atom_ids
                # engine-side work too: upload the chunk's ids and speeds
                # once, so segments are sliced on the device
                tm = time.perf_counter()
                self._bind_chunk(ck)
                self.stream_seconds -= time.perf_counter() - tm
            self._cursor = 0
            return

    def _classify_chunk(self, ck: DeviceChunk, start: int) -> None:
        ids = self.sched.classify_caps({"cpu": ck.cpu[start:],
                                        "mem": ck.mem[start:]})
        if ck.atom_ids is None:
            ck.atom_ids = ids           # initial classification at chunk load
        else:
            # re-classification after the requirement set grew: write in
            # place so the scheduler's chunk feed (which holds a reference)
            # and the drain loop's list mirror both see the new ids — even
            # when the whole chunk is still unprocessed (start == 0)
            ck.atom_ids[start:] = ids
            if type(self._aids) is list:        # array mode aliases the
                self._aids[start:] = ids.tolist()   # chunk array directly
            else:
                self._bind_chunk(ck)            # the device copy is stale
        self._chunk_version = self.sched.atom_version

    def _bind_chunk(self, ck: DeviceChunk) -> None:
        bind = getattr(self.engine, "bind_chunk", None)
        if bind is not None:
            bind(ck.atom_ids, ck.speed)

    def _skip_idle(self, until: float) -> None:
        """Fast-forward the device cursor while no request is outstanding.
        Supply accounting is unaffected: the estimator was fed the whole
        chunk and absorbs it by timestamp."""
        ck = self._chunk
        j = int(np.searchsorted(ck.times, until, side="right"))
        if j <= self._cursor:
            j = self._cursor + 1                # guarantee progress
        self.checkins_skipped += j - self._cursor
        self._cursor = j
        if self._cursor >= ck.n:
            self._load_next_chunk()

    # ---- faults & recovery ----

    def _on_blackout(self, b) -> None:
        """A correlated blackout begins: devices whose response would land
        inside ``[b.start, b.stop)`` went dark mid-task — revoke those
        in-flight rows (each with ``b.drop_prob``) so they never report back.
        Deterministic across drain engines: job order, buffer layout, and RNG
        draw order are all grant-order artifacts, which are bit-identical."""
        rng = self._fault_rng
        total_revoked = 0
        for job in self.jobs:
            req = job.current
            if req is None:
                continue
            self._deliver(req, b.start)
            buf = req.resp_buf
            if not buf:
                continue
            old = buf[0][0]
            keep = []
            drop = []
            for e in buf:
                if b.start <= e[0] < b.stop and (
                        b.drop_prob >= 1.0 or rng.random() < b.drop_prob):
                    drop.append(e)
                else:
                    keep.append(e)
            if not drop:
                continue
            self._forget(drop, set(req.resp_armed))
            revoked = len(drop)
            total_revoked += revoked
            self.metrics.revoked_responses += revoked
            heapq.heapify(keep)
            req.resp_buf = keep
            if keep and keep[0][0] != old:      # the event model re-armed
                req.resp_armed.append(keep[0][0])
            if req.alloc_complete_time is not None:
                self._arm(req)
        tr = _obstrace.TRACER
        if tr.enabled:
            tr.instant("fault.blackout", cat="fault", sim_t=self.now,
                       revoked=total_revoked)

    def _collect_resilience(self) -> None:
        """Fold engine- and stream-side fault counters into the metrics."""
        m = self.metrics
        eng = self.engine
        if eng is not None:
            m.degraded_segments += int(getattr(eng, "degraded_segments", 0))
            m.stale_plans_served += int(getattr(eng, "stale_plans_served", 0))
        s = self.stream
        while s is not None:
            m.skipped_rows += int(getattr(s, "skipped_rows", 0))
            fc = getattr(s, "fault_counters", None)
            if fc is not None:
                c = fc()
                m.dropped_checkins += int(c["rows_dropped_blackout"]
                                          + c["rows_dropped_chunks"])
                m.flaky_retries += int(c["flaky_retries"])
            s = getattr(s, "inner", None)

    def _after_restore(self) -> None:
        """Post-unpickle hook (see :mod:`repro_torch.faults.recovery`): drop the
        accel engine's derived dispatch tables — they are rebuilt by the next
        ``prepare`` from restored scheduler state — and count the recovery."""
        if self.engine is not None:
            self.engine.invalidate()
        self.metrics.recovery_events += 1

    # ---- job lifecycle ----

    def _on_job_arrival(self, job: Job) -> None:
        self._submit_round(job, round_index=job.rounds_done)

    def _submit_round(self, job: Job, round_index: int, aborted: int = 0) -> None:
        nominal = job.demand_per_round
        demand = nominal
        if self.cfg.adaptive_overcommit:
            pol = self._oc_policies.get(job.job_id)
            if pol is None:
                from ..fed.overcommit import OvercommitPolicy
                pol = OvercommitPolicy(base=max(1.0, job.overcommit))
                self._oc_policies[job.job_id] = pol
            demand = pol.demand(nominal, job.quorum_fraction)
        elif job.overcommit > 1.0:
            # static §3 over-provisioning: the job asks for more grants than
            # it needs so stragglers/failures don't abort the round
            demand = max(nominal, int(round(nominal * job.overcommit)))
        req = JobRequest(job=job, round_index=round_index,
                         demand=demand, submit_time=self.now,
                         aborted=aborted)
        # quorum counts against *nominal* demand (§3: overcommit buys slack,
        # it doesn't raise the bar) — identical to the pre-policy simulator
        # whenever overcommit == 1.0
        req.quorum = math.ceil(job.quorum_fraction * nominal)
        req.resp_buf, req.resp_new, req.resp_armed = [], [], []
        self._awaiting[req] = None
        job.current = req
        job.status = JobStatus.WAITING
        self._open += 1
        self.metrics.submitted_rounds += 1
        self.sched.on_request(req, self.now)

    def _on_response_entry(self, req: JobRequest) -> None:
        """The response armed by :meth:`_arm` comes due (at ``self.now``):
        deliver the responses before it, then it, and complete the round.
        An entry re-armed since, or of a round over, is stale."""
        if req.resp_t != self.now:
            return
        self._settle(req, self.now, math.inf)   # reaches quorum: armed so
        if self._clocked:
            self.responses_delivered -= 1       # the last was this event
        self._complete_round(req)

    def _on_deadline(self, req: JobRequest) -> None:
        if req.complete_time is not None or req.job.current is not req:
            return
        job = req.job
        # the responses at its time whose entries the event model had armed
        # before this one handled first, the first to reach quorum completing
        if self._settle(req, self.now, req.resp_ties) \
                or req.responses >= req.quorum:
            self._complete_round(req)
            return
        # round aborted: retry the same round (§5.1 random-baseline abortions)
        # (the request is necessarily filled here — DEADLINE events are only
        # pushed at fill time — so _open was already decremented)
        self.metrics.aborts += 1
        self._close(req)
        self._observe_overcommit(job, req)
        self.sched.on_complete(req, self.now)
        job.current = None
        if req.aborted + 1 >= self.cfg.max_round_retries:
            # pathological starvation guard: count the round as failed-complete
            job.rounds_done += 1
            self.metrics.failed_rounds += 1
            if job.rounds_done >= job.total_rounds:
                self._finish_job(job)
                return
        self._submit_round(job, job.rounds_done, aborted=req.aborted + 1)

    def _complete_round(self, req: JobRequest) -> None:
        # completion requires alloc_complete_time (fill), so the fill-time
        # _open decrement in the drain loop has always happened by now
        self._close(req)
        req.complete_time = self.now
        job = req.job
        job.rounds_done += 1
        job.attained_service += self.now - req.submit_time
        self.metrics.rounds.append(RoundRecord(
            job_id=job.job_id,
            round_index=req.round_index,
            submit=req.submit_time,
            alloc_complete=req.alloc_complete_time,
            complete=self.now,
            demand=req.demand,
            responses=req.responses,
            failures=req.failures,
            retries=req.aborted,
        ))
        self._observe_overcommit(job, req)
        self.sched.on_complete(req, self.now)
        job.current = None
        if job.rounds_done >= job.total_rounds:
            self._finish_job(job)
        else:
            self._submit_round(job, job.rounds_done)

    def _observe_overcommit(self, job: Job, req: JobRequest) -> None:
        """Feed the round's grant/response outcome to the job's adaptive
        overcommit policy (no-op unless ``cfg.adaptive_overcommit``)."""
        if self.cfg.adaptive_overcommit:
            pol = self._oc_policies.get(job.job_id)
            if pol is not None:
                pol.observe_round(req.granted, req.responses)

    def _finish_job(self, job: Job) -> None:
        job.status = JobStatus.DONE
        job.completion_time = self.now
        self._done += 1


def run_workload(jobs: List[Job], scheduler: BaseScheduler,
                 population: Optional[PopulationConfig] = None,
                 sim: Optional[SimConfig] = None,
                 stream: Optional[ChunkStream] = None,
                 engine: Optional[str] = None,
                 faults: Optional[object] = None, device=None) -> SimMetrics:
    return Simulator(jobs, scheduler, population, sim, stream=stream,
                     engine=engine, faults=faults, device=device).run()
