"""Event-driven simulator of the multi-job collaborative-learning environment.

Implements the lifecycle of Figure 6: jobs submit per-round resource requests
(①), devices check in over time (①), the scheduler assigns one job per device
(②), devices execute and respond or drop (③–⑤).  Rounds complete when
``quorum_fraction × demand`` responses arrive before the deadline; otherwise
the round aborts and the request is resubmitted (fault tolerance is the job's
concern, §3 — the simulator models it with quorum + deadline + retry).

Control events (heapq-ordered by time, then a monotone sequence id):

* ``JOB_ARRIVAL``     — job enters, submits round-0 request
* ``RESPONSE``        — the next granted device of one request reports back
* ``DEADLINE``        — response-collection deadline for one request attempt

RESPONSE events are **batched per request**: granted devices land in a
per-request min-heap of (response-time, device) rows and the control heap
holds at most one *armed* entry per request (its earliest pending response).
Processing an armed entry pops the per-request heap and re-arms for the next
row, so the control heap stays O(outstanding requests) instead of
O(outstanding granted devices) — the grant/response floor of the heap traffic.

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
  rows touch Python objects.  Grant sequences and metrics are bit-identical
  to the scalar path; uncovered atoms fall back to one scalar ``checkin``
  (the MISS/replan protocol).

Either way a ``Device`` object is only materialized for granted check-ins,
and all grant side effects flow through the shared :meth:`Simulator._grant`.
"""
from __future__ import annotations

import heapq
import itertools
import math
import time
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

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

# control-event span names, indexed by event kind (repro_torch.obs taxonomy)
_EVENT_SPAN = ("sim.event.arrival", "sim.event.response",
               "sim.event.deadline", "sim.event.fault")


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
            # the torch engine on ``device`` (None: cuda:0, and an error if
            # there is none; "cpu" only when the caller asks for it)
            from ..accel.engine import ArrayMatchEngine
            from ..device import resolve_device
            self.engine = ArrayMatchEngine(backend="torch",
                                           device=resolve_device(device))
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
        """
        self.start()
        heap = self._heap
        heappop = heapq.heappop
        max_time = self.cfg.max_time
        bound = max_time if until is None else min(until, max_time)
        n_jobs = len(self.jobs)
        drain = self._drain_array if self.engine is not None \
            else self._drain_python
        perf = time.perf_counter
        # observability globals, fetched once per step_until call (enable
        # observability before driving the loop — obs.session around run).
        # Disabled cost inside the loop: two cached-bool tests per iteration.
        tr = _obstrace.TRACER
        reg = _obsmetrics.REGISTRY
        obs_on = tr.enabled or reg.enabled
        engine_name = "array" if self.engine is not None else "python"
        while self._done < n_jobs:
            # ---- drain device check-ins until the heap takes priority ----
            t0 = perf()
            seen0 = self.checkins_seen
            stopped = drain(bound)
            dt = perf() - t0
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
                # the simulation — a pause bound leaves it resumable
                return bound >= max_time
            # ---- one control event (peek first: an event past the bound
            # stays queued so a paused simulation loses nothing) ----
            if not heap:
                return True
            t = heap[0][0]
            if t > bound:
                return t > max_time
            _, _, kind, payload = heappop(heap)
            self.now = t
            tok = tr.begin(_EVENT_SPAN[kind], cat="sim", sim_t=t) \
                if tr.enabled else None
            if kind == JOB_ARRIVAL:
                self._on_job_arrival(payload)           # type: ignore[arg-type]
            elif kind == RESPONSE:
                self._pop_response(payload)             # type: ignore[arg-type]
            elif kind == DEADLINE:
                self._on_deadline(payload)              # type: ignore[arg-type]
            elif kind == FAULT:
                self._on_blackout(payload)              # type: ignore[arg-type]
            if tok is not None:
                tr.end(tok)
        return True

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
                grant(req, i, dev_t, speed)
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
        from ..accel.engine import (NeedWiderExport, SCALAR_SEG_ROWS,
                                    SEG_ROWS)
        heap = self._heap
        engine = self.engine
        sched = self.sched
        index = sched.index
        grant = self._grant
        inf = math.inf
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
                return False                    # control event first
            if dev_t > bound:
                return True                     # crossed the bound: stop
            if not self._open:
                self._skip_idle(min(heap_t, bound))
                continue
            ck = self._chunk
            seg_bound = heap_t if heap_t < bound else bound
            hi = int(np.searchsorted(ck.times, seg_bound, side="right"))
            if hi > cursor + SEG_ROWS:          # bound the dense working set
                hi = cursor + SEG_ROWS
            # scheduler's lazy replan runs at the first check-in's time,
            # exactly when the scalar path's first checkin would trigger it
            state = engine.prepare(sched, dev_t)
            aids_np = ck.atom_ids
            # classify() interns new atom ids for freshly realized capability
            # combinations WITHOUT bumping index.version, so miss-freedom
            # additionally requires the id space not to have grown since the
            # state was built
            if state.miss_free and index.num_atoms == state.num_atoms:
                miss = -1                       # no atom can MISS: skip scan
            else:
                miss = state.first_miss(aids_np[cursor:hi])
            if miss == 0:
                # uncovered atom at the segment head: one scalar checkin,
                # which replans mid-drain exactly like the scalar path
                i = cursor
                speed = self._speed[i]
                req = sched.checkin(self._aids[i], self._cpu[i],
                                    self._mem[i], speed, dev_t)
                engine.invalidate()
                self._cursor = i + 1
                self.checkins_seen += 1
                self.now = dev_t
                if not (req is None or req.granted >= req.demand
                        or req.complete_time is not None):
                    grant(req, i, dev_t, speed)
                continue
            if miss > 0:
                hi = cursor + miss
            if hi - cursor < SCALAR_SEG_ROWS:
                self._drain_array_scalar(state, cursor, hi, heap_t)
                continue
            try:
                res = engine.match(aids_np[cursor:hi], ck.speed[cursor:hi],
                                   start=cursor)
            except NeedWiderExport:
                continue        # engine widened its cap: rebuild + re-match
            choice = res.choice
            seg_end = hi
            top = heap_t
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
                new_top = heap[0][0]
                if new_top < top:
                    # a grant armed an event earlier than the old segment
                    # bound: check-ins after it belong to the next segment
                    top = new_top
                    cut = int(np.searchsorted(ck.times, new_top,
                                              side="right"))
                    if cut < seg_end:
                        seg_end = cut
            self._cursor = seg_end
            self.checkins_seen += seg_end - cursor
            self.now = times[seg_end - 1]

    def _drain_array_scalar(self, state, cursor: int, hi: int,
                            heap_t: float) -> None:
        """Scalar tail of the array drain for segments too small to amortize
        a vectorized match: per-row ``checkin`` with the state's candidate
        bitmap standing in for the scheduler's liveness list (same dead-atom
        set: covered atoms with no candidate slot; uncovered atoms were
        bounded out by the MISS scan).  Grants are mirrored into the state so
        later vectorized segments stay exact; if a grant surfaces a request
        the state does not know (a mid-row replan), the state is invalidated
        and the caller's next ``prepare`` rebuilds it."""
        heap = self._heap
        sched = self.sched
        grant = self._grant
        times, aids = self._times, self._aids
        cpu, mem, spd = self._cpu, self._mem, self._speed
        has_cand = state.has_cand_list
        n_cov = len(has_cand)
        top = heap_t
        i = cursor
        while i < hi:
            t_i = times[i]
            if top < t_i:
                break                           # an armed event preempts
            aid = aids[i]
            if aid < n_cov and not has_cand[aid]:
                i += 1                          # dead atom (state.covered
                continue                        # holds: miss was bounded out)
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
            top = heap[0][0]
        self._cursor = i
        self.checkins_seen += i - cursor
        self.now = times[i - 1]

    # ------------------------------------------------------------ internals

    def _grant(self, req: JobRequest, i: int, dev_t: float, speed: float
               ) -> bool:
        """Apply one granted check-in (chunk row ``i`` at ``dev_t``):
        materialize the ``Device``, arm its response, handle request fill.
        The single place grant side effects happen — shared by both drain
        engines.  Returns True iff the request just filled."""
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
        t_resp = dev_t + rt
        buf = req.resp_buf
        if buf is None:
            buf = req.resp_buf = []
        heapq.heappush(buf, (t_resp, next(self._seq), dev, rt, ok))
        if t_resp < req.resp_t:
            # arm (or re-arm earlier) the request's single RESPONSE entry;
            # a previously armed later entry goes stale
            req.resp_t = t_resp
            heapq.heappush(self._heap, (t_resp, next(self._seq), RESPONSE,
                                        req))
        if filled and req.alloc_complete_time is None:
            req.alloc_complete_time = dev_t        # scheduling delay ends
            job.status = JobStatus.COLLECTING
            heapq.heappush(self._heap, (dev_t + job.deadline,
                                        next(self._seq), DEADLINE, req))
        if self.grant_log is not None:
            self.grant_log.append((dev_t, job.job_id, req.round_index))
        return filled

    def _push(self, t: float, kind: int, payload: object) -> None:
        heapq.heappush(self._heap, (t, next(self._seq), kind, payload))

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
            buf = req.resp_buf
            if not buf:
                continue
            keep = []
            revoked = 0
            for e in buf:
                if b.start <= e[0] < b.stop and (
                        b.drop_prob >= 1.0 or rng.random() < b.drop_prob):
                    revoked += 1
                else:
                    keep.append(e)
            if not revoked:
                continue
            total_revoked += revoked
            self.metrics.revoked_responses += revoked
            heapq.heapify(keep)
            req.resp_buf = keep or None
            head = keep[0][0] if keep else math.inf
            if head != req.resp_t:
                # re-arm (the control-heap entry at the old resp_t goes
                # stale via the usual armed-entry protocol)
                req.resp_t = head
                if keep:
                    self._push(head, RESPONSE, req)
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
        job.current = req
        job.status = JobStatus.WAITING
        self._open += 1
        self.metrics.submitted_rounds += 1
        self.sched.on_request(req, self.now)

    def _pop_response(self, req: JobRequest) -> None:
        """Process the armed RESPONSE entry of ``req`` at ``self.now``."""
        buf = req.resp_buf
        if req.resp_t != self.now or not buf:
            return                              # stale armed entry
        if req.complete_time is not None or req.job.current is not req:
            # round over (completed or aborted): drop the whole buffer in one
            # event instead of one stale pop per granted device
            req.resp_buf = None
            req.resp_t = math.inf
            return
        _, _, dev, rt, ok = heapq.heappop(buf)
        self._on_response(req, dev, rt, ok)
        if buf and req.complete_time is None and req.job.current is req:
            req.resp_t = buf[0][0]              # re-arm for the next response
            self._push(buf[0][0], RESPONSE, req)
        else:
            req.resp_buf = None
            req.resp_t = math.inf

    def _on_response(self, req: JobRequest, dev: Device, rt: float, ok: bool) -> None:
        if req.complete_time is not None or req.job.current is not req:
            return                                     # stale (round over/aborted)
        self.sched.on_response(req, dev, rt, ok, self.now)
        if ok:
            req.responses += 1
        else:
            req.failures += 1
        if req.responses >= req.quorum and req.alloc_complete_time is not None:
            self._complete_round(req)

    def _on_deadline(self, req: JobRequest) -> None:
        if req.complete_time is not None or req.job.current is not req:
            return
        job = req.job
        if req.responses >= req.quorum:
            self._complete_round(req)
            return
        # round aborted: retry the same round (§5.1 random-baseline abortions)
        # (the request is necessarily filled here — DEADLINE events are only
        # pushed at fill time — so _open was already decremented)
        self.metrics.aborts += 1
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
