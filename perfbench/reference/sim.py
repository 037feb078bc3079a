"""The plain reference of the check-in drain (simulator side).

A frozen, condensed copy of the per-device path: control events (job
arrivals, each request's next response, deadlines) on one heap, check-ins
taken one by one in time order between them, each handed to the scheduler
(``venn.Venn``) unless its atom is dead, grants applied in place, rounds
completed at quorum or retried at their deadline.  No fault injection, no
overcommit.  It imports nothing of the program.

:func:`run` replays one episode to a simulated time and returns what the
benchmark compares: each grant ``(row, job, round)`` by the check-in's row
in the stream, each completed round, and each check-in's atom key as it
was when the check-in was decided.
"""
from __future__ import annotations

import heapq
import itertools
import math

import numpy as np

from .venn import Job, Request, Requirement, Venn, identity, to_f32

JOB_ARRIVAL, RESPONSE, DEADLINE = 0, 1, 2


class Simulator:
    def __init__(self, jobs, sched: Venn, chunks, fail_base: float,
                 fail_slow_boost: float, max_time: float, max_retries: int,
                 q=identity):
        self.jobs = jobs
        self.sched = sched
        self.chunks = chunks            # list of (row offset, arrays dict)
        self.next_chunk = 0
        self.fail_base = fail_base
        self.fail_slow_boost = fail_slow_boost
        self.max_time = max_time
        self.max_retries = max_retries
        self.q = q
        self.seq = itertools.count()
        self.heap = []
        self.now = 0.0
        self.done = 0
        self.open = 0
        self.grants = []                # (row, job_id, round_index)
        self.rounds = []
        self.loaded = []                # (row offset, atom id array)
        self.chunk = None
        for job in jobs:
            self._push(job.arrival_time, JOB_ARRIVAL, job)
        self._load_next_chunk()

    # ------------------------------------------------------------ loop

    def step_until(self, bound: float) -> None:
        bound = min(bound, self.max_time)
        heap = self.heap
        while self.done < len(self.jobs):
            if self._drain(bound):
                return
            if not heap:
                return
            t = heap[0][0]
            if t > bound:
                return
            _, _, kind, payload = heapq.heappop(heap)
            self.now = t
            if kind == JOB_ARRIVAL:
                self._submit(payload, payload.rounds_done)
            elif kind == RESPONSE:
                self._pop_response(payload)
            else:
                self._on_deadline(payload)

    def _drain(self, bound: float) -> bool:
        """Check-ins up to the next control event; True when one crossed
        ``bound``."""
        heap = self.heap
        sched = self.sched
        while True:
            if self.chunk is None:
                return False
            if sched.atoms.version != self.chunk_version:
                self._classify(self.cursor)
            times, aids, spd = self.times, self.aids, self.speed
            n = len(times)
            cursor = self.cursor
            stop = False
            live = sched.live_atoms()
            refreshed = False
            heap_t = heap[0][0] if heap else math.inf
            while cursor < n:
                t = times[cursor]
                if heap_t < t:
                    break
                if t > bound:
                    stop = True
                    break
                if not self.open:
                    self.cursor = cursor
                    self._skip_idle(min(heap_t, bound))
                    times, aids, spd = self.times, self.aids, self.speed
                    n = len(times)
                    cursor = self.cursor
                    continue
                aid = aids[cursor]
                if live is not None and aid < len(live) and not live[aid]:
                    cursor += 1
                    self.now = t
                    continue
                speed = spd[cursor]
                req = sched.checkin(aid, speed, t)
                if live is None and not refreshed:
                    live = sched.live_atoms()
                    refreshed = True
                i = cursor
                cursor += 1
                self.now = t
                if (req is None or req.granted >= req.demand
                        or req.complete_time is not None):
                    continue
                self._grant(req, i, t, speed)
                heap_t = heap[0][0]
            self.cursor = cursor
            if stop:
                return True
            if cursor >= n and self.chunk is not None:
                self._load_next_chunk()
                if self.chunk is not None:
                    continue
            return False

    # ------------------------------------------------------------ grants

    def _grant(self, req: Request, i: int, t: float, speed: float) -> None:
        q = self.q
        self.now = t
        req.granted += 1
        filled = req.granted >= req.demand
        if filled:
            self.open -= 1
        job = req.job
        rt = q(job.task_time_mean / (speed if speed > 1e-3 else 1e-3)
               * math.exp(job.task_time_sigma * self.resp_z[i]))
        ok = not (self.fail_u[i] < q(self.fail_base
                                     + self.fail_slow_boost / (1.0 + speed)))
        t_resp = q(t + rt)
        buf = req.resp_buf
        if buf is None:
            buf = req.resp_buf = []
        heapq.heappush(buf, (t_resp, next(self.seq), speed, rt, ok))
        if t_resp < req.resp_t:
            req.resp_t = t_resp
            heapq.heappush(self.heap, (t_resp, next(self.seq), RESPONSE, req))
        if filled and req.alloc_complete_time is None:
            req.alloc_complete_time = t
            heapq.heappush(self.heap, (q(t + job.deadline), next(self.seq),
                                       DEADLINE, req))
        self.grants.append((self.offset + i, job.job_id, req.round_index))

    def _push(self, t, kind, payload) -> None:
        heapq.heappush(self.heap, (t, next(self.seq), kind, payload))

    # ------------------------------------------------------------ stream

    def _load_next_chunk(self) -> None:
        self.chunk = None
        self.times = self.aids = self.speed = []
        self.resp_z = self.fail_u = []
        if self.next_chunk >= len(self.chunks):
            return
        offset, ck = self.chunks[self.next_chunk]
        self.next_chunk += 1
        self.chunk = ck
        self.offset = offset
        self.ids = None
        self._classify(0)
        self.sched.begin_chunk(ck["times"], self.ids)
        self.times = ck["times"].tolist()
        self.speed = ck["speed"].tolist()
        self.resp_z = ck["resp_z"].tolist()
        self.fail_u = ck["fail_u"].tolist()
        self.aids = self.ids.tolist()
        self.cursor = 0

    def _classify(self, start: int) -> None:
        ck = self.chunk
        ids = self.sched.atoms.classify({"cpu": ck["cpu"][start:],
                                         "mem": ck["mem"][start:]})
        if self.ids is None:
            self.ids = ids
            self.loaded.append((self.offset, ids))
        else:
            self.ids[start:] = ids
            self.aids[start:] = ids.tolist()
        self.chunk_version = self.sched.atoms.version

    def _skip_idle(self, until: float) -> None:
        j = int(np.searchsorted(self.chunk["times"], until, side="right"))
        if j <= self.cursor:
            j = self.cursor + 1
        self.cursor = j
        if self.cursor >= len(self.times):
            self._load_next_chunk()

    # ------------------------------------------------------------ rounds

    def _submit(self, job: Job, round_index: int, aborted: int = 0) -> None:
        req = Request(job, round_index, job.demand_per_round, self.now,
                      aborted)
        req.quorum = math.ceil(job.quorum_fraction * job.demand_per_round)
        job.current = req
        self.open += 1
        self.sched.on_request(req)

    def _pop_response(self, req: Request) -> None:
        buf = req.resp_buf
        if req.resp_t != self.now or not buf:
            return
        if req.complete_time is not None or req.job.current is not req:
            req.resp_buf = None
            req.resp_t = math.inf
            return
        _, _, speed, rt, ok = heapq.heappop(buf)
        if req.complete_time is None and req.job.current is req:
            self.sched.on_response(req, speed, rt, ok)
            if ok:
                req.responses += 1
            else:
                req.failures += 1
            if req.responses >= req.quorum and \
                    req.alloc_complete_time is not None:
                self._complete(req)
        if buf and req.complete_time is None and req.job.current is req:
            req.resp_t = buf[0][0]
            self._push(buf[0][0], RESPONSE, req)
        else:
            req.resp_buf = None
            req.resp_t = math.inf

    def _on_deadline(self, req: Request) -> None:
        if req.complete_time is not None or req.job.current is not req:
            return
        job = req.job
        if req.responses >= req.quorum:
            self._complete(req)
            return
        self.sched.on_complete(req)
        job.current = None
        if req.aborted + 1 >= self.max_retries:
            job.rounds_done += 1
            if job.rounds_done >= job.total_rounds:
                self._finish(job)
                return
        self._submit(job, job.rounds_done, req.aborted + 1)

    def _complete(self, req: Request) -> None:
        req.complete_time = self.now
        job = req.job
        job.rounds_done += 1
        job.attained_service = self.q(job.attained_service
                                      + (self.now - req.submit_time))
        self.rounds.append((job.job_id, req.round_index, req.submit_time,
                            req.alloc_complete_time, self.now, req.demand,
                            req.responses, req.failures, req.aborted))
        self.sched.on_complete(req)
        job.current = None
        if job.rounds_done >= job.total_rounds:
            self._finish(job)
        else:
            self._submit(job, job.rounds_done)

    def _finish(self, job: Job) -> None:
        job.done = True
        job.completion_time = self.now
        self.done += 1


def build(cfg: dict, trace: dict, stream, seed: int, horizon: float,
          precision: str = "float64") -> Simulator:
    """A reference episode over the benchmark's own jobs and stream
    (``stream`` is a ``gen.checkins.Stream``).  ``precision="float32"``
    rounds every input and every stored float to float32: the control."""
    q = identity if precision == "float64" else to_f32
    reqs = [Requirement(r["name"], cpu=q(r["cpu"]), mem=q(r["mem"]))
            for r in cfg["requirements"]]
    jobs = [Job(i, reqs[int(trace["requirement"][i])],
                int(trace["demand"][i]), int(trace["rounds"][i]),
                q(float(trace["arrival"][i])), q(float(trace["task_mean"][i])),
                q(trace["task_sigma"]), q(trace["quorum"]),
                q(float(trace["deadline"][i])))
            for i in range(len(trace["demand"]))]
    chunks = []
    for c in range(stream.num_chunks()):
        ck = stream.chunk(c)
        if precision != "float64":
            ck = {k: v.astype(np.float32).astype(np.float64)
                  for k, v in ck.items()}
        chunks.append((int(stream.bounds[c]), ck))
    s = cfg["scheduler"]
    sched = Venn(seed, s["num_tiers"], s["epsilon"], s["supply_window_s"],
                 q)
    return Simulator(jobs, sched, chunks, q(stream.fail_base),
                     q(stream.fail_slow_boost), horizon,
                     cfg["sim"]["max_round_retries"], q)


def run(cfg: dict, trace: dict, stream, seed: int, horizon: float,
        until: float, precision: str = "float64") -> dict:
    """Replay one episode to ``until`` and return its answers."""
    sim = build(cfg, trace, stream, seed, horizon, precision)
    sim.step_until(until)
    return answers(sim)


def answers(sim: Simulator) -> dict:
    keys = sim.sched.atoms.keys
    return {"grants": sim.grants, "rounds": sim.rounds,
            "loaded": sim.loaded, "atom_keys": list(keys),
            "finished_at": sim.now if sim.done == len(sim.jobs) else None}
