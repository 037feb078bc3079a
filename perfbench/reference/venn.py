"""The plain reference of the VENN resource manager (scheduler side).

A frozen, condensed copy of the scalar path that the program implements:
atoms interned from requirement thresholds, the 24-hour windowed supply
estimator, Algorithm 1 (IRS) recomputed in full at every replan, the
dispatch table lowered from its plan, Algorithm 2's tier decisions, and
the fairness knob ε of Sec. 4.4, which biases Algorithm 1's two inputs by
each job's attained service against its fair share.  Plain Python and
NumPy; it imports nothing of the program and keeps no device state.  Only
the settings a configuration's ``scheduler`` can state are kept: the
number of tiers, the supply window and ε; IRS and matching are always on,
and there are no tenant priorities.  At ε = 0 the fairness code is never
entered, so the answers are those of Sec. 4.2 alone.

``q`` is the rounding applied where a float is stored: the identity for
the configuration's float64, or a round to float32 for the control that
``perfbench/check.py`` holds against it (every input and every derived
time, rate and key rounded to float32).
"""
from __future__ import annotations

import math
import random
from typing import Dict, FrozenSet, List, Optional

import numpy as np

AtomKey = FrozenSet[str]

# the fairness knob's clamp on a usage ratio before its ε-power
FAIR_LO, FAIR_HI = 0.7, 1.45


def identity(x):
    return x


def to_f32(x):
    return float(np.float32(x))


# --------------------------------------------------------------- domain


class Requirement:
    __slots__ = ("name", "mins")

    def __init__(self, name: str, **mins: float):
        self.name = name
        self.mins = tuple(sorted(mins.items()))


class Request:
    """One round's request for devices."""

    __slots__ = ("job", "round_index", "demand", "submit_time", "granted",
                 "responses", "failures", "quorum", "alloc_complete_time",
                 "complete_time", "aborted", "resp_buf", "resp_t")

    def __init__(self, job, round_index, demand, submit_time, aborted=0):
        self.job = job
        self.round_index = round_index
        self.demand = demand
        self.submit_time = submit_time
        self.granted = 0
        self.responses = 0
        self.failures = 0
        self.quorum = 0
        self.alloc_complete_time = None
        self.complete_time = None
        self.aborted = aborted
        self.resp_buf = None
        self.resp_t = math.inf

    @property
    def remaining(self) -> int:
        d = self.demand - self.granted
        return d if d > 0 else 0


class Job:
    __slots__ = ("job_id", "requirement", "demand_per_round", "total_rounds",
                 "arrival_time", "task_time_mean", "task_time_sigma",
                 "quorum_fraction", "deadline", "rounds_done", "current",
                 "completion_time", "attained_service", "done")

    def __init__(self, job_id, requirement, demand_per_round, total_rounds,
                 arrival_time, task_time_mean, task_time_sigma,
                 quorum_fraction, deadline):
        self.job_id = job_id
        self.requirement = requirement
        self.demand_per_round = demand_per_round
        self.total_rounds = total_rounds
        self.arrival_time = arrival_time
        self.task_time_mean = task_time_mean
        self.task_time_sigma = task_time_sigma
        self.quorum_fraction = quorum_fraction
        self.deadline = deadline
        self.rounds_done = 0
        self.current: Optional[Request] = None
        self.completion_time = None
        self.attained_service = 0.0
        self.done = False

    def __hash__(self) -> int:
        return self.job_id

    @property
    def remaining_demand(self) -> int:
        r = self.current
        if r is not None:
            d = r.demand - r.granted
            return d if d > 0 else 0
        return self.demand_per_round

    @property
    def remaining_rounds(self) -> int:
        return max(0, self.total_rounds - self.rounds_done)


class Group:
    """The jobs of one requirement."""

    def __init__(self, requirement: Requirement):
        self.requirement = requirement
        self.jobs: List[Job] = []
        self.eligible_atoms: FrozenSet[AtomKey] = frozenset()
        self.supply = 0.0
        self.atom_rates: Dict[AtomKey, float] = {}
        self.allocation: Dict[AtomKey, float] = {}

    @property
    def queue_len(self) -> int:
        return len([j for j in self.jobs if j.current is not None])

    @property
    def alloc_rate(self) -> float:
        return sum(self.allocation.values())

    def pending_jobs(self) -> List[Job]:
        return [j for j in self.jobs
                if (r := j.current) is not None and r.demand > r.granted]


# ------------------------------------------------------ eligibility atoms


class Atoms:
    """Requirement thresholds and the dense ids of the atoms (the sets of
    requirement names a device satisfies), in order of first sight."""

    def __init__(self):
        self.requirements: List[Requirement] = []
        self.keys: List[AtomKey] = []
        self.ids: Dict[AtomKey, int] = {}
        self.version = 0
        self._cap_names: List[str] = []
        self._mins = np.zeros((0, 0))
        self._lut = None
        self._lut_version = -1
        self._rebuild()

    def intern(self, key: AtomKey) -> int:
        aid = self.ids.get(key)
        if aid is None:
            aid = self.ids[key] = len(self.keys)
            self.keys.append(key)
        return aid

    def add(self, req: Requirement) -> None:
        if any(r.name == req.name for r in self.requirements):
            return
        self.requirements.append(req)
        self._rebuild()

    def _rebuild(self) -> None:
        names: List[str] = []
        for r in self.requirements:
            for cap, _ in r.mins:
                if cap not in names:
                    names.append(cap)
        self._cap_names = names
        mins = np.full((len(self.requirements), len(names)), -np.inf)
        for i, r in enumerate(self.requirements):
            for cap, lo in r.mins:
                mins[i, names.index(cap)] = lo
        self._mins = mins
        self.version += 1

    def classify(self, caps: Dict[str, np.ndarray]) -> np.ndarray:
        n = len(next(iter(caps.values())))
        R = len(self.requirements)
        if R == 0 or n == 0:
            return np.full(n, self.intern(frozenset()), dtype=np.int64)
        if R > 16:
            raise ValueError("the reference classifies up to 16 requirements")
        mat = np.zeros((n, len(self._cap_names)))
        for j, name in enumerate(self._cap_names):
            mat[:, j] = caps[name]
        sat = (mat[:, None, :] >= self._mins[None, :, :]).all(axis=2)
        codes = sat @ (np.int64(1) << np.arange(R, dtype=np.int64))
        if self._lut is None or self._lut_version != self.version:
            self._lut = np.full(1 << R, -1, dtype=np.int64)
            self._lut_version = self.version
        lut = self._lut
        out = lut[codes]
        if (out >= 0).all():
            return out
        names = [r.name for r in self.requirements]
        # new codes are interned in ascending order
        for code in np.unique(codes[out < 0]).tolist():
            lut[code] = self.intern(frozenset(
                nm for b, nm in enumerate(names) if code >> b & 1))
        return lut[codes]


# ----------------------------------------------------- supply estimator


class Supply:
    """Per-atom check-in counts in 60-s buckets over a trailing window."""

    def __init__(self, window: float, q, prior_rate: float = 0.1,
                 bucket: float = 60.0):
        self.window = float(window)
        self.prior_rate = prior_rate
        self.bucket = bucket
        self.q = q
        self.nb = int(math.ceil(self.window / bucket)) + 1
        self.counts = np.zeros((0, self.nb), dtype=np.int64)
        self.totals = np.zeros(0, dtype=np.int64)
        self.next_evict = np.zeros(0, dtype=np.int64)
        self.evicted_to = 0
        self.t0: Optional[float] = None
        self.now = 0.0

    def _ensure(self, aid: int) -> None:
        n = len(self.totals)
        if aid < n:
            return
        grow = aid + 1 - n
        self.counts = np.vstack([self.counts,
                                 np.zeros((grow, self.nb), dtype=np.int64)])
        self.totals = np.concatenate([self.totals,
                                      np.zeros(grow, dtype=np.int64)])
        self.next_evict = np.concatenate([
            self.next_evict,
            np.full(grow, max(self.evicted_to, 0), dtype=np.int64)])

    def _horizon(self) -> int:
        return int(math.ceil((self.now - self.window) / self.bucket))

    def _evict(self) -> None:
        h = self._horizon()
        if h <= self.evicted_to:
            return
        for a in range(len(self.totals)):
            gap = h - int(self.next_evict[a])
            if gap >= self.nb:
                self.counts[a] = 0
                self.totals[a] = 0
            elif gap > 0:
                idx = np.arange(int(self.next_evict[a]), h) % self.nb
                self.totals[a] -= int(self.counts[a, idx].sum())
                self.counts[a, idx] = 0
            self.next_evict[a] = h
        self.evicted_to = h

    def record(self, atom_ids: np.ndarray, times: np.ndarray,
               babs: np.ndarray) -> None:
        if len(times) == 0:
            return
        self._ensure(int(atom_ids.max()))
        if self.t0 is None:
            self.t0 = float(times[0])
        self.now = max(self.now, float(times[-1]))
        self._evict()
        keep = babs >= self._horizon()
        babs, atom_ids = babs[keep], atom_ids[keep]
        np.add.at(self.counts, (atom_ids, babs % self.nb), 1)
        adds = np.bincount(atom_ids)
        self.totals[:len(adds)] += adds

    def advance(self, now: float) -> None:
        self.now = max(self.now, now)
        self._evict()

    def rates(self):
        """``(seen, rates)`` over atom ids."""
        self._evict()
        t0 = self.t0 if self.t0 is not None else 0.0
        span = min(self.window, max(self.now - t0, self.bucket))
        seen = self.totals > 0
        return seen, [self.q(v) for v in
                      np.where(seen, self.totals / span,
                               self.prior_rate).tolist()]


# ------------------------------------------------- Algorithm 1 (IRS)


def _atom_order(g: Group):
    return g.atom_rates if g.atom_rates else g.eligible_atoms


def _fair_clamp(r: float) -> float:
    return min(max(r, FAIR_LO), FAIR_HI)


def _pressure(queue: float, alloc_rate: float) -> float:
    if queue <= 0:
        return 0.0
    if alloc_rate <= 0:
        return math.inf
    return queue / alloc_rate


def venn_schedule(groups: List[Group], demand_key, queue_len):
    """``(job_order, atom_priority)`` of one VENN-SCHED run: each group's
    jobs by ``demand_key`` (then id), and each atom's groups, owners
    first, then the others scarcest first; a group takes a donor's shared
    atoms while its ``queue_len`` over its allocated rate is the higher."""
    active = [g for g in groups if g.pending_jobs()]
    job_order: Dict[str, List[Job]] = {}
    for g in active:
        keyed = sorted((demand_key(j), j.job_id, j)
                       for j in g.pending_jobs())
        job_order[g.requirement.name] = [j for _, _, j in keyed]
    if not active:
        return job_order, {}
    claimed = set()
    for g in sorted(active, key=lambda g: (g.supply, g.requirement.name)):
        alloc = {}
        for a in _atom_order(g):
            if a not in claimed:
                alloc[a] = g.atom_rates.get(a, 0.0)
                claimed.add(a)
        g.allocation = alloc
    for gj in sorted(active, key=lambda g: (-g.supply, g.requirement.name)):
        donors = [gk for gk in active
                  if gk is not gj and gk.supply < gj.supply
                  and not gk.eligible_atoms.isdisjoint(gj.eligible_atoms)]
        donors.sort(key=lambda g: (-g.supply, g.requirement.name))
        for gk in donors:
            if _pressure(queue_len(gj), gj.alloc_rate) > \
                    _pressure(queue_len(gk), gk.alloc_rate):
                shared = [a for a in _atom_order(gj) if a in gk.allocation]
                for a in shared:
                    gj.allocation[a] = gj.allocation.get(a, 0.0) \
                        + gk.allocation.pop(a)
            else:
                break
    universe: Dict[AtomKey, None] = {}
    for g in active:
        for a in _atom_order(g):
            universe.setdefault(a)
    priority: Dict[AtomKey, List[Group]] = {}
    for a in universe:
        owners = [g for g in active if a in g.allocation]
        rest = [g for g in active
                if a in g.eligible_atoms and a not in g.allocation]
        rest.sort(key=lambda g: (g.supply, g.requirement.name))
        priority[a] = owners + rest
    return job_order, priority


# ---------------------------------------------- Algorithm 2 (tiers)


class Profile:
    """A job's (speed, response time) samples from earlier rounds."""

    def __init__(self, max_samples: int = 2048):
        self.max_samples = max_samples
        self.speeds: List[float] = []
        self.rts: List[float] = []
        self.p95: Optional[float] = None    # cached by ``Venn._t_response``

    def record(self, speed: float, rt: float) -> None:
        self.speeds.append(speed)
        self.rts.append(rt)
        self.p95 = None
        if len(self.rts) >= 2 * self.max_samples:
            self._truncate()

    def _truncate(self) -> None:
        m = self.max_samples
        if len(self.rts) > m:
            del self.speeds[:-m]
            del self.rts[:-m]

    def sorted_views(self):
        self._truncate()
        speeds = np.asarray(self.speeds)
        rts = np.asarray(self.rts)
        order = np.argsort(speeds)
        return speeds[order], rts[order], np.sort(rts)

    @property
    def n(self) -> int:
        return min(len(self.rts), self.max_samples)


def _pct(sorted_vals, q: float) -> float:
    if len(sorted_vals) == 0:
        return math.nan
    i = min(len(sorted_vals) - 1,
            max(0, int(math.ceil(q * len(sorted_vals))) - 1))
    return float(sorted_vals[i])


def decide_tier(rng: random.Random, v: int, prof: Profile, t_schedule: float,
                t_response: float, q):
    """``(lo, hi)``, the speed band of a tiered request, or None."""
    if v <= 1 or prof.n < 4 * v or t_schedule <= 0:
        return None
    speeds, rts_by_speed, sorted_rts = prof.sorted_views()
    u = rng.randrange(v)
    n = len(speeds)
    lo = 0.0 if u == 0 else float(speeds[(u * n) // v])
    hi = math.inf if u == v - 1 else float(speeds[min(((u + 1) * n) // v,
                                                      n - 1)])
    i0 = int(np.searchsorted(speeds, lo, side="left"))
    i1 = int(np.searchsorted(speeds, hi, side="left"))
    tier_rt = np.sort(rts_by_speed[i0:i1])
    t0 = _pct(sorted_rts, 0.95)
    if len(tier_rt) == 0 or not math.isfinite(t0) or t0 <= 0:
        g_u = 1.0
    else:
        g_u = q(_pct(tier_rt, 0.95) / t0)
    c_i = q(t_response / t_schedule)
    if v + q(g_u * c_i) < q(c_i + 1.0):
        return lo, hi
    return None


# -------------------------------------------------------- the manager


class Venn:
    """The scheduler: replans lazily at the first check-in after a request
    arrives or completes, then serves check-ins from its dispatch table."""

    def __init__(self, seed: int, num_tiers: int, epsilon: float,
                 supply_window: float, q=identity):
        self.q = q
        self.epsilon = q(float(epsilon))
        self.atoms = Atoms()
        self.supply = Supply(supply_window, q)
        self.rng = random.Random(seed + 1)
        self.v = num_tiers
        self.groups: Dict[str, Group] = {}
        self.profiles: Dict[int, Profile] = {}
        self.slots: List[Optional[list]] = []
        self.live: List[bool] = []
        self.tiers: Dict[int, tuple] = {}       # id(request) -> (lo, hi)
        self.tier_decided: Dict[int, tuple] = {}
        self.plan_dirty = True
        self.job_order: Dict[str, List[Job]] = {}
        self.replans = 0
        self.feed = None                        # (times, ids, buckets, pos)

    def on_request(self, req: Request) -> None:
        r = req.job.requirement
        self.atoms.add(r)
        g = self.groups.get(r.name)
        if g is None:
            g = self.groups[r.name] = Group(r)
        if req.job not in g.jobs:
            g.jobs.append(req.job)
        self.plan_dirty = True

    def on_complete(self, req: Request) -> None:
        self.tiers.pop(id(req), None)
        g = self.groups.get(req.job.requirement.name)
        if g and req.job.remaining_rounds == 0 and req.job in g.jobs:
            g.jobs.remove(req.job)
        self.plan_dirty = True

    def on_response(self, req: Request, speed: float, rt: float,
                    ok: bool) -> None:
        if ok:
            prof = self.profiles.get(req.job.job_id)
            if prof is None:
                prof = self.profiles[req.job.job_id] = Profile()
            prof.record(speed, rt)

    def begin_chunk(self, times: np.ndarray, ids: np.ndarray) -> None:
        self._absorb(math.inf)
        self.feed = [times, ids,
                     (times // self.supply.bucket).astype(np.int64), 0]

    def _absorb(self, now: float) -> None:
        f = self.feed
        if f is None or f[3] >= len(f[0]):
            return
        hi = int(np.searchsorted(f[0], now, side="right"))
        if hi <= f[3]:
            return
        self.supply.record(f[1][f[3]:hi], f[0][f[3]:hi], f[2][f[3]:hi])
        f[3] = hi

    def live_atoms(self):
        return None if self.plan_dirty else self.live
    def checkin(self, aid: int, speed: float, now: float):
        if self.plan_dirty:
            self._replan(now)
        slots = self.slots[aid] if aid < len(self.slots) else None
        if slots is None:
            # an atom no plan covers yet: replan once, then take the first
            # open slot that accepts the speed (filled slots popped)
            self._replan(now)
            slots = self.slots[aid] if aid < len(self.slots) else None
            if slots is None:
                return None
            i = 0
            while i < len(slots):
                req = slots[i][0]
                if req.demand - req.granted <= 0:
                    slots.pop(i)
                    continue
                if slots[i][1] <= speed < slots[i][2]:
                    return req
                i += 1
            return None
        if not slots:
            self.live[aid] = False
            return None
        found = None
        dead = False
        for slot in slots:
            req = slot[0]
            if req.demand > req.granted:
                if slot[1] <= speed < slot[2]:
                    found = req
                    break
            else:
                dead = True
        if dead:
            slots[:] = [s for s in slots if s[0].demand > s[0].granted]
            if not slots:
                self.live[aid] = False
        return found

    def _replan(self, now: float) -> None:
        self.replans += 1
        self.plan_dirty = False
        self._absorb(now)
        self.supply.advance(now)
        seen, rates = self.supply.rates()
        keys = self.atoms.keys
        atoms = {keys[a] for a in np.flatnonzero(seen).tolist()}
        active = [g for g in self.groups.values() if g.pending_jobs()]
        ids = self.atoms.ids
        for g in active:
            name = g.requirement.name
            elig = frozenset(a for a in atoms if name in a)
            g.eligible_atoms = elig
            aids = sorted(ids[a] for a in elig)
            g.atom_rates = {keys[a]: rates[a] for a in aids}
            g.supply = self.q(sum(g.atom_rates.values()))
            g.allocation = {}
        if self.epsilon > 0.0:
            num_jobs = sum(len(g.pending_jobs()) for g in active)
            queues = {g.requirement.name: self._queue_len(g, num_jobs)
                      for g in active}
            self.job_order, priority = venn_schedule(
                active, lambda j: self._demand_key(j, num_jobs),
                lambda g: queues[g.requirement.name])
        else:
            self.job_order, priority = venn_schedule(
                active, lambda j: float(j.remaining_demand),
                lambda g: float(g.queue_len))
        for a in atoms:
            priority.setdefault(a, [])
        self._decide_tiers()
        self._compile(priority)

    def _decide_tiers(self) -> None:
        kept: Dict[int, tuple] = {}
        for jobs in self.job_order.values():
            if not jobs:
                continue
            job = jobs[0]
            req = job.current
            if req is None:
                continue
            if self.tier_decided.get(job.job_id) == (req.round_index,
                                                     req.aborted):
                prev = self.tiers.get(id(req))
                if prev is not None:
                    kept[id(req)] = prev
                continue
            prof = self.profiles.get(job.job_id)
            if prof is None:
                prof = self.profiles[job.job_id] = Profile()
            rate = self.groups[job.requirement.name].alloc_rate
            t_sched = self.q(req.remaining / rate) if rate > 0 else math.inf
            band = decide_tier(self.rng, self.v, prof, t_sched,
                               self._t_response(job, prof), self.q)
            self.tier_decided[job.job_id] = (req.round_index, req.aborted)
            if band is not None:
                kept[id(req)] = band
        self.tiers = kept

    # ------------------------------------------------ the fairness knob

    def _t_response(self, job: Job, prof: Profile) -> float:
        """The job's response time: the p95 of its profile's samples once
        it has 8, else the log-normal prior's p95."""
        if prof.n >= 8:
            if prof.p95 is None:
                rts = prof.sorted_views()[2]
                prof.p95 = float(rts[min(len(rts) - 1,
                                         int(0.95 * len(rts)))])
            return prof.p95
        return self.q(job.task_time_mean
                      * math.exp(1.645 * job.task_time_sigma))

    def _solo_jct(self, job: Job) -> float:
        """``sd_i``, the job's contention-free completion time: its
        remaining rounds (at least one) at its group's supply (the
        estimator's prior rate where that is 0) plus its response time."""
        g = self.groups.get(job.requirement.name)
        rate = g.supply if g and g.supply > 0 else self.supply.prior_rate
        prof = self.profiles.get(job.job_id)
        if prof is None:
            prof = self.profiles[job.job_id] = Profile()
        q = self.q
        per_round = q(q(job.demand_per_round / rate)
                      + self._t_response(job, prof))
        return q(max(job.remaining_rounds, 1) * per_round)

    def _demand_key(self, job: Job, num_jobs: int) -> float:
        """``d' = d * clamp(t / T)^ε``: the remaining demand ``d`` biased by
        the job's attained service ``t`` against its fair share
        ``T = max(num_jobs, 1) * sd``."""
        q = self.q
        t_fair = q(max(num_jobs, 1) * max(self._solo_jct(job), 1e-9))
        usage = _fair_clamp(q(job.attained_service / t_fair))
        return q(float(job.remaining_demand) * q(usage ** self.epsilon))

    def _queue_len(self, g: Group, num_jobs: int) -> float:
        """``q' = q * clamp(ΣT / Σt)^ε`` over the group's jobs that hold a
        request, summed in the group's job order."""
        n = float(g.queue_len)
        if n == 0:
            return n
        q = self.q
        held = [j for j in g.jobs if j.current is not None]
        tot_fair = 0
        for j in held:
            tot_fair = q(tot_fair + q(max(num_jobs, 1)
                                      * max(self._solo_jct(j), 1e-9)))
        tot_used = 0
        for j in held:
            tot_used = q(tot_used + max(j.attained_service, 0.0))
        ratio = _fair_clamp(q(tot_fair / max(tot_used, 1e-9)))
        return q(n * q(ratio ** self.epsilon))

    def _compile(self, priority: Dict[AtomKey, List[Group]]) -> None:
        lowered: Dict[str, list] = {}
        for name, jobs in self.job_order.items():
            rows = []
            for pos, job in enumerate(jobs):
                req = job.current
                if req is None or req.demand - req.granted <= 0:
                    continue
                lo, hi = -math.inf, math.inf
                if pos == 0 and id(req) in self.tiers:
                    lo, hi = self.tiers[id(req)]
                rows.append([req, lo, hi])
            lowered[name] = rows
        slots: List[Optional[list]] = [None] * len(self.atoms.keys)
        memo: Dict[tuple, list] = {}
        for key, groups in priority.items():
            aid = self.atoms.intern(key)
            if aid >= len(slots):
                slots.extend([None] * (aid + 1 - len(slots)))
            names = tuple(g.requirement.name for g in groups)
            merged = memo.get(names)
            if merged is None:
                merged = memo[names] = []
                for g in groups:
                    merged.extend(lowered.get(g.requirement.name, ()))
            slots[aid] = merged
        self.slots = slots
        self.live[:] = [s is None or len(s) > 0 for s in slots]
