"""VennScheduler — the full resource manager (Fig. 6) wiring together:

* the eligibility index (interned atoms over requirements),
* the 24-h windowed supply estimator (§4.4),
* Algorithm 1 (IRS job scheduling) on every request arrival/completion,
* Algorithm 2 (tier-based matching) for the currently served jobs,
* the ε fairness knob (§4.4),
* the compiled dispatch table (the per-check-in O(1) fast path).

It exposes the same simulator-facing interface as the baselines:
``on_request`` / ``on_complete`` / ``assign`` / ``on_response``, plus the
vectorized chunk hooks ``classify_caps`` / ``begin_chunk`` / ``checkin``:
after every VENN-SCHED invocation the :class:`~repro_torch.core.irs.SchedulePlan`
is lowered into a :class:`~repro_torch.core.dispatch.DispatchTable`, so a check-in
is an atom-id index plus a couple of float compares.  Device check-in streams
are fed as struct-of-arrays (``begin_chunk``) and absorbed into the supply
estimator lazily, in batch, the next time the schedule is recomputed.
"""
from __future__ import annotations

import math
import os
import random
import time
from typing import Dict, FrozenSet, List, Optional

import numpy as np

from ..obs import audit as _obsaudit
from ..obs import metrics as _obsmetrics
from ..obs import trace as _obstrace
from .baselines import BaseScheduler
from .dispatch import DispatchTable, MISS, compile_plan
from .eligibility import EligibilityIndex
from .fairness import FairnessPolicy
from .irs import SchedulePlan, venn_schedule
from .matching import JobProfile, TierDecision, TierMatcher
from .supply import SupplyEstimator
from .types import Device, Job, JobGroup, JobRequest

AtomKey = FrozenSet[str]


class VennScheduler(BaseScheduler):
    name = "venn"

    def __init__(self, seed: int = 0, num_tiers: int = 4, epsilon: float = 0.0,
                 supply_window: float = 24 * 3600.0, enable_matching: bool = True,
                 enable_irs: bool = True, replan: Optional[str] = None,
                 device=None):
        super().__init__(seed)
        # where the array replan's resort kernel runs (None: cuda:0, resolved
        # when the replan engine is first built; "cpu" for host-only runs)
        self.device = device
        # replan backend: "auto"/"array" = incremental array engine
        # (repro_torch.accel.replan, bit-identical), "scalar" = reference
        # venn_schedule + compile_plan.  Default resolves from REPRO_REPLAN
        # so CLI runs can pin the scalar path for byte-identity comparisons.
        if replan is None:
            replan = os.environ.get("REPRO_REPLAN", "auto")
        if replan not in ("auto", "array", "scalar"):
            raise ValueError(f"unknown replan mode {replan!r}")
        self.replan_mode = replan
        self._replan = None                # lazy ReplanEngine
        # one shared atom-id space: classification ids feed the estimator
        # directly (no index->supply translation table)
        self.supply = SupplyEstimator(window=supply_window,
                                      interner=self.index.interner)
        self.matcher = TierMatcher(num_tiers=num_tiers, rng=random.Random(seed + 1))
        self.fairness = FairnessPolicy(epsilon=epsilon)
        self.enable_matching = enable_matching
        self.enable_irs = enable_irs           # ablation: FIFO order + matching
        self.groups: Dict[str, JobGroup] = {}
        self.profiles: Dict[int, JobProfile] = {}
        self.plan: SchedulePlan = SchedulePlan()
        self.dispatch: DispatchTable = DispatchTable()
        # per-atom-id liveness, mutated IN PLACE at every replan so the
        # simulator's per-segment reference stays current even across the
        # lazy unseen-atom replans that happen mid-drain
        self._live: List[bool] = []
        self.tier_decisions: Dict[int, TierDecision] = {}   # request id()->decision
        self._tier_decided: Dict[int, tuple] = {}           # job_id -> (round, attempt)
        self.sched_invocations = 0
        # request arrival/completion marks the plan dirty; the replan runs
        # lazily at the next check-in (a completion that immediately submits
        # the next round therefore costs one replan, not two -- the plan in
        # between is never consulted)
        self._plan_dirty = True
        # pending chunk feed (struct-of-arrays), absorbed lazily at replans
        self._feed_times: Optional[np.ndarray] = None
        self._feed_ids: Optional[np.ndarray] = None
        self._feed_babs: Optional[np.ndarray] = None
        self._feed_pos = 0
        # ---- match-delta bookkeeping (the array engine's mirror patches) --
        # Per replan we record which atom ids' dispatch rows may have changed
        # since the previous replan; the engine unions the entries between
        # its mirror's token and the current one (match_delta) and patches
        # only those rows.  Two detection modes, picked per replan:
        #   * array replan engine active: per-atom row-object identity —
        #     ReplanEngine.compile reuses lowered/merged lists only when
        #     their content is untouched, so `row is prev_row` is sound;
        #   * scalar replan: per-atom priority-name tuples plus the set of
        #     group names that saw an on_request/on_complete/on_grant since
        #     the last replan (fairness drift has no event, so ε > 0 reports
        #     no delta and the engine falls back to a full rebuild).
        self._prev_rows: Optional[list] = None     # row objects (array mode)
        self._prev_names: Optional[list] = None    # name tuples (scalar mode)
        self._prev_version = -1
        self._dirty_names: set = set()
        # (sched_invocations, dirty-atom-id set or None) per replan, newest
        # last; bounded so a long-idle mirror just falls back to a rebuild
        self._delta_log: List[tuple] = []

    # ------------------------------------------------------- crash snapshots

    def __getstate__(self):
        """``tier_decisions`` is keyed by ``id(request)`` — meaningless in a
        new process.  Pickle it as (request, decision) pairs; the requests
        are the same objects as in ``self.pending``, so the pickle memo keeps
        identity and ``__setstate__`` can re-key by the *restored* ids."""
        d = super().__getstate__()
        d["tier_decisions"] = [(req, dec) for req, dec in
                               ((r, self.tier_decisions.get(id(r)))
                                for r in self.pending) if dec is not None]
        # the incremental replan engine is a derived cache keyed by object
        # identity; drop it and let the first post-restore replan rebuild
        # from the authoritative group state (incremental ≡ full recompute)
        d["_replan"] = None
        # match-delta bookkeeping is identity-keyed too: reset it so the
        # first post-restore replan reports no delta and the array engine's
        # mirror resyncs via a full rebuild
        d["_prev_rows"] = None
        d["_prev_names"] = None
        d["_dirty_names"] = set()
        d["_delta_log"] = []
        return d

    def __setstate__(self, d):
        pairs = d.pop("tier_decisions", [])
        self.__dict__.update(d)
        self.tier_decisions = {id(req): dec for req, dec in pairs}

    # ------------------------------------------------------------ sim hooks

    def on_request(self, request: JobRequest, now: float) -> None:
        req = request.requirement
        self.index.add_requirement(req)
        g = self.groups.get(req.name)
        if g is None:
            g = self.groups[req.name] = JobGroup(requirement=req)
        if request.job not in g.jobs:
            g.jobs.append(request.job)
        self.pending.append(request)
        self._plan_dirty = True
        self._dirty_names.add(req.name)
        if self._replan is not None:
            self._replan.on_request(request)

    def on_complete(self, request: JobRequest, now: float) -> None:
        if request in self.pending:
            self.pending.remove(request)
        self.tier_decisions.pop(id(request), None)
        g = self.groups.get(request.requirement.name)
        if g and request.job.remaining_rounds == 0 and request.job in g.jobs:
            g.jobs.remove(request.job)
        self._plan_dirty = True
        self._dirty_names.add(request.requirement.name)
        if self._replan is not None:
            self._replan.on_complete(request)

    def on_grant(self, request: JobRequest) -> None:
        """Keep the incremental replan engine's demand-key mirror current
        (grants change ``remaining_demand`` — and a fill removes the job
        from the pending set — without any other scheduler hook firing)."""
        self._dirty_names.add(request.requirement.name)
        if self._replan is not None:
            self._replan.on_grant(request)

    def on_response(self, request: JobRequest, device: Device,
                    response_time: float, ok: bool, now: float) -> None:
        if ok:
            prof = self.profiles.get(request.job.job_id)
            if prof is None:
                prof = self.profiles[request.job.job_id] = JobProfile()
            prof.record(device.speed, response_time)

    # ------------------------------------------------------------- fast path

    def begin_chunk(self, times: np.ndarray, atom_ids: np.ndarray) -> None:
        """Feed a pre-classified struct-of-arrays check-in chunk.

        The arrays are held by reference (the simulator may re-classify the
        unprocessed tail in place when the requirement set grows) and absorbed
        into the supply estimator in batch at the next replan."""
        # a new chunk only starts once the previous one is fully in the sim's
        # past; absorb whatever of it the last replan didn't reach
        self._absorb_feed(math.inf)
        self._feed_times = times
        self._feed_ids = atom_ids
        # bucket the whole chunk once, outside any replan span: each replan's
        # absorb then slices precomputed indices instead of re-dividing its
        # window of times (identical integer buckets, computed earlier)
        self._feed_babs = (times // self.supply.bucket).astype(np.int64)
        self._feed_pos = 0

    def checkin(self, atom_id: int, cpu: float, mem: float, speed: float,
                now: float) -> Optional[JobRequest]:
        """O(1) device check-in: dispatch-table index + tier band compare.

        The slot scan mirrors ``DispatchTable.assign`` inline — this is the
        hottest call in the system and the extra frame is measurable."""
        if self._plan_dirty:
            self._reschedule(now)
        by_atom = self.dispatch._slots
        slots = by_atom[atom_id] if atom_id < len(by_atom) else None
        if slots is None:
            # unseen atom (no plan yet covers it): replan once; the rebuilt
            # table covers every interned atom, so idle periods never replan
            # per check-in.
            self._reschedule(now)
            req = self.dispatch.assign(atom_id, speed)
            return None if req is MISS else req
        if not slots:
            # compiled merged lists may be shared across atoms: another
            # atom's filter pass can empty this list without marking *this*
            # atom dead, so catch up here (an empty slot list always means
            # "no candidate" — exactly what a recompile would record)
            self._live[atom_id] = False
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
                dead = True     # filled since compile
        if dead:                # amortized invalidation: drop filled slots
            slots[:] = [s for s in slots if s[0].demand > s[0].granted]
            if not slots:       # atom went dead: let the drain loop skip it
                self._live[atom_id] = False
        return found

    def live_atoms(self) -> Optional[List[bool]]:
        """Dead-atom bitmap for the drain loop; None while the plan is dirty
        (stale liveness must not suppress check-ins that a replan would
        serve)."""
        return None if self._plan_dirty else self._live

    def assign(self, device: Device, now: float) -> Optional[JobRequest]:
        """Scalar compatibility path (classify + record + fast dispatch)."""
        atom = self.index.atom_of(device)
        self.supply.record(atom, now)
        return self.checkin(device.atom_id, 0.0, 0.0, device.speed, now)

    # ---------------------------------------------------- array-engine hooks

    @property
    def plan_dirty(self) -> bool:
        """Whether the plan is stale (a request arrived or completed since
        the last replan): the next ``checkin`` or ``prepare_match``
        replans."""
        return self._plan_dirty

    def prepare_match(self, now: float) -> None:
        """Make the compiled decision state current (lazy replan), exactly as
        the first ``checkin`` of a drain segment would."""
        if self._plan_dirty:
            self._reschedule(now)

    def match_token(self) -> tuple:
        """Identity of the current decision state: changes whenever the atom
        partition refines or VENN-SCHED recompiles the dispatch table."""
        return (self.index.version, self.sched_invocations)

    def export_match_slots(self, limit: Optional[int] = None):
        """Per-atom candidate slots for the array engine: ``None`` marks an
        atom the compiled plan does not cover (the check-in must take the
        scalar ``checkin`` path, which replans — the MISS protocol).

        ``limit`` caps each atom's exported prefix: a check-in scans its
        atom's list only until the first live band-accepting slot, so the
        engine rarely needs more than a few entries, and exporting prefixes
        keeps the per-replan mirror rebuild O(atoms x limit) instead of
        O(atoms x pending jobs).  The engine detects prefix exhaustion and
        re-exports wider."""
        if limit is None:
            return self.dispatch.snapshot()
        return [s if s is None else
                [(slot[0], slot[1], slot[2]) for slot in s[:limit]]
                for s in self.dispatch._slots]

    def export_match_rows(self, atom_ids, limit: Optional[int] = None,
                          copy: bool = True):
        """Candidate rows for ``atom_ids`` only — the mirror-patch export.
        ``copy=False`` hands out the live slot lists (synchronous consumers
        only; see :meth:`DispatchTable.snapshot_rows`)."""
        return self.dispatch.snapshot_rows(atom_ids, limit, copy=copy)

    def match_delta(self, base_token: tuple):
        """Atom ids whose dispatch rows may differ between ``base_token``
        and the current :meth:`match_token`, or ``None`` when only a full
        mirror rebuild is sound (atom-partition refinement, atom-universe
        growth, fairness drift, restore, or a delta log too old to cover
        the gap).  The returned set is a *superset* of the changed atoms —
        patching it from :meth:`export_match_rows` truth is always exact."""
        if base_token[0] != self.index.version:
            return None                     # partition refined: structural
        base_inv = base_token[1]
        log = self._delta_log
        if not log or log[0][0] > base_inv + 1:
            return None                     # gap not covered by the log
        dirty: set = set()
        for inv, entry in log:
            if inv <= base_inv:
                continue
            if entry is None:
                return None                 # a structural replan in the gap
            dirty |= entry
        return dirty

    def _note_match_delta(self, eng) -> None:
        """Record this replan's dirty-atom set (called at the end of every
        ``_reschedule``, after the new dispatch table is published)."""
        slots = self.dispatch._slots
        entry: Optional[set] = None
        if eng is not None:
            # array replan mode: ReplanEngine.compile reuses a lowered /
            # merged row object only while its content is untouched (fills
            # and completions force fresh order objects), so row identity
            # across replans is a sound clean test
            prev = self._prev_rows
            if (prev is not None and len(prev) == len(slots)
                    and self._prev_version == self.index.version):
                entry = {aid for aid, row in enumerate(slots)
                         if row is not prev[aid]}
            self._prev_rows = list(slots)
            self._prev_names = None
        else:
            # scalar replan mode: compile_plan builds fresh lists every time,
            # so identity never matches — compare per-atom priority-name
            # tuples, and dirty every atom whose constituent groups saw an
            # event since the last replan.  Fairness keys drift without
            # events (they move with supply), so ε > 0 reports no delta.
            names: List[Optional[tuple]] = [None] * len(slots)
            id_of = self.index.id_of
            for key, groups in self.plan.atom_priority.items():
                aid = id_of(key)
                if aid is not None and aid < len(names):
                    names[aid] = tuple(g.requirement.name for g in groups)
            prev_n = self._prev_names
            if (prev_n is not None and len(prev_n) == len(names)
                    and self._prev_version == self.index.version
                    and not self.fairness.enabled()):
                dn = self._dirty_names
                entry = {aid for aid, nm in enumerate(names)
                         if nm != prev_n[aid]
                         or (nm and any(n in dn for n in nm))}
            self._prev_names = names
            self._prev_rows = None
        self._dirty_names.clear()
        self._prev_version = self.index.version
        log = self._delta_log
        log.append((self.sched_invocations, entry))
        if len(log) > 64:
            del log[0]

    def _absorb_feed(self, now: float) -> None:
        """Batch-record fed check-ins with time <= now into the estimator."""
        if self._feed_times is None or self._feed_pos >= len(self._feed_times):
            return
        hi = int(np.searchsorted(self._feed_times, now, side="right"))
        if hi <= self._feed_pos:
            return
        sl = slice(self._feed_pos, hi)
        # classification ids are supply ids (shared interner): feed directly
        self.supply.record_batch(self._feed_ids[sl], self._feed_times[sl],
                                 babs=self._feed_babs[sl])
        self._feed_pos = hi

    # ------------------------------------------------------------- Alg 1+2

    def _engine(self):
        """The incremental replan engine, or ``None`` when the scalar
        reference path is pinned (``replan="scalar"``) or IRS is ablated
        (the FIFO plan has no incremental form).  Lazily constructed so
        scalar-pinned runs never import the accel package."""
        if not self.enable_irs or self.replan_mode == "scalar":
            return None
        if self._replan is None:
            from ..accel.replan import ReplanEngine
            self._replan = ReplanEngine(device=self.device)
        return self._replan

    def _reschedule(self, now: float) -> None:
        self.sched_invocations += 1
        self._plan_dirty = False
        if self._before_replan is not None:
            self._before_replan(now)        # the responses due before now
        # observability: the replan is the scheduler's hotspot at scale — span the
        # whole VENN-SCHED run plus its sub-phases (supply absorb, IRS,
        # tier decisions, plan lowering) so traces show where replans go
        tr = _obstrace.TRACER
        reg = _obsmetrics.REGISTRY
        timed = tr.enabled or reg.enabled
        t_replan = time.perf_counter() if timed else 0.0
        tok = tr.begin("venn.replan", cat="sched", sim_t=now) \
            if tr.enabled else None
        sub = tr.begin("venn.replan.supply", cat="sched") \
            if tr.enabled else None
        self._absorb_feed(now)
        self.supply.advance(now)
        # one batched eviction+rate pass over the stacked supply rings
        # (bit-identical to per-atom rate() calls, without the per-replan
        # per-atom ring traffic)
        seen, rates = self.supply.snapshot_rates()
        key_of = self.index.interner.key_of
        id_of = self.index.interner.id_of
        atoms = {key_of(aid) for aid in np.flatnonzero(seen).tolist()}
        eng = self._engine()
        if eng is not None:
            eng.sync(self.groups.values())
            active_groups = [g for g in self.groups.values()
                             if eng.pending_count(g.requirement.name)]
        else:
            active_groups = [g for g in self.groups.values()
                             if g.pending_jobs()]
        # make sure every group's requirement defines atoms even pre-traffic
        for g in active_groups:
            elig = self.index.eligible_atoms(g.requirement, atoms)
            g.eligible_atoms = elig
            # canonical ascending-id atom order: makes the allocation dicts'
            # insertion order — hence every float accumulation over them —
            # deterministic and independent of frozenset hash order (the
            # contract _atom_order/the replan engine rely on)
            aids = sorted(id_of(a) for a in elig)
            g.atom_rates = {key_of(aid): float(rates[aid]) for aid in aids}
            g.supply = sum(g.atom_rates.values())
            g.allocation = {}
        if sub is not None:
            tr.end(sub, atoms=len(atoms), groups=len(active_groups))

        num_jobs = eng.total_pending() if eng is not None else \
            sum(len(g.pending_jobs()) for g in active_groups)
        solo = lambda j: self._solo_jct(j)
        sub = tr.begin("venn.replan.irs", cat="sched") if tr.enabled else None
        if self.enable_irs:
            # queue lengths are fixed within one VENN-SCHED run; cache them
            # (the greedy reallocation queries them per donor pair)
            qcache: Dict[int, float] = {}

            def queue_len(g: JobGroup) -> float:
                v = qcache.get(id(g))
                if v is None:
                    v = qcache[id(g)] = self.fairness.queue_len(g, num_jobs, solo)
                return v

            if eng is not None:
                # incremental array path: event-maintained demand keys when
                # fairness is off; fairness keys drift with supply, so they
                # are recomputed per replan through the same policy callable
                dk = (lambda j: self.fairness.demand_key(j, num_jobs, solo)) \
                    if self.fairness.enabled() else None
                self.plan = eng.schedule(active_groups, queue_len,
                                         demand_key=dk)
            else:
                self.plan = venn_schedule(
                    active_groups,
                    queue_len=queue_len,
                    demand_key=lambda j: self.fairness.demand_key(j, num_jobs, solo),
                )
        else:  # ablation "Venn w/o scheduling": FIFO order, matching only
            self.plan = self._fifo_plan(active_groups, atoms)
        if sub is not None:
            tr.end(sub, jobs=num_jobs, **(eng.last_stats if eng is not None
                                          and self.enable_irs else {}))

        # cover every known atom so idle/ineligible check-ins never replan
        for a in atoms:
            self.plan.atom_priority.setdefault(a, [])

        sub = tr.begin("venn.replan.tiers", cat="sched") if tr.enabled else None
        if self.enable_matching:
            self._decide_tiers(now)
        else:
            self.tier_decisions.clear()
        if sub is not None:
            tr.end(sub, decisions=len(self.tier_decisions))

        sub = tr.begin("venn.replan.compile", cat="sched") \
            if tr.enabled else None
        if eng is not None:
            self.dispatch = eng.compile(self.plan, self.index.intern,
                                        self.index.num_atoms,
                                        self.tier_decisions)
        else:
            self.dispatch = compile_plan(self.plan, self.index.intern,
                                         self.index.num_atoms,
                                         self.tier_decisions)
        self._live[:] = self.dispatch.live_list()
        self._note_match_delta(eng)
        if sub is not None:
            tr.end(sub, num_atoms=self.index.num_atoms,
                   **({k: eng.last_stats[k] for k in
                       ("lowered_reused", "merged_reused")
                       if k in eng.last_stats} if eng is not None else {}))
        aud = _obsaudit.AUDIT
        if aud.enabled:
            # flight recorder: snapshot the IRS decision (intersection
            # structure, orderings + demand keys, per-atom pressure) and
            # refresh the pristine dispatch copy grant rows audit against.
            # Replans are engine-invariant events, so this is the anchor
            # that keeps audit streams byte-identical across drain engines.
            aud.replan(now, self)
        if tok is not None:
            tr.end(tok, jobs=num_jobs, groups=len(active_groups))
        if timed:
            dt = time.perf_counter() - t_replan
            self.replan_seconds += dt
        if reg.enabled:
            reg.counter("venn.replans").inc()
            reg.histogram("venn.replan_wall_s", lo=1e-7, hi=1e2).record(dt)
            if eng is not None:
                # incremental-reuse telemetry: how much of this replan was
                # served from caches vs recomputed (order/lowered/merged)
                for k, v in eng.last_stats.items():
                    if v:
                        reg.counter("venn.replan." + k).inc(v)

    def _decide_tiers(self, now: float) -> None:
        kept: Dict[int, TierDecision] = {}
        for jobs in self.plan.job_order.values():
            if not jobs:
                continue
            job = jobs[0]                       # only currently-served jobs
            req = job.current
            if req is None:
                continue
            if self._tier_decided.get(job.job_id) == (req.round_index, req.aborted):
                prev = self.tier_decisions.get(id(req))
                if prev is not None:            # decision is per-request
                    kept[id(req)] = prev
                continue
            prof = self._profile(job.job_id)
            group = self.groups[job.requirement.name]
            rate = group.alloc_rate
            t_sched = req.remaining / rate if rate > 0 else float("inf")
            t_resp = self._response_estimate(job, prof)
            d = self.matcher.decide(job, prof, t_sched, t_resp)
            self._tier_decided[job.job_id] = (req.round_index, req.aborted)
            if d.tiered:
                kept[id(req)] = d
        self.tier_decisions = kept

    # ------------------------------------------------------------ estimates

    def _profile(self, job_id: int) -> JobProfile:
        prof = self.profiles.get(job_id)
        if prof is None:
            prof = self.profiles[job_id] = JobProfile()
        return prof

    def _response_estimate(self, job: Job, prof: JobProfile) -> float:
        if prof.n >= 8:
            rts = prof.sorted_rts()
            return rts[min(len(rts) - 1, int(0.95 * len(rts)))]
        # log-normal prior: p95 = exp(mu + 1.645 sigma)
        return job.task_time_mean * math.exp(1.645 * job.task_time_sigma)

    def _solo_jct(self, job: Job) -> float:
        g = self.groups.get(job.requirement.name)
        rate = g.supply if g and g.supply > 0 else self.supply.prior_rate
        prof = self._profile(job.job_id)
        per_round = job.demand_per_round / rate + self._response_estimate(job, prof)
        return max(job.remaining_rounds, 1) * per_round

    # -------------------------------------------------------------- ablation

    def _fifo_plan(self, groups: List[JobGroup], atoms) -> SchedulePlan:
        plan = SchedulePlan(groups=list(groups))
        for g in groups:
            order = sorted(g.pending_jobs(),
                           key=lambda j: (j.current.submit_time, j.job_id))  # type: ignore[union-attr]
            plan.job_order[g.requirement.name] = order
            plan.job_keys[g.requirement.name] = [
                j.current.submit_time for j in order]  # type: ignore[union-attr]
        for a in atoms:
            elig = [g for g in groups if a in g.eligible_atoms]
            elig.sort(key=lambda g: min((j.current.submit_time for j in g.pending_jobs()
                                         if j.current), default=float("inf")))
            plan.atom_priority[a] = elig
            for g in elig[:1]:
                g.allocation[a] = g.atom_rate(a)
        return plan
