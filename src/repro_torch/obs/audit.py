"""Scheduler flight recorder: decision-level audit of VENN-SCHED runs.

Where :mod:`repro_torch.obs.trace`/:mod:`repro_torch.obs.metrics` answer *how long* the
scheduler took, the audit recorder answers *what it decided and why* — the
analysis surface behind the paper's Fig. 10-14.  Three record streams, all
JSONL:

* ``kind="replan"`` — one snapshot per VENN-SCHED invocation: the IRS
  intersection structure (job→atom-set bipartite edges via each group's
  ``jobs``/``atoms`` lists, intra-group ordering with the fairness-adjusted
  demand keys that produced it, per-atom supply rate vs. queued demand
  "pressure", the greedy reallocation's final ``alloc`` ownership, and the
  dispatch-table dead/uncovered-atom counts).
* ``kind="grant"`` — a sampled audit of granted check-ins at dispatch-table
  granularity: winning slot index, tier band, and counters for why earlier
  candidates were skipped (``skipped_filled``/``skipped_band``).  Only a
  round's *opening* grant is audit-eligible (so audit volume scales with
  rounds, not check-ins; a deadline-aborted round's retry is a fresh
  attempt and opens again) and sampling over those is deterministic (every
  ``grant_sample``-th eligible grant), so both drain engines sample the
  *same* grants.
* ``kind="queue_pos"`` — per-job queue-position history (delta-encoded: a row
  is emitted only when a job's position or the set of jobs ahead of it
  changes), so scheduling delay can be attributed to the specific contending
  jobs ahead.

Zero-overhead discipline (same as TRACER/REGISTRY): ``AUDIT`` is the
:data:`NULL_AUDIT` singleton until :func:`repro_torch.obs.enable` installs an
:class:`AuditRecorder`; instrumentation sites pay one attribute fetch plus a
bool test.  Nothing here may run per-check-in: replan snapshots hang off
``venn.replan`` (request arrival/completion granularity), grant rows hang off
``Simulator._grant`` (granted check-ins only — orders of magnitude rarer than
check-ins), and the miss side (dead/uncovered atoms) is folded into the
replan snapshot instead of the drain loop.

Cross-engine identity: every record is anchored on engine-invariant events
(replans happen at identical simulated times on both drain engines; grant
sequences are bit-identical and flow through the shared ``_grant``), and the
grant-row slot scan runs against a *pristine* snapshot of the freshly
compiled dispatch table — never the live table, whose lazy slot invalidation
mutates differently per engine.  Records carry no wall-clock timestamps and
no ``id()`` values, so the exported JSONL is byte-identical across
``engine="python"`` and ``engine="array"``.  The one waiver is the one the
engines themselves document: ``replan_budget_s`` stale-plan serving (rows
granted under a stale plan are flagged ``"stale": true``).
"""
from __future__ import annotations

import json
import math
from typing import Dict, List, Optional, Tuple

__all__ = ["AUDIT", "AuditRecorder", "NULL_AUDIT", "NullAudit",
           "DEFAULT_GRANT_SAMPLE", "read_audit"]

# only a round's *opening* grant is audit-eligible (audit work scales with
# rounds, not grants), and ``grant_sample`` strides over those: every Nth
# eligible grant is recorded.  Deterministic, so both engines pick the same
# grants.  The default audits every round's opening grant.
DEFAULT_GRANT_SAMPLE = 1


def _dumps(obj) -> str:
    # compact separators: the stream is machine-read JSONL, and the encoder
    # cost is on the recorder's 5% budget
    return json.dumps(obj, separators=(",", ":"))


class NullAudit:
    """Disabled recorder: every hook a no-op (the module default)."""

    __slots__ = ()
    enabled = False
    records: tuple = ()
    dropped = 0

    def begin_run(self, **meta) -> None:
        pass

    def replan(self, now, sched) -> None:
        pass

    def stale_plan(self, now) -> None:
        pass

    def grant(self, g, req, atom_id, t, speed) -> None:
        pass

    def write_jsonl(self, path: str, mode: str = "w") -> str:
        return path


NULL_AUDIT = NullAudit()

# the process-global recorder; instrumentation sites read this attribute
AUDIT = NULL_AUDIT


class AuditRecorder:
    """Live flight recorder (installed by ``repro_torch.obs.enable(audit=True)``).

    ``grant_sample`` audits every Nth grant; ``replan_sample`` emits every
    Nth replan snapshot (the pristine dispatch snapshot used to classify
    grant rows is refreshed on *every* replan regardless, so grant rows stay
    exact under snapshot sampling).  ``queue_positions=False`` drops the
    per-job history stream.  ``max_records`` bounds memory; excess records
    are counted in ``dropped``.
    """

    enabled = True

    def __init__(self, grant_sample: int = DEFAULT_GRANT_SAMPLE,
                 replan_sample: int = 1, queue_positions: bool = True,
                 max_records: int = 2_000_000):
        if grant_sample < 1 or replan_sample < 1:
            raise ValueError("sampling intervals must be >= 1")
        self.grant_sample = grant_sample
        self.replan_sample = replan_sample
        self.queue_positions = queue_positions
        self.max_records = max_records
        # the record buffer holds a GC-neutral mix: high-volume grant rows
        # stay *flat all-scalar dicts* (CPython's collector untracks those
        # automatically, so a 20k-row buffer never inflates full-collection
        # passes over the simulator's hot loop), while replan snapshots are
        # *deferred*: ``replan()`` stashes a small tuple of frozen object
        # refs (the plan and the per-group dicts it rebinds each cycle) and
        # the expensive part — interning, per-atom tables, sorting,
        # ``json.dumps`` of ~100 containers — runs once at export via
        # :meth:`_expand`.  Building snapshots inline measured ~130µs per
        # replan in situ (>5% of the profiled workload on its own); the
        # stash costs ~1 tuple + one pass over the group's job list.
        # Expanded snapshots become JSON strings (strings are not GC
        # containers, so the buffer stays cheap to traverse).
        self._buf: List = []
        self._has_deferred = False
        self._by_kind: Dict[str, int] = {}
        self.dropped = 0
        # public: the grant hook's sampling counter lives at the call site
        # (Simulator._grant) so rounds that sample out never pay a method
        # call; continuous across runs, so run boundaries never re-phase
        # the deterministic 1-in-N pick.  Counts audit-eligible grants,
        # i.e. round-opening ones.
        self.rounds_seen = 0
        # per-run state (reset by begin_run)
        self._replan_seq = -1
        self._slots: Optional[List[Optional[List[Tuple]]]] = None
        self._stale = False
        self._qpos: Dict[int, tuple] = {}
        self._qlast: Dict[str, list] = {}

    # ------------------------------------------------------------ recording

    @property
    def records(self) -> List[dict]:
        """The record stream as dicts (post-run analysis; see ``_buf`` for
        the GC-neutral storage mix)."""
        self._expand()
        return [json.loads(r) if type(r) is str else r for r in self._buf]

    def _add(self, rec: dict) -> None:
        """Append one eagerly-built record (a flat all-scalar dict; replan
        snapshots go through the deferred-stash path in :meth:`replan`)."""
        if len(self._buf) >= self.max_records:
            self.dropped += 1
            return
        kind = rec["kind"]
        self._by_kind[kind] = self._by_kind.get(kind, 0) + 1
        self._buf.append(rec)

    def begin_run(self, **meta) -> None:
        """Mark a run boundary (scenario/scheduler/seed — never the engine:
        the stream must stay engine-invariant) and reset per-run state."""
        # drain deferred stashes first: their queue-position deltas must
        # replay against the *previous* run's state before it resets
        self._expand()
        self._replan_seq = -1
        self._slots = None
        self._stale = False
        self._qpos = {}
        self._qlast = {}
        self._add({"kind": "run", **meta})

    def replan(self, now, sched) -> None:
        """Snapshot one VENN-SCHED invocation.  Called by the scheduler at
        the end of ``_reschedule`` — request arrival/completion granularity,
        never per check-in.  ``sched`` is duck-typed (``plan``, ``dispatch``,
        ``index`` attributes); obs stays import-free of repro_torch.core.

        Only time-sensitive state is captured here: each job's current
        fill (for queued demand) and refs to the plan's per-cycle objects.
        ``_reschedule`` *rebinds* ``eligible_atoms``/``atom_rates``/
        ``allocation``/``job_order``/``job_keys``/``atom_priority`` to fresh
        objects every cycle (never mutates the old ones) and the plan object
        itself is fresh, so the refs stay frozen until :meth:`_expand`
        builds the actual records at export time, off the simulator's
        critical path."""
        self._replan_seq += 1
        self._stale = False
        seq = self._replan_seq
        # the pristine compiled table: grant rows are classified against this
        # copy, not the live table (whose lazy invalidation diverges between
        # drain engines) — refreshed on every replan even when the snapshot
        # record itself is sampled out
        snap = sched.dispatch.snapshot()
        self._slots = snap
        plan = sched.plan
        if not seq % self.replan_sample:
            # queued demand depends on each job's fill *now*; everything
            # else in the group tuple is a frozen ref (see docstring)
            gstate = []
            for g in plan.groups:
                queued = 0
                for j in plan.job_order.get(g.requirement.name, ()):
                    r = j.current
                    if r is not None and r.demand > r.granted:
                        queued += r.demand - r.granted
                gstate.append((g.requirement.name, float(g.supply), queued,
                               g.eligible_atoms, g.atom_rates, g.allocation))
        else:
            gstate = None
        if len(self._buf) >= self.max_records:
            self.dropped += 1
            return
        self._buf.append((seq, float(now), plan, snap if gstate is not None
                          else None, gstate, sched.index.intern))
        self._has_deferred = True

    # ---------------------------------------------------- deferred expansion

    def _expand(self) -> None:
        """Materialize deferred replan stashes into ``queue_pos`` + ``replan``
        records, in buffer order (the queue-position delta state must replay
        in the same order it was captured).  Idempotent; safe to export
        mid-run — later replans stash fresh tuples and a second expansion
        passes already-expanded entries through untouched."""
        if not self._has_deferred:
            return
        self._has_deferred = False
        out: List = []
        by_kind = self._by_kind
        for e in self._buf:
            if type(e) is not tuple:
                out.append(e)
                continue
            seq, t, plan, snap, gstate, intern = e
            if self.queue_positions:
                n0 = len(out)
                self._expand_queue_positions(out, seq, t, plan)
                if len(out) > n0:
                    by_kind["queue_pos"] = (by_kind.get("queue_pos", 0)
                                            + len(out) - n0)
            if gstate is not None:
                out.append(self._build_replan(seq, t, plan, snap, gstate,
                                              intern))
                by_kind["replan"] = by_kind.get("replan", 0) + 1
        self._buf = out

    def _expand_queue_positions(self, out: List, seq: int, t: float,
                                plan) -> None:
        qpos = self._qpos
        qlast = self._qlast
        for gname, jobs in plan.job_order.items():
            ids = [j.job_id for j in jobs]
            # group-level fast path: an unchanged ordered id list means every
            # job's (pos, ahead) in this group is unchanged — skip without
            # building the per-job ahead tuples (queue order is stable across
            # the vast majority of replans, so this is the common case)
            if qlast.get(gname) == ids:
                continue
            qlast[gname] = ids
            keys = plan.job_keys.get(gname)
            for pos, jid in enumerate(ids):
                ahead = ids[:pos]
                cur = (gname, pos, tuple(ahead))
                if qpos.get(jid) != cur:
                    qpos[jid] = cur
                    out.append({
                        "kind": "queue_pos", "replan": seq, "t": t,
                        "job": jid, "group": gname, "pos": pos,
                        "key": (float(keys[pos])
                                if keys is not None and pos < len(keys)
                                else None),
                        "ahead": ahead,
                    })

    def _build_replan(self, seq: int, t: float, plan, snap, gstate,
                      intern) -> str:
        groups_rec: List[dict] = []
        rate_by_atom: Dict[int, float] = {}
        demand_by_atom: Dict[int, int] = {}
        num_jobs = 0
        for gname, supply, queued, elig, rates, allocation in gstate:
            jobs = plan.job_order.get(gname, [])
            keys = plan.job_keys.get(gname, [])
            num_jobs += len(jobs)
            aids = []
            for a in elig:
                aid = intern(a)
                aids.append(aid)
                rate_by_atom[aid] = float(rates.get(a, 0.0))
                demand_by_atom[aid] = demand_by_atom.get(aid, 0) + queued
            aids.sort()
            alloc = sorted((intern(a), float(r))
                           for a, r in allocation.items())
            groups_rec.append({
                "group": gname,
                "supply": supply,
                "queued_demand": queued,
                "jobs": [j.job_id for j in jobs],
                "keys": [float(k) for k in keys],
                "atoms": aids,
                "alloc": {str(i): r for i, r in alloc},
            })
        atoms_rec: List[dict] = []
        for akey, order in plan.atom_priority.items():
            aid = intern(akey)
            rate = rate_by_atom.get(aid, 0.0)
            dem = demand_by_atom.get(aid, 0)
            # pressure = queued demand / supply rate (seconds of queued work
            # at the atom's arrival rate); None encodes infinity (demand with
            # zero observed supply)
            if rate > 0.0:
                pressure: Optional[float] = dem / rate
            else:
                pressure = None if dem else 0.0
            atoms_rec.append({
                "id": aid,
                "reqs": sorted(akey),
                "rate": rate,
                "demand": dem,
                "pressure": pressure,
                "order": [g.requirement.name for g in order],
            })
        atoms_rec.sort(key=lambda r: r["id"])
        # serialized, not kept as a dict: the nested groups/atoms tables are
        # ~100 containers each, and retaining them live makes every full GC
        # pass traverse the whole buffer (see __init__)
        return _dumps({
            "kind": "replan", "seq": seq, "t": t, "jobs": num_jobs,
            "groups": groups_rec, "atoms": atoms_rec,
            "dead_atoms": [i for i, s in enumerate(snap)
                           if s is not None and not s],
            "uncovered_atoms": sum(1 for s in snap if s is None),
            "slots": sum(len(s) for s in snap if s),
        })

    def stale_plan(self, now) -> None:
        """The array engine served a stale plan under ``replan_budget_s``:
        subsequent grant rows are flagged — this is the documented waiver of
        cross-engine byte-identity (the record itself only appears in the
        engine that went stale)."""
        self._stale = True
        self._add({"kind": "stale_plan", "t": float(now),
                   "replan": self._replan_seq})

    def grant(self, g, req, atom_id, t, speed) -> None:
        """Audit one *sampled* round-opening grant (from
        ``Simulator._grant``, *before* ``req.granted`` is incremented, which
        is also how the caller knows this is the round's first grant).  The
        caller owns the sampling counter (``g`` is this grant's eligible-
        sequence number, == rounds seen so far) and only calls in for every
        ``grant_sample``-th eligible grant.  Classifies the grant against
        the pristine dispatch snapshot: winning slot index, tier band, and
        why each earlier candidate was skipped."""
        speed = float(speed)
        aid = int(atom_id)
        rec = {"kind": "grant", "seq": g, "t": float(t),
               "job": req.job.job_id, "round": req.round_index,
               "atom": aid, "speed": speed, "replan": self._replan_seq}
        slots = self._slots
        row = slots[aid] if slots is not None and aid < len(slots) else None
        if row is not None:
            skipped_filled = 0
            skipped_band = 0
            slot_ix = -1
            winner = None
            for k, slot in enumerate(row):
                r = slot[0]
                if r.demand - r.granted <= 0:
                    skipped_filled += 1
                    continue
                if slot[1] <= speed < slot[2]:
                    slot_ix = k
                    winner = r
                    break
                skipped_band += 1
            rec["slot"] = slot_ix          # -1: winner absent from the
            #                                compiled snapshot (stale plan)
            rec["candidates"] = len(row)
            rec["skipped_filled"] = skipped_filled
            rec["skipped_band"] = skipped_band
            if slot_ix >= 0:
                # scalar fields, not a [lo, hi] list: grant rows must stay
                # flat all-scalar dicts so the GC untracks them (see _buf)
                lo, hi = row[slot_ix][1], row[slot_ix][2]
                if math.isfinite(lo):
                    rec["band_lo"] = lo
                if math.isfinite(hi):
                    rec["band_hi"] = hi
            if winner is not req:
                # the snapshot disagrees with the engine's actual pick —
                # only reachable through the stale-plan waiver (or a
                # scheduler without replan hooks); flagged, never asserted
                rec["mismatch"] = True
        if self._stale:
            rec["stale"] = True
        self._add(rec)

    # -------------------------------------------------------------- export

    def summary(self) -> dict:
        self._expand()
        return {"kind": "audit_summary", "records": len(self._buf),
                "dropped": self.dropped, "rounds_seen": self.rounds_seen,
                "grant_sample": self.grant_sample,
                "replan_sample": self.replan_sample,
                "by_kind": dict(self._by_kind)}

    def write_jsonl(self, path: str, mode: str = "w") -> str:
        """One JSON object per record, trailing ``audit_summary`` row."""
        self._expand()
        with open(path, mode) as fh:
            for r in self._buf:
                fh.write(r if type(r) is str else _dumps(r))
                fh.write("\n")
            fh.write(_dumps(self.summary()) + "\n")
        return path


def read_audit(path: str) -> List[dict]:
    """Read an audit JSONL back into a list of records."""
    out = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out
