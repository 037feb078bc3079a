"""Compiled dispatch plans: the per-check-in O(1) fast path.

Venn's design (§4.2) recomputes the schedule only on request arrival and
completion; every device check-in should then be a constant-time lookup.  This
module lowers a :class:`~repro_torch.core.irs.SchedulePlan` (frozenset-keyed atom
priorities + per-group job orders + tier decisions) into a flat **dispatch
table**: for each interned atom id, an ordered list of candidate *slots*
``[request, speed_lo, speed_hi]``.  A check-in is then one list index plus a
couple of float compares — no frozenset hashing, no nested group/job scans.

Slots whose request has filled since compilation are invalidated incrementally
(dropped the next time the scan touches them); the table is only rebuilt when
the plan itself changes, i.e. on the same events that trigger VENN-SCHED.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

from .irs import SchedulePlan
from .types import JobRequest


class _Miss:
    """Sentinel: the atom id is not covered by the compiled table (a replan is
    needed, mirroring the lazy unseen-atom replan of the scan path)."""

    __slots__ = ()

    def __repr__(self) -> str:  # pragma: no cover
        return "<dispatch MISS>"


MISS = _Miss()

_NO_BAND = (-math.inf, math.inf)


class DispatchTable:
    """Atom-id-indexed candidate request slots, in assignment priority order."""

    __slots__ = ("_slots",)

    def __init__(self, num_atoms: int = 0):
        # None = atom id unknown to this plan (MISS); [] = known but idle.
        self._slots: List[Optional[List[list]]] = [None] * num_atoms

    def live_list(self) -> List[bool]:
        """Per-atom-id liveness: ``False`` iff this plan knows the atom and has
        no candidate slot for it (a dead atom — check-ins can be skipped
        without consulting the scheduler).  Uncovered atoms (``None``) are
        *live*: they must reach the scheduler to trigger the lazy replan."""
        return [s is None or len(s) > 0 for s in self._slots]

    def assign(self, atom_id: int, speed: float):
        """Return the first live candidate request accepting ``speed``,
        ``None`` if no candidate wants the device, or :data:`MISS` if the atom
        id is not covered (caller should replan and retry once)."""
        slots = self._slots[atom_id] if atom_id < len(self._slots) else None
        if slots is None:
            return MISS
        i = 0
        while i < len(slots):
            slot = slots[i]
            req = slot[0]
            if req.demand - req.granted <= 0:
                # request filled since compilation: invalidate just this slot
                slots.pop(i)
                continue
            if slot[1] <= speed < slot[2]:
                return req
            i += 1
        return None

    def covers(self, atom_id: int) -> bool:
        return atom_id < len(self._slots) and self._slots[atom_id] is not None

    def num_slots(self) -> int:
        return sum(len(s) for s in self._slots if s)

    def snapshot(self) -> List[Optional[List[tuple]]]:
        """Pristine per-atom ``(req, lo, hi)`` tuples, safe to hold across
        the live table's in-place slot invalidation.  This is what the array
        engine's full (uncapped) mirror export and the audit recorder's
        grant classification both scan — the compile-time slot indices, not
        the engine-dependent mutated ones."""
        return [s if s is None else
                [(slot[0], slot[1], slot[2]) for slot in s]
                for s in self._slots]

    def snapshot_rows(self, atom_ids, limit: Optional[int] = None,
                      copy: bool = True) -> List[Optional[List]]:
        """:meth:`snapshot` restricted to ``atom_ids`` (same pristine
        ``(req, lo, hi)`` tuples, same ``limit`` prefix-capping as
        ``export_match_slots``).  This is the delta-export surface: the array
        engine's mirror patch re-derives only its dirty atoms instead of
        re-scanning the whole table.

        ``copy=False`` skips the pristine-tuple copies and returns the live
        ``[req, lo, hi]`` slot lists themselves — only for callers that
        consume the rows synchronously (the mirror patch) and never retain
        them across the table's in-place slot invalidation."""
        slots = self._slots
        out: List[Optional[List]] = []
        for aid in atom_ids:
            s = slots[aid] if aid < len(slots) else None
            if s is None:
                out.append(None)
            elif not copy:
                out.append(s if limit is None else s[:limit])
            else:
                out.append([(slot[0], slot[1], slot[2])
                            for slot in (s if limit is None else s[:limit])])
        return out


def compile_plan(plan: SchedulePlan, intern, num_atoms: int,
                 tier_decisions: Dict[int, object]) -> DispatchTable:
    """Lower ``plan`` into a :class:`DispatchTable`.

    ``intern`` maps an atom frozenset key to its dense id (the eligibility
    index's ``intern``); ``tier_decisions`` maps ``id(request)`` to the
    :class:`~repro_torch.core.matching.TierDecision` for currently served requests
    (only the head job of each group is tier-restricted; leftover tiers flow
    to subsequent jobs, exactly as in the scan path).
    """
    table = DispatchTable(num_atoms)
    slots_by_atom = table._slots
    # Pre-lower each group's job order once; atoms sharing a group reuse it.
    slots_by_group: Dict[str, List[list]] = {}
    for gname, jobs in plan.job_order.items():
        lowered: List[list] = []
        for pos, job in enumerate(jobs):
            req: Optional[JobRequest] = job.current
            if req is None or req.demand - req.granted <= 0:
                continue
            lo, hi = _NO_BAND
            if pos == 0:
                d = tier_decisions.get(id(req))
                if d is not None and getattr(d, "tiered", False):
                    lo, hi = d.speed_lo, d.speed_hi
            lowered.append([req, lo, hi])
        slots_by_group[gname] = lowered
    # Atoms sharing the same priority-group sequence share one merged list
    # (memoized by the group-name tuple).  Sharing is exact: the only
    # in-place mutation a merged list ever sees is filled-slot invalidation,
    # and a filled slot can never match on any atom, so one atom's filter
    # pass only removes entries every sharer's scan would have skipped.
    merged_memo: Dict[tuple, List[list]] = {}
    for key, groups in plan.atom_priority.items():
        aid = intern(key)
        if aid >= len(slots_by_atom):
            slots_by_atom.extend([None] * (aid + 1 - len(slots_by_atom)))
        names = tuple(g.requirement.name for g in groups)
        merged = merged_memo.get(names)
        if merged is None:
            merged = merged_memo[names] = []
            for group in groups:
                merged.extend(slots_by_group.get(group.requirement.name, ()))
        slots_by_atom[aid] = merged
    # Atoms the plan does not mention stay None -> MISS.  Batch
    # classification interns atoms *before* the supply estimator has seen
    # them, so "interned" must not imply "covered": an atom outside the
    # plan's view has to trigger the lazy replan exactly like the scan path
    # (otherwise a plan compiled before any eligible supply was observed
    # would silently swallow every later check-in as idle).
    return table
