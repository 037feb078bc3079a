"""Baseline schedulers (§2.2, §5.1).

All production FL resource managers boil down to random device-to-job matching
in different forms (Apple: client-driven sampling; Meta: centralized random
match; Google: job-driven sampling).  We implement:

* :class:`RandomScheduler` — the paper's *optimized* random baseline: job
  requests are served in a randomized order (re-drawn on every scheduling
  event) rather than devices picking uniformly, which reduces round abortions
  under contention and makes the baseline stronger.
* :class:`FifoScheduler` — requests served in submission order.
* :class:`SrsfScheduler` — Shortest Remaining Service First (Gu et al., 2019,
  Tiresias-style), applied to the remaining demand of the outstanding request
  (like Venn, it is agnostic to total job rounds, §5.1).

Every scheduler implements the same interface the simulator drives:

    on_request(request, now)   — a job submitted a round request
    on_complete(request, now)  — a request finished/aborted
    assign(device, now)        — a device checked in; return a JobRequest or None
    on_response(...)           — response feedback (Venn profiles tiers)

plus the vectorized check-in fast path shared by every scheduler:

    classify_caps(caps)        — struct-of-arrays chunk -> interned atom ids
    begin_chunk(times, ids)    — hand the chunk to the scheduler (supply feed)
    checkin(atom_id, ...)      — O(1) assignment by interned atom id

The base implementation of ``checkin`` resolves eligibility through a per-atom
cache of the pending-request list (rebuilt only when the request ordering
changes), so even the baselines avoid per-check-in ``Requirement.matches``
scans.
"""
from __future__ import annotations

import math
import random
from typing import Dict, List, Optional

import numpy as np

from .eligibility import EligibilityIndex
from .types import Device, JobRequest


class BaseScheduler:
    """Common bookkeeping: the outstanding requests + the eligibility index."""

    name = "base"

    def __init__(self, seed: int = 0):
        self.rng = random.Random(seed)
        self.pending: List[JobRequest] = []
        self.index = EligibilityIndex([])
        # atom id -> pending requests eligible for that atom, in service order
        self._atom_cache: Dict[int, List[JobRequest]] = {}
        # bumps whenever the pending order (hence per-atom candidate lists)
        # changes — the array engine's cue to rebuild its state mirror
        self.order_version = 0

    # ---- simulator hooks --------------------------------------------------

    def on_request(self, request: JobRequest, now: float) -> None:
        self.index.add_requirement(request.requirement)
        self.pending.append(request)
        self._resort(now)
        self._atom_cache.clear()
        self.order_version += 1

    def on_complete(self, request: JobRequest, now: float) -> None:
        if request in self.pending:
            self.pending.remove(request)
        self._resort(now)
        self._atom_cache.clear()
        self.order_version += 1

    def assign(self, device: Device, now: float) -> Optional[JobRequest]:
        return self.checkin(self.index.atom_id_of(device), 0.0, 0.0,
                            device.speed, now)

    def on_response(self, request: JobRequest, device: Device,
                    response_time: float, ok: bool, now: float) -> None:
        """Response feedback — baselines ignore it (Venn profiles tiers)."""

    def on_grant(self, request: JobRequest) -> None:
        """One check-in was granted to ``request`` (``granted`` already
        incremented).  Called by the simulator's single grant site for both
        drain engines; the incremental replan engine uses it to keep its
        demand-key mirror current.  Baselines track nothing per grant."""

    # ---- vectorized check-in fast path ------------------------------------

    @property
    def atom_version(self) -> int:
        """Bumps when the atom partition refines (new requirement seen)."""
        return self.index.version

    def classify_caps(self, caps: Dict[str, np.ndarray]) -> np.ndarray:
        return self.index.classify(caps)

    def begin_chunk(self, times: np.ndarray, atom_ids: np.ndarray) -> None:
        """A new check-in chunk starts — baselines keep no supply state."""

    def live_atoms(self) -> Optional[List[bool]]:
        """Optional per-atom-id liveness list for the simulator's dead-atom
        skip: ``live[aid] is False`` guarantees ``checkin(aid, ...)`` would
        return None, so the drain loop may skip the call outright.  ``None``
        means no liveness information (treat every atom as live).  The list
        must stay current in place across replans triggered inside
        ``checkin`` (the simulator caches the object per drain segment)."""
        return None

    def checkin(self, atom_id: int, cpu: float, mem: float, speed: float,
                now: float) -> Optional[JobRequest]:
        lst = self._atom_cache.get(atom_id)
        if lst is None:
            lst = self._atom_cache[atom_id] = self._eligible_pending(atom_id)
        for req in lst:
            if req.demand - req.granted > 0:
                return req
        return None

    def _eligible_pending(self, atom_id: int) -> List[JobRequest]:
        key = self.index.key_of(atom_id)
        return [r for r in self.pending if r.requirement.name in key]

    # ---- array-engine hooks -----------------------------------------------

    def prepare_match(self, now: float) -> None:
        """Baselines keep no lazily-compiled plan — nothing to refresh."""

    def match_token(self) -> tuple:
        """Identity of the current decision state (candidate lists change
        only when the atom partition refines or the pending order changes)."""
        return (self.index.version, self.order_version)

    def match_delta(self, base_token: tuple):
        """Dirty atom ids whose candidate rows may differ between
        ``base_token`` and the current :meth:`match_token`, or ``None`` when
        only a full rebuild is sound.  Baselines rebuild their per-atom
        candidate lists wholesale on every resort, so they report no deltas;
        the array engine then falls back to its full mirror rebuild (the
        pre-delta behavior, unchanged)."""
        return None

    def export_match_rows(self, atom_ids, limit: Optional[int] = None,
                          copy: bool = True):
        """Per-atom candidate rows for the selected ``atom_ids`` only (the
        mirror-patch export).  The base implementation re-slices
        :meth:`export_match_slots` (``copy`` is then moot — the slots are
        already fresh); schedulers with a compiled dispatch table override
        with a direct row snapshot."""
        slots = self.export_match_slots(limit)
        return [slots[aid] if aid < len(slots) else None for aid in atom_ids]

    def export_match_slots(self, limit: Optional[int] = None):
        """Per-atom candidate slots for the array engine, mirroring
        ``checkin``: every pending request eligible for the atom, in service
        order, with no speed band (``limit`` caps each exported prefix —
        with an early exit, so a capped rebuild is O(atoms x limit), not
        O(atoms x pending)).  Baselines cover every interned atom."""
        inf = math.inf
        key_of = self.index.key_of
        pending = self.pending
        out = []
        for aid in range(self.index.num_atoms):
            key = key_of(aid)
            row = []
            for r in pending:
                if r.requirement.name in key:
                    row.append((r, -inf, inf))
                    if limit is not None and len(row) >= limit:
                        break
            out.append(row)
        return out

    # ---- per-scheduler ordering -------------------------------------------

    def _resort(self, now: float) -> None:
        raise NotImplementedError


class RandomScheduler(BaseScheduler):
    name = "random"

    def _resort(self, now: float) -> None:
        self.rng.shuffle(self.pending)


class FifoScheduler(BaseScheduler):
    name = "fifo"

    def _resort(self, now: float) -> None:
        # job-arrival order: an early job keeps priority across all its rounds
        self.pending.sort(key=lambda r: (r.job.arrival_time, r.job.job_id))


class SrsfScheduler(BaseScheduler):
    name = "srsf"

    def _resort(self, now: float) -> None:
        self.pending.sort(key=lambda r: (r.remaining, r.job.job_id))
