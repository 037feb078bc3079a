"""Struct-of-arrays mirrors of the scheduler's per-check-in decision state.

The Python fast path resolves a check-in through object graphs: a
:class:`~repro_torch.core.dispatch.DispatchTable` maps an interned atom id to an
ordered list of ``[request, speed_lo, speed_hi]`` slots, and a slot is live
while its request has remaining demand.  :class:`MatchState` lowers exactly
that structure into dense arrays so an entire drain segment of check-ins can
be matched in one vectorized call (:mod:`repro_torch.accel.engine`):

* ``cand_req``  — ``(A, K)`` int64: candidate request indices per atom id, in
  assignment priority order, ``-1``-padded on the right;
* ``cand_lo`` / ``cand_hi`` — ``(A, K)`` float64 tier speed bands per slot
  (``[-inf, inf)`` when the slot is untiered);

``K`` is an adaptive cap, not the longest candidate list: a check-in scans
its atom's list only until the first live slot whose band accepts it, and
at most ``#groups`` head slots are tier-banded, so scans terminate within a
few entries unless many requests fill inside one segment.  Lists longer than
the cap mark their atom *truncated*; when a truncated row exhausts its
prefix the engine doubles the cap and re-matches (exact, and rare).  This
keeps the dense matrices ``O(n x cap)`` instead of ``O(n x open-requests)``.

Remaining arrays:
* ``remaining`` — ``(R,)`` int64 per-request remaining-demand counters,
  decremented in place as the simulator applies grants (the array analogue of
  the dispatch table's incremental slot invalidation);
* ``covered``  — ``(A,)`` bool: atoms the compiled plan does not cover are
  *uncovered* and must take the scalar ``checkin`` path (the MISS protocol
  that triggers Venn's lazy replan).

**Device mirror.**  When the state is built with a ``device``, ``cand_req``
(int32), ``cand_lo`` / ``cand_hi`` (float64 — ``±inf`` bands survive as
they are), ``has_cand`` and ``truncated`` are kept a second time as tensors
on that device (``d_cand_req`` ...), beside the authoritative NumPy arrays:
``_lower`` (build and ``expand``) uploads them whole, ``patch`` uploads the
dirty rows with one ``index_copy_`` per array.  ``remaining`` stays a host
array — it moves once per applied grant, from the Python grant loop — and
the matcher uploads it at each call.  Everything the drain reads per
check-in (``first_miss``, ``has_cand_list``, ``request_index``) is host code.

The state is **rebuilt incrementally**: a rebuild happens only when the
scheduler's ``match_token()`` changes (a VENN-SCHED recompile, a pending-order
resort, or an atom-partition refinement); between tokens only ``remaining``
moves, mirrored per applied grant.

:class:`SupplyRings` is the same treatment for the
:class:`~repro_torch.core.supply.SupplyEstimator`: the per-atom ring buffers stacked
into one ``(A, nb)`` matrix with a vectorized eviction mask, so all-atom rate
queries (a replan input) are one array pass.  The estimator itself exposes the
write-back variant (``SupplyEstimator.snapshot_rates``) that the Venn replan
uses; the view here is read-only and exists for kernel-side consumers and for
cross-checking the scalar path.
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core.supply import SupplyEstimator, window_evicted_totals
from ..core.types import JobRequest


class MatchState:
    """Dense mirror of one scheduler's candidate-slot state.

    Built from ``scheduler.export_match_slots()`` — a list over dense atom ids
    of either ``None`` (uncovered atom: scalar MISS path) or an ordered list
    of ``(request, speed_lo, speed_hi)`` candidate slots.
    """

    __slots__ = ("requests", "remaining", "cand_req", "cand_lo", "cand_hi",
                 "covered", "has_cand", "has_cand_list",
                 "all_covered", "miss_free", "truncated", "token", "kcap",
                 "export_limit", "_rows", "_req_ix", "_rem_buf",
                 "device", "d_cand_req", "d_cand_lo", "d_cand_hi",
                 "d_has_cand", "d_truncated")

    def __init__(self, requests: List[JobRequest],
                 rows: List[Optional[List[Tuple[int, float, float]]]],
                 covered: np.ndarray, req_ix: dict, token: tuple, kcap: int,
                 export_limit: Optional[int] = None,
                 device: Optional[torch.device] = None):
        # device: where the mirror tensors live; None keeps the state
        # host-only (the NumPy backend and verify_against's truth copy)
        self.device = torch.device(device) if device is not None else None
        self.requests = requests
        self.covered = covered
        self.all_covered = bool(covered.all()) if len(covered) else False
        # set by the engine at build: True when no interned atom can MISS
        # (all covered AND the state spans the full id space), letting the
        # drain skip the per-segment MISS scan outright
        self.miss_free = False
        self.token = token
        self.export_limit = export_limit
        self._rows = rows
        self._req_ix = req_ix
        # per-atom "any candidate at all": rows of candidate-free atoms can
        # never match (the liveness analogue), so the engine matches only the
        # complement and dead traffic rides through at gather speed
        self.has_cand = np.array([bool(r) for r in rows], dtype=bool)
        self.has_cand_list = self.has_cand.tolist()
        # ``remaining`` stays a prefix view of ``_rem_buf`` so patch-time
        # appends are amortized O(1) (capacity-doubling) instead of a full
        # O(R) concatenate per new request
        self._rem_buf = np.array(
            [max(0, r.demand - r.granted) for r in requests], dtype=np.int64)
        self.remaining = self._rem_buf[:len(requests)]
        self._lower(kcap)

    # ------------------------------------------------------------------ build

    @classmethod
    def from_scheduler(cls, sched, token: tuple, kcap: int = 32,
                       export_limit: Optional[int] = None,
                       device: Optional[torch.device] = None
                       ) -> "MatchState":
        slots = sched.export_match_slots(export_limit)
        A = len(slots)
        requests: List[JobRequest] = []
        req_ix = {}
        rows: List[Optional[List[Tuple[int, float, float]]]] = []
        covered = np.zeros(A, dtype=bool)
        for aid, sl in enumerate(slots):
            if sl is None:
                rows.append(None)
                continue
            covered[aid] = True
            row = []
            for req, lo, hi in sl:
                j = req_ix.get(id(req))
                if j is None:
                    j = req_ix[id(req)] = len(requests)
                    requests.append(req)
                row.append((j, lo, hi))
            rows.append(row)
        return cls(requests, rows, covered, req_ix, token, kcap, export_limit,
                   device)

    def _lower(self, kcap: int) -> None:
        """Lower the candidate rows into dense ``(A, K)`` arrays with
        ``K = min(kcap, longest row)``; rows cut by the cap mark their atom
        truncated (the engine's expand-and-rematch cue)."""
        rows = self._rows
        A = len(rows)
        kmax = max([len(r) for r in rows if r] or [1])
        K = min(kcap, kmax)
        self.kcap = K if kmax > K else kmax
        cand_req = np.full((A, max(K, 1)), -1, dtype=np.int64)
        cand_lo = np.zeros((A, max(K, 1)))
        cand_hi = np.zeros((A, max(K, 1)))
        truncated = np.zeros(A, dtype=bool)
        for aid, row in enumerate(rows):
            if not row:
                continue
            cut = row[:K]
            cand_req[aid, :len(cut)] = [r[0] for r in cut]
            cand_lo[aid, :len(cut)] = [r[1] for r in cut]
            cand_hi[aid, :len(cut)] = [r[2] for r in cut]
            # a row at the export limit may itself be a cut prefix: treat it
            # as truncated so exhaustion triggers a wider re-export
            truncated[aid] = len(row) > K or (
                self.export_limit is not None
                and len(row) >= self.export_limit)
        self.cand_req = cand_req
        self.cand_lo = cand_lo
        self.cand_hi = cand_hi
        self.truncated = truncated
        self._upload()

    def _upload(self) -> None:
        """(Re)create the device mirror from the NumPy arrays, whole."""
        dev = self.device
        if dev is None:
            self.d_cand_req = self.d_cand_lo = self.d_cand_hi = None
            self.d_has_cand = self.d_truncated = None
            return
        self.d_cand_req = torch.from_numpy(
            self.cand_req.astype(np.int32)).to(dev)
        self.d_cand_lo = torch.from_numpy(self.cand_lo).to(dev)
        self.d_cand_hi = torch.from_numpy(self.cand_hi).to(dev)
        self.d_has_cand = torch.from_numpy(self.has_cand).to(dev)
        self.d_truncated = torch.from_numpy(self.truncated).to(dev)

    def _upload_rows(self, aids: List[int]) -> None:
        """Copy the rows ``aids`` of every mirrored array to the device: one
        ``index_copy_`` per array."""
        dev = self.device
        if dev is None or not aids:
            return
        ix = np.asarray(aids, dtype=np.int64)
        d_ix = torch.from_numpy(ix).to(dev)
        self.d_cand_req.index_copy_(0, d_ix, torch.from_numpy(
            self.cand_req[ix].astype(np.int32)).to(dev))
        self.d_cand_lo.index_copy_(
            0, d_ix, torch.from_numpy(self.cand_lo[ix]).to(dev))
        self.d_cand_hi.index_copy_(
            0, d_ix, torch.from_numpy(self.cand_hi[ix]).to(dev))
        self.d_has_cand.index_copy_(
            0, d_ix, torch.from_numpy(self.has_cand[ix]).to(dev))
        self.d_truncated.index_copy_(
            0, d_ix, torch.from_numpy(self.truncated[ix]).to(dev))

    # ------------------------------------------------------------------ patch

    def patch(self, sched, token: tuple, dirty) -> None:
        """Delta-maintain the mirror: re-derive only the ``dirty`` atom ids
        from scheduler truth (``export_match_rows``) and stamp ``token``.

        Soundness contract (the caller's ``match_delta`` guarantees it):
        every atom whose row content changed since this state's token is in
        ``dirty``, and the atom universe / export cap are unchanged.  New
        requests surfacing in patched rows are appended to ``requests`` /
        ``remaining``; requests no longer reachable from any row keep their
        (now inert) entries — the matcher never sees them, and the engine
        forces a full rebuild when the dead fraction grows too large.
        ``_rows`` is kept authoritative so a later :meth:`expand` re-lowers
        patched atoms from truth, and a row longer than the current ``K``
        just marks its atom truncated (the normal widen machinery)."""
        self.token = token
        if not dirty:
            return
        aids = sorted(dirty)
        # copy=False: the live slot lists are consumed in this loop and never
        # retained — the (j, lo, hi) rows built below are fresh tuples
        new_rows = sched.export_match_rows(aids, self.export_limit,
                                           copy=False)
        rows = self._rows
        req_ix = self._req_ix
        requests = self.requests
        covered = self.covered
        has_cand = self.has_cand
        has_cand_list = self.has_cand_list
        cand_req, cand_lo, cand_hi = self.cand_req, self.cand_lo, self.cand_hi
        truncated = self.truncated
        K = cand_req.shape[1]
        new_rem: List[int] = []
        cov_flipped = False
        for aid, sl in zip(aids, new_rows):
            if sl is None:
                rows[aid] = None
                if covered[aid]:
                    covered[aid] = False
                    cov_flipped = True
                has_cand[aid] = False
                has_cand_list[aid] = False
                cand_req[aid, :] = -1
                cand_lo[aid, :] = 0.0
                cand_hi[aid, :] = 0.0
                truncated[aid] = False
                continue
            try:
                # fast path: every slot request already interned (churny
                # replans dirty the same rows over and over; an unseen
                # request appears at most once, on its arrival replan)
                row = [(req_ix[id(req)], lo, hi) for req, lo, hi in sl]
            except KeyError:
                row = []
                for req, lo, hi in sl:
                    j = req_ix.get(id(req))
                    if j is None:
                        j = req_ix[id(req)] = len(requests)
                        requests.append(req)
                        new_rem.append(max(0, req.demand - req.granted))
                    row.append((j, lo, hi))
            rows[aid] = row
            if not covered[aid]:
                covered[aid] = True
                cov_flipped = True
            alive = bool(row)
            has_cand[aid] = alive
            has_cand_list[aid] = alive
            cut = row[:K]
            m = len(cut)
            if m:
                js, los, his = zip(*cut)
                cand_req[aid, :m] = js
                cand_lo[aid, :m] = los
                cand_hi[aid, :m] = his
            if m < K:
                cand_req[aid, m:] = -1
                cand_lo[aid, m:] = 0.0
                cand_hi[aid, m:] = 0.0
            truncated[aid] = len(row) > K or (
                self.export_limit is not None
                and len(row) >= self.export_limit)
        if new_rem:
            buf = self._rem_buf
            n = self.remaining.shape[0]
            need = n + len(new_rem)
            if need > buf.shape[0]:
                grown = np.empty(max(need, 2 * buf.shape[0], 64),
                                 dtype=np.int64)
                grown[:n] = self.remaining
                buf = self._rem_buf = grown
            buf[n:need] = new_rem
            self.remaining = buf[:need]
        self._upload_rows(aids)
        if cov_flipped:
            self.all_covered = bool(covered.all()) if len(covered) else False

    def verify_against(self, sched) -> None:
        """Paranoid self-check (``REPRO_MATCH_CHECK=1``): re-derive the
        mirror from scheduler truth and raise on any semantic drift.

        Rows are compared as ``(request-object, lo, hi)`` sequences (dense
        indices differ between a patched and a fresh state — patched states
        keep inert entries for retired requests); ``remaining`` is compared
        for every truth-reachable request."""
        truth = MatchState.from_scheduler(sched, self.token,
                                          kcap=self.cand_req.shape[1],
                                          export_limit=self.export_limit)
        if truth.num_atoms != self.num_atoms:
            raise RuntimeError(
                f"match mirror drift: atom universe {self.num_atoms} != "
                f"truth {truth.num_atoms}")
        for aid in range(truth.num_atoms):
            mine, real = self._rows[aid], truth._rows[aid]
            if (mine is None) != (real is None):
                raise RuntimeError(
                    f"match mirror drift: atom {aid} covered="
                    f"{mine is not None}, truth {real is not None}")
            if mine is None:
                continue
            sem = [(id(self.requests[j]), lo, hi) for j, lo, hi in mine]
            want = [(id(truth.requests[j]), lo, hi) for j, lo, hi in real]
            if sem != want:
                raise RuntimeError(
                    f"match mirror drift: atom {aid} row differs "
                    f"({len(mine)} vs {len(real)} slots)")
        for j, req in enumerate(truth.requests):
            mj = self._req_ix.get(id(req))
            if mj is None:
                raise RuntimeError(
                    f"match mirror drift: request {req!r} unknown to mirror")
            if int(self.remaining[mj]) != int(truth.remaining[j]):
                raise RuntimeError(
                    f"match mirror drift: remaining[{req!r}] = "
                    f"{int(self.remaining[mj])}, truth {int(truth.remaining[j])}")
        # dense-array consistency: the (A, K) prefixes must reflect _rows
        K = self.cand_req.shape[1]
        for aid, row in enumerate(self._rows):
            cut = row[:K] if row else []
            m = len(cut)
            if (self.cand_req[aid, :m].tolist() != [r[0] for r in cut]
                    or (m < K and self.cand_req[aid, m] != -1)):
                raise RuntimeError(
                    f"match mirror drift: dense row {aid} out of sync")

    def expand(self) -> bool:
        """Double the candidate cap (after a truncated row exhausted its
        prefix).  Returns False when the *stored* rows cannot widen K any
        further — rows still marked truncated then are export-cap prefixes,
        and the caller must re-export wider (``NeedWiderExport``)."""
        if not self.truncated.any():
            return False
        kmax = max((len(r) for r in self._rows if r), default=1)
        if self.kcap >= kmax:
            return False
        self._lower(self.kcap * 2)
        return True

    # ------------------------------------------------------------------- api

    @property
    def num_atoms(self) -> int:
        return len(self.covered)

    @property
    def num_requests(self) -> int:
        return len(self.requests)

    def first_miss(self, atom_ids: np.ndarray) -> int:
        """Index of the first check-in whose atom the state does not cover
        (relative to ``atom_ids``), or ``-1`` if every atom is covered.

        Ids beyond the state's atom range count as uncovered: they were
        interned after the plan compiled, the definition of a MISS."""
        A = self.num_atoms
        miss = (atom_ids >= A) | ~self.covered[np.minimum(atom_ids, A - 1)] \
            if A else np.ones(len(atom_ids), dtype=bool)
        idx = np.argmax(miss)
        if not miss[idx]:
            return -1
        return int(idx)

    def consume(self, req_index: int) -> None:
        """Mirror one applied grant (the array analogue of the dispatch
        table's lazy filled-slot invalidation)."""
        self.remaining[req_index] -= 1

    def request_index(self, req: JobRequest) -> Optional[int]:
        """Index of ``req`` in this state (None if unknown — e.g. a request
        surfaced by a mid-segment replan; caller must invalidate)."""
        return self._req_ix.get(id(req))

    def to_numpy(self) -> dict:
        """The state's arrays as NumPy, read back from the device mirror
        where there is one (the inverse of :func:`match_state_from_numpy`)."""
        if self.device is None:
            cand_req, lo, hi = self.cand_req, self.cand_lo, self.cand_hi
            has_cand, truncated = self.has_cand, self.truncated
        else:
            cand_req = self.d_cand_req.cpu().numpy().astype(np.int64)
            lo = self.d_cand_lo.cpu().numpy()
            hi = self.d_cand_hi.cpu().numpy()
            has_cand = self.d_has_cand.cpu().numpy()
            truncated = self.d_truncated.cpu().numpy()
        return {"cand_req": cand_req.copy(), "cand_lo": lo.copy(),
                "cand_hi": hi.copy(), "remaining": self.remaining.copy(),
                "covered": self.covered.copy(), "has_cand": has_cand.copy(),
                "truncated": truncated.copy(), "kcap": self.kcap}


def match_state_from_numpy(arrays: dict, device) -> MatchState:
    """Carry a match state across as raw arrays.

    ``arrays`` holds a ``MatchState``'s NumPy arrays — ``cand_req`` ``(A,
    K)`` int, ``cand_lo`` / ``cand_hi`` ``(A, K)`` float64, ``remaining``
    ``(R,)`` int, ``covered`` / ``has_cand`` / ``truncated`` ``(A,)`` bool,
    ``kcap`` — typically lifted from the reference package's state; the
    result is this package's state on ``device`` with the same content, so a
    test can put one state through both matchers.  There are no request
    objects on this route: ``requests`` is a list of ``None`` of the right
    length, and no row lists: the state can be matched, not patched or
    expanded."""
    st = object.__new__(MatchState)
    st.device = torch.device(device) if device is not None else None
    st.cand_req = np.array(arrays["cand_req"], dtype=np.int64)
    st.cand_lo = np.array(arrays["cand_lo"], dtype=np.float64)
    st.cand_hi = np.array(arrays["cand_hi"], dtype=np.float64)
    st._rem_buf = np.array(arrays["remaining"], dtype=np.int64)
    st.remaining = st._rem_buf[:]
    st.covered = np.array(arrays["covered"], dtype=bool)
    st.has_cand = np.array(arrays["has_cand"], dtype=bool)
    st.has_cand_list = st.has_cand.tolist()
    st.truncated = np.array(arrays["truncated"], dtype=bool)
    st.kcap = int(arrays["kcap"])
    st.all_covered = bool(st.covered.all()) if len(st.covered) else False
    st.miss_free = False
    st.token = ("from_numpy",)
    st.export_limit = None
    st.requests = [None] * len(st.remaining)
    st._req_ix = {}
    st._rows = []
    st._upload()
    return st


class SupplyRings:
    """Read-only struct-of-arrays view of a supply estimator's ring buffers.

    Stacks the per-atom ``(nb,)`` bucket rings into one ``(A, nb)`` matrix and
    evaluates the window eviction as a broadcast mask, so the all-atom rate
    vector is a single array pass.  Values are bit-identical to per-atom
    ``rate_id`` calls; unlike ``SupplyEstimator.snapshot_rates`` the view does
    not write the eviction back (the estimator's lazy eviction remains the
    source of truth).
    """

    __slots__ = ("counts", "totals", "next_evict", "nb", "window", "bucket",
                 "prior_rate", "t0", "now")

    def __init__(self, counts: np.ndarray, totals: np.ndarray,
                 next_evict: np.ndarray, nb: int, window: float,
                 bucket: float, prior_rate: float, t0: Optional[float],
                 now: float):
        self.counts = counts
        self.totals = totals
        self.next_evict = next_evict
        self.nb = nb
        self.window = window
        self.bucket = bucket
        self.prior_rate = prior_rate
        self.t0 = t0
        self.now = now

    @classmethod
    def from_estimator(cls, est: SupplyEstimator) -> "SupplyRings":
        # the estimator stores one (capacity, nb) matrix with rows [0, _n)
        # live; copy the live slice so the view stays pristine while the
        # estimator keeps evicting/recording in place
        n = est._n
        return cls(est._counts[:n].copy(),
                   est._totals[:n].copy(),
                   est._next_evict[:n].copy(),
                   est._nb, est.window, est.bucket, est.prior_rate,
                   est._t0, est._now)

    def rates(self) -> np.ndarray:
        """All-atom rate vector (``prior_rate`` where the window is empty).
        Eviction math is shared with the estimator
        (:func:`repro_torch.core.supply.window_evicted_totals`), applied here
        without write-back."""
        A = len(self.totals)
        if A == 0:
            return np.zeros(0)
        horizon_excl = int(math.ceil((self.now - self.window) / self.bucket))
        totals, _, _, _ = window_evicted_totals(
            self.counts, self.totals, self.next_evict, self.nb, horizon_excl)
        t0 = self.t0 if self.t0 is not None else 0.0
        span = min(self.window, max(self.now - t0, self.bucket))
        return np.where(totals > 0, totals / span, self.prior_rate)
