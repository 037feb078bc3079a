"""Dynamic resource supply estimation (§4.4).

Device availability is strongly diurnal (Figure 2a), so momentary rates are a
bad input for the scheduler.  Venn records each device check-in (with its
eligibility atom) in a time-series store and uses the **average eligible rate
over a trailing 24-hour window** as the representative supply |S_j| of each job
group — a farsighted estimate robust to the time of day.

Fast path: all per-atom state lives in one dense ``(capacity, nb)`` NumPy
matrix of time-bucket counts (one column per ``bucket`` seconds of the
window) plus parallel ``totals`` / ``next_evict`` vectors, grown
geometrically.  Recording a whole chunk of check-ins is a single
``np.add.at`` scatter plus one bincount — no per-atom masking passes — and
window eviction is one batched :func:`window_evicted_totals` call over the
whole matrix.  A cached eviction horizon (``_evicted_to``) makes
``advance``/``snapshot_rates`` O(1) when no bucket boundary has been crossed
since the last eviction pass: the replan's supply refresh pays only when
time actually moved a bucket.

The estimator still speaks frozenset atom keys at the boundary (``record`` /
``rate`` / ``known_atoms``); :meth:`record_batch` is the vectorized entry the
scheduler's chunk feed uses.

Atom ids come from a shared :class:`~repro_torch.core.interning.AtomInterner`
(pass the eligibility index's interner to share one id space — the manager
does, so classification ids feed ``record_batch`` directly with no LUT).
Per-atom ring storage grows lazily, so ids interned by other consumers cost
nothing until this estimator sees traffic for them.

Span anchoring: ``_t0`` is the time of the *first recorded event* (not 0.0),
so estimators whose first observation arrives late do not divide by an
inflated span.
"""
from __future__ import annotations

import math
from typing import FrozenSet, Iterable, Optional, Tuple

import numpy as np

from .interning import AtomInterner

AtomKey = FrozenSet[str]

DAY = 24 * 3600.0


def window_evicted_totals(counts: np.ndarray, totals: np.ndarray,
                          next_evict: np.ndarray, nb: int,
                          horizon_excl: int):
    """Vectorized window eviction over stacked rings (pure function — the
    single home of the eviction-mask math, shared by the write-back
    ``SupplyEstimator`` eviction and the read-only
    :class:`repro_torch.accel.state.SupplyRings` view).

    Returns ``(new_totals, whole, part, mask)``: per-atom totals after
    evicting buckets in ``[next_evict, horizon_excl)``, the whole-ring-stale
    mask, the partial-eviction mask, and the ``(A, nb)`` ring-slot mask of
    evicted positions (None when no ring is partially stale).  Ring slots
    ``(pos - ne) % nb < gap`` are exactly the buckets ``_evict_id`` zeroes
    one by one."""
    gap = horizon_excl - next_evict
    whole = gap >= nb
    part = (gap > 0) & ~whole
    new_totals = totals.copy()
    mask = None
    if part.any():
        pos = np.arange(nb, dtype=np.int64)
        mask = part[:, None] & (
            (pos[None, :] - next_evict[:, None]) % nb < gap[:, None])
        new_totals = new_totals - (counts * mask).sum(axis=1)
    new_totals[whole] = 0
    return new_totals, whole, part, mask


class SupplyEstimator:
    """Sliding-window per-atom check-in rate estimator.

    Counts are bucketed per atom into a ring buffer spanning ``window``;
    querying evicts buckets older than the window.  A configurable
    ``prior_rate`` seeds estimates before any data is seen (cold start).
    """

    def __init__(self, window: float = DAY, prior_rate: float = 0.1,
                 bucket: float = 60.0, interner: Optional[AtomInterner] = None):
        self.window = float(window)
        self.prior_rate = float(prior_rate)
        self.bucket = float(bucket)
        self._nb = int(math.ceil(self.window / self.bucket)) + 1
        # not `interner or ...`: an empty interner is falsy via __len__
        self.interner = interner if interner is not None else AtomInterner()
        self._n = 0                             # atoms with storage (<= capacity)
        self._counts = np.zeros((0, self._nb), dtype=np.int64)   # (cap, nb)
        self._totals = np.zeros(0, dtype=np.int64)               # (cap,)
        self._next_evict = np.zeros(0, dtype=np.int64)           # (cap,)
        # eviction horizon every row [0, _n) is known to have reached; lets
        # advance()/snapshot_rates() early-out in O(1) when the clock has not
        # crossed a bucket boundary since the last eviction pass
        self._evicted_to = 0
        self._t0: Optional[float] = None        # first recorded event (span anchor)
        self._now: float = 0.0

    # ------------------------------------------------------------- interning

    def intern(self, key: AtomKey) -> int:
        aid = self.interner.intern(key)
        self._ensure(aid)
        return aid

    def _ensure(self, aid: int) -> None:
        """Grow per-atom ring storage to cover ids up to ``aid`` (ids are
        assigned by the shared interner, possibly by other consumers)."""
        if aid < self._n:
            return
        cap = len(self._totals)
        if aid >= cap:
            new_cap = max(aid + 1, 2 * cap, 8)
            counts = np.zeros((new_cap, self._nb), dtype=np.int64)
            counts[:self._n] = self._counts[:self._n]
            self._counts = counts
            totals = np.zeros(new_cap, dtype=np.int64)
            totals[:self._n] = self._totals[:self._n]
            self._totals = totals
            ne = np.zeros(new_cap, dtype=np.int64)
            ne[:self._n] = self._next_evict[:self._n]
            self._next_evict = ne
        # fresh rings are all-zero, so starting them already evicted through
        # the shared horizon is bit-identical to starting at 0 and letting
        # the first _evict_id zero an empty ring
        self._next_evict[self._n:aid + 1] = max(self._evicted_to, 0)
        self._n = aid + 1

    # ------------------------------------------------------------------ I/O

    def record(self, atom: AtomKey, time: float) -> None:
        """Record one check-in (scalar compatibility path)."""
        aid = self.intern(atom)
        if self._t0 is None:
            self._t0 = time
        self._now = max(self._now, time)
        self._evict_id(aid)
        b = int(time // self.bucket)
        if b >= self._next_evict[aid]:      # bucket still inside the window
            self._counts[aid, b % self._nb] += 1
            self._totals[aid] += 1

    def record_batch(self, atom_ids: np.ndarray, times: np.ndarray,
                     babs: Optional[np.ndarray] = None) -> None:
        """Vectorized record of a time-sorted batch of check-ins.

        ``atom_ids`` are dense ids of the shared interner (e.g. straight from
        ``EligibilityIndex.classify`` when the interner is shared).  ``babs``
        optionally carries precomputed absolute bucket indices
        (``times // bucket`` as int64) — the chunk feed buckets a whole chunk
        once and passes slices, keeping the division out of the replan path.
        """
        if len(times) == 0:
            return
        self._ensure(int(atom_ids.max()))
        if self._t0 is None:
            self._t0 = float(times[0])
        self._now = max(self._now, float(times[-1]))
        # one batched eviction brings every ring to the current horizon, so
        # the adds below need no per-atom eviction (eviction never changes
        # query results; it only realizes them eagerly)
        self._evict_all()
        horizon_excl = self._horizon()
        # drop events whose *bucket* has already left the window (bucket
        # granularity, matching the scalar path / ring eviction exactly)
        if babs is None:
            babs = (times // self.bucket).astype(np.int64)
        if babs[0] < horizon_excl:
            keep = babs >= horizon_excl
            babs, atom_ids = babs[keep], atom_ids[keep]
            if len(babs) == 0:
                return
        size = self._n * self._nb
        if size <= (len(babs) << 6):
            # dense rings / big batch: one flat bincount over (atom, slot)
            # pairs + a contiguous matrix add beats np.add.at's per-element
            # fancy-indexing loop by ~5x (identical integer counts)
            flat = atom_ids * self._nb + babs % self._nb
            self._counts[:self._n].reshape(-1)[:] += \
                np.bincount(flat, minlength=size)
        else:
            np.add.at(self._counts, (atom_ids, babs % self._nb), 1)
        adds = np.bincount(atom_ids)
        self._totals[:len(adds)] += adds.astype(np.int64, copy=False)

    def advance(self, time: float) -> None:
        """Advance the clock and realize any window eviction it implies.

        Early-outs in O(1) when the advance stays within the same bucket
        (``_evicted_to`` caches the horizon every ring has reached), so the
        replan's supply refresh only pays when a bucket boundary was actually
        crossed — previously this walked every known atom id regardless."""
        self._now = max(self._now, time)
        self._evict_all()

    def _horizon(self) -> int:
        """First absolute bucket index still inside the window."""
        return int(math.ceil((self._now - self.window) / self.bucket))

    def _evict_all(self) -> None:
        """Batched eviction of every ring up to the current horizon."""
        h = self._horizon()
        if h <= self._evicted_to:       # no bucket boundary crossed: O(1)
            return
        n = self._n
        if n:
            counts = self._counts[:n]
            totals, whole, part, mask = window_evicted_totals(
                counts, self._totals[:n], self._next_evict[:n], self._nb, h)
            if mask is not None:
                counts[mask] = 0
            counts[whole] = 0
            self._totals[:n] = totals
            self._next_evict[:n] = h
        self._evicted_to = h

    def _evict_id(self, aid: int) -> None:
        """Zero ring slots whose bucket start fell out of the window (scalar
        reference path; the batched entries use :meth:`_evict_all`)."""
        horizon_excl = self._horizon()
        ne = int(self._next_evict[aid])
        if horizon_excl <= ne:
            return
        if horizon_excl - ne >= self._nb:       # long idle gap: whole ring is stale
            self._counts[aid, :] = 0
            self._totals[aid] = 0
        else:
            idx = np.arange(ne, horizon_excl) % self._nb
            row = self._counts[aid]
            self._totals[aid] -= int(row[idx].sum())
            row[idx] = 0
        self._next_evict[aid] = horizon_excl

    # -------------------------------------------------------------- queries

    def rate(self, atom: AtomKey) -> float:
        """Estimated check-in rate (devices/sec) for one atom."""
        aid = self.interner.id_of(atom)
        if aid is None or aid >= self._n:
            return self.prior_rate
        return self.rate_id(aid)

    def rate_id(self, aid: int) -> float:
        if aid >= self._n:
            return self.prior_rate
        self._evict_id(aid)
        n = int(self._totals[aid])
        if n == 0:
            return self.prior_rate
        t0 = self._t0 if self._t0 is not None else 0.0
        span = min(self.window, max(self._now - t0, self.bucket))
        return n / span

    def snapshot_rates(self) -> Tuple[np.ndarray, np.ndarray]:
        """Vectorized all-atom rate snapshot: ``(seen, rates)`` arrays over
        dense atom ids (``seen[aid]`` iff the window holds traffic for it).

        One batched eviction pass over the ring matrix replaces the per-atom
        ``_evict_id`` + ``rate_id`` loop the scheduler replan used to run;
        values are bit-identical to the scalar path (same eviction set, same
        span).  Eviction is written back, so the scalar paths stay consistent
        with the snapshot — and when no bucket boundary has been crossed
        since the last pass this is a pure O(n) read with no eviction work."""
        n = self._n
        if n == 0:
            return np.zeros(0, dtype=bool), np.zeros(0)
        self._evict_all()
        totals = self._totals[:n]
        t0 = self._t0 if self._t0 is not None else 0.0
        span = min(self.window, max(self._now - t0, self.bucket))
        seen = totals > 0
        rates = np.where(seen, totals / span, self.prior_rate)
        return seen, rates

    def rate_of_atoms(self, atoms: Iterable[AtomKey]) -> float:
        """|S_j|: aggregate eligible rate over a union of atoms."""
        return sum(self.rate(a) for a in set(atoms))

    def known_atoms(self) -> Tuple[AtomKey, ...]:
        self._evict_all()
        key_of = self.interner.key_of
        return tuple(key_of(aid) for aid in
                     np.flatnonzero(self._totals[:self._n] > 0).tolist())
