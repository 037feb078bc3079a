"""Batched check-in matching: one call per drain segment instead of one
``scheduler.checkin`` per device.

Between two control events the scheduler's decision state is frozen (plans
only change on request arrival/completion, which are heap events), except
that requests *fill* as grants are handed out.  Matching a whole segment is
therefore a sequential-capacity problem: process check-ins in time order,
give each its first eligible live slot, decrement that request's remaining
demand.  :func:`match_chunk_torch` solves it without a per-device loop via
a **fill-position fixed point**:

1. assume no request fills inside the segment (``fillpos[r] = n``);
2. give every check-in its first candidate slot whose tier band accepts its
   speed and whose request is not yet filled *at the check-in's position*
   (a masked first-fit over the ``(n, K)`` candidate matrix);
3. recompute each request's fill position (the position of its
   ``remaining[r]``-th chooser);
4. repeat from 2 until the fill positions stop moving.

Fill positions only ever move earlier (a device falls to a lower-priority
slot only when an earlier fill invalidates its pick, adding choosers —
never removing early ones), so the loop converges in at most
``#requests-that-fill + 1`` iterations — typically 1–3.  The result is
bit-identical to the sequential scan; a sequential reference
(:func:`match_chunk_seq`) backs the property tests and serves degraded
segments.

One matcher per device: on a CUDA device the whole fixed point of a segment
is one launch of the hand-written kernel of
:mod:`repro_torch.accel.kernels.match_segment`, with one upload and one
download around it; on ``device="cpu"`` its plain version runs: the torch
program of :mod:`repro_torch.accel.match` on CPU tensors.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..obs import audit as _obsaudit
from ..obs import metrics as _obsmetrics
from ..obs import trace as _obstrace
from .kernels import match_segment as _match_segment
from .kernels.build import KernelError
from .state import MatchState

__all__ = ["ArrayMatchEngine", "DeviceMatchError", "MatchResult", "SEG_ROWS",
           "match_chunk_seq", "match_chunk_torch"]

# Upper bound on check-in rows per match call.  Prefix consistency makes
# slicing exact (a device's outcome depends only on earlier devices), and the
# cap bounds the dense (rows x candidates) working set regardless of how
# quiet the control heap is.
SEG_ROWS = 16384

# Below this many rows a segment is processed scalar-style (per-device
# ``checkin``): fixed NumPy call overhead (~20-30us per match) beats the
# Python loop only once a segment amortizes it.  Keeps the array engine
# no-worse-than-python on workloads whose control events chop the stream
# finely, while platform-scale streams ride the vectorized path.
SCALAR_SEG_ROWS = 32


class DeviceMatchError(RuntimeError):
    """The matcher on a CUDA device gave no result or a wrong one (the fixed
    point did not settle, or the result breaks an invariant).  Never served
    from the host instead: work given to the card is not quietly redone on
    the CPU."""


class NeedWiderExport(Exception):
    """A capped-export row exhausted its prefix mid-match: the engine has
    widened its cap and invalidated the state; the caller re-prepares and
    re-matches the same segment (exact — no side effects happened yet)."""


@dataclass
class MatchResult:
    """Outcome of one segment match.

    ``choice[i]`` is the request index (into ``state.requests``) check-in
    ``i`` would be assigned, ``-1`` if no slot wants it; ``granted[i]`` is
    True where the assignment holds under capacity (the first
    ``remaining[r]`` choosers of each request ``r``, in time order).
    ``rounds`` is the number of fixed-point rounds :func:`match_chunk_torch`
    took (0 for the other paths)."""

    choice: np.ndarray
    granted: np.ndarray
    rounds: int = 0


# --------------------------------------------------------------------------- #
# Sequential reference (the semantics contract)
# --------------------------------------------------------------------------- #

def match_chunk_seq(atom_ids: np.ndarray, speeds: np.ndarray,
                    state: MatchState) -> MatchResult:
    """Per-device sequential matching — the oracle the fixed point must equal.

    Mirrors ``DispatchTable.assign`` / ``BaseScheduler.checkin``: scan the
    atom's candidate slots in priority order, skip filled requests and
    mismatched tier bands, grant the first fit."""
    n = len(atom_ids)
    rem = state.remaining.copy()
    cand_req, lo, hi = state.cand_req, state.cand_lo, state.cand_hi
    choice = np.full(n, -1, dtype=np.int64)
    granted = np.zeros(n, dtype=bool)
    K = cand_req.shape[1]
    for i in range(n):
        a = int(atom_ids[i])
        s = float(speeds[i])
        for k in range(K):
            r = cand_req[a, k]
            if r < 0:
                break
            if rem[r] > 0 and lo[a, k] <= s < hi[a, k]:
                choice[i] = r
                granted[i] = True
                rem[r] -= 1
                break
    return MatchResult(choice, granted)


# --------------------------------------------------------------------------- #
# The matcher (device-resident fixed point)
# --------------------------------------------------------------------------- #

def match_chunk_torch(atom_ids: np.ndarray, speeds: np.ndarray,
                      state: MatchState, device: DeviceLike = None,
                      on_device: Optional[Tuple[torch.Tensor,
                                                torch.Tensor]] = None,
                      start: int = 0, live: Optional[np.ndarray] = None
                      ) -> MatchResult:
    """Segment matching on the state's device mirror.

    One call of :func:`repro_torch.accel.kernels.match_segment.match_segment`:
    on a CUDA device one launch computes the segment's eligibility (f64) and
    its whole fixed point, and ``choice`` and ``granted`` come back in one
    device-to-host copy.  ``on_device`` optionally holds ``(ids, speeds)``
    tensors already on the device (the engine's uploaded chunk) whose rows
    ``start + live[i]`` (``start + i`` when ``live`` is None) are the same
    rows as ``(atom_ids, speeds)``; without it the rows are uploaded."""
    n = len(atom_ids)
    rem = state.remaining
    R = len(rem)
    if n == 0 or R == 0:
        return MatchResult(np.full(n, -1, dtype=np.int64),
                           np.zeros(n, dtype=bool))
    dev = state.device
    if dev is None:
        raise ValueError("match_chunk_torch needs a MatchState built with a "
                         "device (it has no device mirror)")
    if device is not None and torch.device(device).type != dev.type:
        raise ValueError(f"state mirror lives on {dev}, not on {device}")
    if on_device is not None:
        ids_d, sp_d = on_device
    else:
        ids_d = torch.from_numpy(atom_ids.astype(np.int32)).to(dev)
        sp_d = torch.from_numpy(
            np.ascontiguousarray(speeds, dtype=np.float64)).to(dev)
        start, live = 0, None
    res = _match_segment.match_segment(
        state.d_cand_req, state.d_cand_lo, state.d_cand_hi, ids_d, sp_d, rem,
        n=n, start=start, live=live)
    if not res.settled:
        # The fixed point is proven to settle within R+2 rounds.  If that
        # ever breaks on the card the kernel is wrong, and the run stops; on
        # the CPU the sequential scan serves the segment.
        if dev.type == "cuda":
            raise DeviceMatchError(
                f"fixed point did not settle in {res.rounds} rounds "
                f"(n={n}, R={R}) on {dev}")
        return match_chunk_seq(atom_ids, speeds, state)   # pragma: no cover
    reg = _obsmetrics.REGISTRY
    if reg.enabled:
        reg.histogram("accel.fixedpoint_iters", lo=1.0, hi=1e3,
                      buckets_per_decade=20).record(res.rounds)
    return MatchResult(res.choice.astype(np.int64), res.granted, res.rounds)


# --------------------------------------------------------------------------- #
# Simulator-facing engine
# --------------------------------------------------------------------------- #

class ArrayMatchEngine:
    """Owns the :class:`MatchState` cache and the matcher's device for a
    :class:`~repro_torch.sim.simulator.Simulator` running with ``engine="array"``.

    Protocol (driven by the simulator's array drain):

    * ``prepare(sched, now)`` — make the scheduler's compiled state current
      (its lazy replan, at the same instant the scalar path would run it) and
      return the cached/rebuilt :class:`MatchState`;
    * ``match(atom_ids, speeds)`` — batched segment matching;
    * grants the simulator applies are mirrored via ``state.consume``.
    """

    def __init__(self, kcap: int = 32,
                 replan_budget_s: Optional[float] = None,
                 device: DeviceLike = None):
        # the matcher's device: cuda:0 unless the caller asks for the CPU
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # build + load the kernel here, outside any guard: a missing
            # compiler or a broken source must fail the run, not degrade it
            _match_segment.ensure_built()
        # the current chunk's (atom_ids i32, speeds f64) on the device,
        # uploaded once per (re)classification; the kernel reads a segment's
        # rows out of it by offset and live-row list
        self._chunk_dev: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        self.fixedpoint_rounds = 0      # fixed-point rounds of the matcher
        self.matcher_calls = 0          # segments that reached
        self.matcher_rows = 0           # the device matcher, their rows,
        self.matcher_s = 0.0            # and the wall time spent in them
        self.matcher_max_rows = 0       # the largest segment matched
        self.matcher_grid_calls = 0     # calls above GRID_ROWS rows (the
        self.matcher_grid_s = 0.0       # kernel's grid route), their time
        self.kcap = kcap                # adaptive candidate cap, sticky upward
        self.state: Optional[MatchState] = None
        self.rebuilds = 0
        self.segments = 0
        self.expansions = 0
        # ---- mirror deltas ----
        # On a token change the engine asks the scheduler for the dirty-atom
        # set since the mirror's token (match_delta) and patches only those
        # rows; a None answer (structural change: atom-universe growth,
        # partition refinement, fairness drift, restore) falls back to the
        # full rebuild.  REPRO_MATCH_DELTA=0 pins the full-rebuild path;
        # REPRO_MATCH_CHECK=1 re-derives the mirror from scheduler truth
        # after every patch and raises on drift (the paranoid mode,
        # mirroring REPRO_REPLAN_CHECK).
        self.delta_enabled = os.environ.get("REPRO_MATCH_DELTA", "1") != "0"
        self.check_deltas = bool(os.environ.get("REPRO_MATCH_CHECK"))
        self.patches = 0                # token changes served by st.patch
        self.rebuild_s = 0.0            # wall time in full mirror rebuilds
        self.patch_s = 0.0              # wall time in mirror patches
        # request-table compaction: patched mirrors keep inert entries for
        # retired requests; once the table outgrows the last rebuild's size
        # 4x, rebuild (geometric, so the amortized cost stays O(1)/replan)
        self._rebuilt_requests = 0
        # ---- graceful degradation (opt-in / counters) ----
        # replan_budget_s: minimum simulated seconds between replans; a dirty
        # plan inside the budget is served stale (sanitized for dead
        # requests) instead of recompiled.  Trades exactness for bounded
        # replan cost under churn — OFF by default, and incompatible with
        # cross-engine bit-equality when it actually fires.
        self.replan_budget_s = replan_budget_s
        self.degraded_segments = 0      # vectorized calls served by the
        #                                 sequential oracle (guard tripped)
        self.degraded = {"nonfinite": 0, "exception": 0, "implausible": 0}
        self.stale_plans_served = 0     # replans skipped under the budget
        self.staleness_s = 0.0          # cumulative age of stale plans served
        self._last_replan_t = -np.inf

    def __getstate__(self):
        # MatchState caches id()-keyed request maps — meaningless across a
        # pickle boundary.  Snapshot without it; the next prepare() rebuilds
        # from restored scheduler state (exactness via the usual protocol).
        # Device tensors (the mirror inside the state, the uploaded chunk)
        # go the same way; the kernel library and the pinned transfer
        # buffers are per-process caches in kernels, never held here.
        d = dict(self.__dict__)
        d["state"] = None
        d["_chunk_dev"] = None
        return d

    def prepare(self, sched, now: float) -> MatchState:
        if (self.replan_budget_s is not None and self.state is not None
                and sched.plan_dirty
                and now - self._last_replan_t < self.replan_budget_s):
            # serve the stale plan: zero capacity of requests that are no
            # longer live so no grant can reach them; new requests simply
            # wait out the budget (recorded staleness, never corruption)
            st = self.state
            rem = st.remaining
            for i, r in enumerate(st.requests):
                if rem[i] > 0 and (r.complete_time is not None
                                   or r.job.current is not r):
                    rem[i] = 0
            self.stale_plans_served += 1
            self.staleness_s += now - self._last_replan_t
            tr = _obstrace.TRACER
            if tr.enabled:
                tr.instant("accel.stale_plan", cat="accel", sim_t=now,
                           age_s=now - self._last_replan_t)
            aud = _obsaudit.AUDIT
            if aud.enabled:
                # flight recorder: grants served off this stale plan are
                # flagged — stale serving is the documented waiver of the
                # audit stream's cross-engine byte-identity
                aud.stale_plan(now)
            return st
        was_dirty = sched.plan_dirty
        sched.prepare_match(now)
        token = sched.match_token()
        st = self.state
        if st is None or st.token != token:
            tr = _obstrace.TRACER
            dirty = None
            if st is not None and self.delta_enabled:
                delta = getattr(sched, "match_delta", None)
                if delta is not None:
                    dirty = delta(st.token)
                if dirty is not None and len(st.requests) > max(
                        128, 4 * self._rebuilt_requests):
                    # patched mirrors accrete inert entries for retired
                    # requests; compact via a full rebuild once the table
                    # outgrows the last rebuild 4x (geometric amortization)
                    dirty = None
            if dirty is not None:
                tok = tr.begin("accel.state_delta", cat="accel") \
                    if tr.enabled else None
                t0 = time.perf_counter()
                st.patch(sched, token, dirty)
                self.patch_s += time.perf_counter() - t0
                if tok is not None:
                    tr.end(tok, atoms=len(dirty), requests=len(st.requests))
                self.patches += 1
                if self.check_deltas:
                    st.verify_against(sched)
            else:
                tok = tr.begin("accel.state_rebuild", cat="accel") \
                    if tr.enabled else None
                t0 = time.perf_counter()
                st = self.state = MatchState.from_scheduler(
                    sched, token, kcap=self.kcap,
                    # exported prefixes keep the per-replan rebuild
                    # O(atoms x limit); exhaustion re-exports wider
                    export_limit=max(4 * self.kcap, 128),
                    device=self.device)
                self.rebuild_s += time.perf_counter() - t0
                if tok is not None:
                    tr.end(tok, num_atoms=st.num_atoms,
                           requests=len(st.requests))
                self.rebuilds += 1
                self._rebuilt_requests = len(st.requests)
        if was_dirty or self._last_replan_t == -np.inf:
            self._last_replan_t = now
        return st

    def invalidate(self) -> None:
        self.state = None

    def bind_chunk(self, atom_ids: np.ndarray, speeds: np.ndarray) -> None:
        """Upload a (re)classified chunk's atom ids and speeds once; later
        ``match(..., start=cursor)`` calls read their rows on the device."""
        self._chunk_dev = (
            torch.from_numpy(atom_ids.astype(np.int32)).to(self.device),
            torch.from_numpy(np.ascontiguousarray(
                speeds, dtype=np.float64)).to(self.device))

    def match(self, atom_ids: np.ndarray, speeds: np.ndarray,
              start: Optional[int] = None) -> MatchResult:
        """Match one segment slice (all atoms covered — MISS rows are bounded
        out by the caller).  Rows of candidate-free atoms can never match, so
        the fixed point runs on the live subset only; dead traffic costs one
        gather.  ``start`` is the slice's offset in the chunk last given to
        :meth:`bind_chunk` (None: the rows are uploaded from the arrays)."""
        tr = _obstrace.TRACER
        if not tr.enabled:
            return self._match_impl(atom_ids, speeds, start)
        tok = tr.begin("accel.match", cat="accel", rows=len(atom_ids))
        try:
            res = self._match_impl(atom_ids, speeds, start)
        except NeedWiderExport:
            tr.end(tok, outcome="need_wider_export")
            raise
        tr.end(tok, granted=int(res.granted.sum()))
        return res

    def _match_impl(self, atom_ids: np.ndarray, speeds: np.ndarray,
                    start: Optional[int] = None) -> MatchResult:
        self.segments += 1
        st = self.state
        n = len(atom_ids)
        live = st.has_cand[atom_ids]
        idx = np.flatnonzero(live)
        choice = np.full(n, -1, dtype=np.int64)
        granted = np.zeros(n, dtype=bool)
        if len(idx) == 0:
            return MatchResult(choice, granted)
        sub_ids = atom_ids[idx]
        sub_speeds = speeds[idx]
        rows = None
        if start is not None and self._chunk_dev is not None \
                and start + n <= self._chunk_dev[0].shape[0]:
            # the kernel reads the live rows straight out of the bound chunk
            rows = (start, None if len(idx) == n else idx)
        while True:
            res = self._match_guarded(sub_ids, sub_speeds, st, rows)
            # a truncated atom's row that exhausted its capped prefix might
            # have a deeper live slot: widen the cap and re-match (exact;
            # needs ~cap fills inside one segment, so it is rare)
            suspect = (res.choice < 0) & st.truncated[sub_ids]
            if not suspect.any():
                break
            self.expansions += 1
            tr = _obstrace.TRACER
            if tr.enabled:
                tr.instant("accel.expand", cat="accel", kcap=st.kcap)
            if not st.expand():
                # the stored rows themselves were export-capped prefixes:
                # widen the cap and have the caller rebuild + re-match
                self.kcap = max(self.kcap * 2, st.kcap * 2)
                self.state = None
                raise NeedWiderExport
            self.kcap = max(self.kcap, st.kcap)
        choice[idx] = res.choice
        granted[idx] = res.granted
        return MatchResult(choice, granted)

    # ------------------------------------------------- graceful degradation

    def _match_guarded(self, sub_ids: np.ndarray, sub_speeds: np.ndarray,
                       st: MatchState, rows=None) -> MatchResult:
        """Vectorized match with divergence guards.  Non-finite speeds are
        an *input* problem: the segment is served by the sequential oracle
        (bit-identical semantics) with a counter, on every device.  A
        matcher exception or an implausible result degrades the same way only
        on ``device="cpu"``.  With the mirror on a CUDA device both stop the run: an in-kernel
        fault surfaces as a plain ``RuntimeError`` at the next sync, and a
        wrong result means a wrong kernel — neither may finish on the host
        with the same JCTs and nobody the wiser.
        :class:`~repro_torch.accel.kernels.build.KernelError` (build, load,
        launch) leaves on every device.  ``rows`` is ``(start, live)``: the
        rows' place in the bound chunk (None: upload them)."""
        on_card = self.device.type == "cuda"
        if not bool(np.isfinite(sub_speeds).all()):
            # corrupted speed readings: the sequential scan's comparisons
            # reject NaN/inf rows exactly like the scalar engine's checkin
            # does, while the kernel isn't audited for non-finite
            # inputs — serve the whole segment scalar-side
            return self._degrade("nonfinite", sub_ids, sub_speeds, st)
        try:
            t0 = time.perf_counter()
            if rows is None:
                res = match_chunk_torch(sub_ids, sub_speeds, st)
            else:
                res = match_chunk_torch(
                    sub_ids, sub_speeds, st, on_device=self._chunk_dev,
                    start=rows[0], live=rows[1])
            dt = time.perf_counter() - t0
            m = len(sub_ids)
            self.matcher_s += dt
            self.fixedpoint_rounds += res.rounds
            self.matcher_calls += 1
            self.matcher_rows += m
            self.matcher_max_rows = max(self.matcher_max_rows, m)
            if m > _match_segment.GRID_ROWS:
                self.matcher_grid_calls += 1
                self.matcher_grid_s += dt
        except KernelError:
            raise
        except Exception:
            if on_card:
                raise
            return self._degrade("exception", sub_ids, sub_speeds, st)
        if not self._plausible(res, len(sub_ids), st):
            if on_card:
                raise DeviceMatchError(
                    f"implausible match of {len(sub_ids)} rows on "
                    f"{self.device}: choice out of range, a grant without a "
                    "choice, or grants beyond a request's remaining demand")
            return self._degrade("implausible", sub_ids, sub_speeds, st)
        return res

    def _degrade(self, reason: str, sub_ids: np.ndarray,
                 sub_speeds: np.ndarray, st: MatchState) -> MatchResult:
        """Serve one segment through the sequential oracle, counted + traced."""
        self.degraded_segments += 1
        self.degraded[reason] += 1
        tr = _obstrace.TRACER
        if tr.enabled:
            tr.instant("accel.degraded", cat="accel", reason=reason,
                       rows=len(sub_ids))
        return match_chunk_seq(sub_ids, sub_speeds, st)

    @staticmethod
    def _plausible(res: MatchResult, m: int, st: MatchState) -> bool:
        """Cheap invariants every correct match satisfies: shapes, choice
        range, granted ⇒ chosen, per-request grants within capacity."""
        ch, gr = res.choice, res.granted
        if ch.shape != (m,) or gr.shape != (m,):
            return False
        R = len(st.remaining)
        if m and (int(ch.min()) < -1 or int(ch.max()) >= R):
            return False
        if bool((gr & (ch < 0)).any()):
            return False
        if bool(gr.any()):
            counts = np.bincount(ch[gr], minlength=R)
            if bool((counts > st.remaining).any()):
                return False
        return True
