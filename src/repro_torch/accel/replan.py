"""Array-native incremental replan: VENN-SCHED itself on dense arrays.

The check-in loop is array-native (``engine.py``); this module does the same
for the *replan* — the dominant remaining scheduler cost at scale.
:class:`ReplanEngine` replaces the scalar
``venn_schedule`` + ``compile_plan`` pair inside ``VennScheduler._reschedule``
with an **incrementally maintained** array formulation that is bit-identical
to the scalar path (same ``SchedulePlan.job_keys``, same group order, same
``DispatchTable.snapshot()``, byte-identical audit streams).

State layout — one :class:`_GroupOrder` per job group:

* ``jobs``   — slot-indexed list of the group's *pending* jobs (a job is
  pending iff it has an open request with remaining demand);
* ``ids`` / ``keys`` — parallel ``(cap,)`` int64/float64 arrays of job ids
  and intra-group demand keys (``remaining_demand / max(priority, 1e-9)``,
  maintained at event time when fairness is off);
* cached last-replan outputs: the published ``job_order`` list, its slot
  permutation, the lowered dispatch rows, and the head job's tier band.

Dirty-set protocol — the three simulator-driven mutations of the pending
set / demand keys each have exactly one hook:

* ``on_request``  — a round was submitted: add/refresh the job's slot;
* ``on_complete`` — a round finished or aborted: remove the slot;
* ``on_grant``    — a check-in was granted (``Simulator._grant``, the single
  grant site shared by both drain engines): update the key in place, or
  remove the slot when the request just filled.  Grants are the one
  mutation that flows through neither of the other hooks — a fill drops the
  job from ``pending_jobs()`` before any completion fires.

At replan time a group is then one of:

* **clean** (no events since last replan) — reuse the published
  ``job_order``/``job_keys`` lists and the lowered dispatch rows outright;
* **key-dirty** (grants only) — O(n) vectorized sortedness check of the new
  keys under the cached permutation; grants only shrink a served job's
  remaining demand (keys fall, heads stay heads), so the order usually
  survives and only the ``job_keys`` floats are re-emitted;
* **member-dirty** — ``np.lexsort((ids, keys))``, the segmented-argsort
  formulation of Alg. 1 lines 2-3 (bit-equal to ``sorted((key, id, job))``
  because job ids are unique).

The inter-group phase (initial scarcest-first claim + greedy pressure
reallocation) is *shared code* with the scalar path
(:func:`repro_torch.core.irs.inter_group_allocate` / ``atom_priorities``): group
counts are small, the job-dimension work is what needed vectorizing, and
sharing makes cross-path bit-identity structural rather than asserted.

Full-recompute escape hatches (``sync``): first use, restore from a crash
snapshot (``VennScheduler.__getstate__`` drops the engine), or any
validation failure under ``REPRO_REPLAN_CHECK=1`` (tests run the paranoid
mode: per replan, membership and keys are re-derived from the group objects
and compared exactly).

The device resort lives in ``kernels/replan_order.py``: the segmented-order
CUDA kernel (a warp a job counting the jobs of its group ahead of it, f64
keys, the permutation written in the same launch) with its plain PyTorch
version beside it.  It is the resort backend (``order_backend=
"kernel"``) whenever the engine's device is a CUDA device; on
``device="cpu"`` the resort stays NumPy (f64 lexsort).  Either way the
exactness bar is bit-identity with Python-float sorts, held by the strict-order
guard of :func:`_kernel_order`.
"""
from __future__ import annotations

import functools
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..core.dispatch import DispatchTable, _NO_BAND
from ..core.irs import SchedulePlan, atom_priorities, inter_group_allocate
from ..core.types import Job, JobGroup, JobRequest
from ..obs import trace as _obstrace


def _demand_key(job: Job, req: JobRequest) -> float:
    """The fairness-off intra-group key, maintained incrementally.  Must be
    bit-equal to ``FairnessPolicy.demand_key`` at ε = 0:
    ``float(remaining_demand) / max(priority, 1e-9)``."""
    return float(req.demand - req.granted) / max(job.priority, 1e-9)


_I32_MIN = -2 ** 31
_I32_MAX = 2 ** 31 - 1


# resorts that the strict-order guard sent back to np.lexsort (per process;
# stays 0 on finite keys, because the kernel compares f64)
order_fallbacks = 0
# resorts handed to the segmented_order wrapper (per process): one kernel
# launch each on a CUDA device
kernel_resorts = 0


class KernelOrderError(RuntimeError):
    """The resort kernel on a CUDA device returned a wrong order for finite
    keys."""


def _kernel_order(ids: np.ndarray, keys: np.ndarray,
                  device: DeviceLike = "cpu") -> np.ndarray:
    """Resort one group through the ``segmented_order`` kernel on ``device``,
    holding the NumPy path's bit-exactness bar.

    The kernel ranks on the f64 keys themselves, so on finite keys its
    permutation is ``np.lexsort``'s.  The guard stays all the same: a
    strict-order check on the f64 keys under the returned permutation.
    Because job ids are unique, ``(key, id)`` ascending is a strict total
    order, so a permutation passing the check IS the unique sorted order (a
    non-permutation repeats an element and fails the strict comparison).
    Non-finite keys (NaN has no order) fail it, fall back to ``np.lexsort``
    and are counted in ``order_fallbacks``.  A failure on finite keys means
    the kernel is wrong: on a CUDA device that raises
    :class:`KernelOrderError` instead of finishing on the host; on the CPU
    (the kernel's plain version) it falls back and is counted.  Job ids
    outside int32 take ``np.lexsort`` directly.

    ``keys`` and ``ids`` go up in one non-blocking copy from the device's
    pinned stage and the permutation comes back into another, in one call
    of the kernel's C entry; the group is one segment, so no segment ids
    are sent."""
    n = len(ids)
    if n < 2:
        return np.arange(n, dtype=np.int64)
    if ids.min() < _I32_MIN or ids.max() > _I32_MAX:
        return np.lexsort((ids, keys))
    global kernel_resorts
    from .kernels import replan_order
    dev = torch.device(device)
    kernel_resorts += 1
    perm = replan_order.segmented_order_staged(keys, ids, dev)
    return _guard_order(perm.astype(np.int64), ids, keys, dev)


def _guard_order(perm: np.ndarray, ids: np.ndarray, keys: np.ndarray,
                 dev: torch.device) -> np.ndarray:
    """The strict-order check of :func:`_kernel_order` on the permutation the
    kernel on ``dev`` returned."""
    global order_fallbacks
    k = keys[perm]
    i = ids[perm]
    if bool(np.all((k[:-1] < k[1:]) | ((k[:-1] == k[1:]) & (i[:-1] < i[1:])))):
        return perm
    if dev.type == "cuda" and bool(np.isfinite(keys).all()):
        raise KernelOrderError(
            f"segmented_order on {dev} returned no strict (key, id) order "
            f"for {len(ids)} finite keys")
    order_fallbacks += 1
    return np.lexsort((ids, keys))


class _GroupOrder:
    """Incrementally maintained pending set + demand keys for one group."""

    __slots__ = ("name", "jobs", "slot", "ids", "keys", "n",
                 "member_dirty", "key_dirty",
                 "job_order", "job_keys", "order_slots",
                 "lowered", "lowered_for", "lowered_band", "sorter")

    def __init__(self, name: str,
                 sorter: Optional[Callable[[np.ndarray, np.ndarray],
                                           np.ndarray]] = None):
        self.name = name
        # resort backend: None = np.lexsort; device-resident runs route
        # through the segmented_order CUDA kernel (guarded exact)
        self.sorter = sorter
        self.jobs: List[Job] = []          # slot-indexed pending jobs
        self.slot: Dict[int, int] = {}     # job_id -> slot
        self.ids = np.zeros(8, dtype=np.int64)
        self.keys = np.zeros(8)
        self.n = 0
        self.member_dirty = True
        self.key_dirty = True
        # last published outputs (reused while clean)
        self.job_order: Optional[List[Job]] = None
        self.job_keys: Optional[List[float]] = None
        self.order_slots: Optional[np.ndarray] = None
        # last lowered dispatch rows + identity of the order they lowered
        # and the head tier band they baked in
        self.lowered: Optional[List[list]] = None
        self.lowered_for: Optional[List[Job]] = None
        self.lowered_band: Optional[Tuple[int, float, float]] = None

    # --------------------------------------------------------------- events

    def _grow(self) -> None:
        cap = max(16, 2 * len(self.ids))
        ids = np.zeros(cap, dtype=np.int64)
        ids[:self.n] = self.ids[:self.n]
        self.ids = ids
        keys = np.zeros(cap)
        keys[:self.n] = self.keys[:self.n]
        self.keys = keys

    def add(self, job: Job, key: float) -> None:
        s = self.slot.get(job.job_id)
        if s is not None:                  # re-submitted round: refresh slot
            self.jobs[s] = job
            self.keys[s] = key
            # the job's request object was rebound: force a fresh published
            # order so stale lowered rows can never be identity-reused
            self.member_dirty = True
            return
        if self.n == len(self.ids):
            self._grow()
        s = self.n
        self.jobs.append(job)
        self.slot[job.job_id] = s
        self.ids[s] = job.job_id
        self.keys[s] = key
        self.n = s + 1
        self.member_dirty = True

    def remove(self, job_id: int) -> None:
        s = self.slot.pop(job_id, None)
        if s is None:
            return
        last = self.n - 1
        if s != last:                      # swap-remove keeps arrays dense
            j = self.jobs[last]
            self.jobs[s] = j
            self.ids[s] = self.ids[last]
            self.keys[s] = self.keys[last]
            self.slot[j.job_id] = s
        self.jobs.pop()
        self.n = last
        self.member_dirty = True

    # ---------------------------------------------------------------- order

    def refresh_keys(self, demand_key: Callable[[Job], float]) -> None:
        """Fairness-enabled path: keys drift with attained service and solo
        JCT every replan, so recompute them all (same callable as the scalar
        path — bit-equal values), keeping the order-reuse check below."""
        keys = self.keys
        for s, j in enumerate(self.jobs):
            keys[s] = demand_key(j)
        self.key_dirty = True

    def ordered(self) -> Tuple[List[Job], List[float], int]:
        """Publish ``(job_order, job_keys, status)`` for this replan; status
        is 0 = clean reuse, 1 = order survived a key check, 2 = resorted."""
        n = self.n
        ids = self.ids[:n]
        keys = self.keys[:n]
        if not self.member_dirty and self.order_slots is not None:
            if not self.key_dirty:
                return self.job_order, self.job_keys, 0
            perm = self.order_slots
            k = keys[perm]
            if n < 2:
                ok = True
            else:
                i = ids[perm]
                ok = bool(np.all((k[:-1] < k[1:])
                                 | ((k[:-1] == k[1:]) & (i[:-1] < i[1:]))))
            if ok:
                # same permutation, fresh key floats (audit surface)
                self.job_keys = k.tolist()
                self.key_dirty = False
                return self.job_order, self.job_keys, 1
        order = self.sorter(ids, keys) if self.sorter is not None \
            else np.lexsort((ids, keys))   # (key, job_id) ascending
        self.order_slots = order
        jobs = self.jobs
        self.job_order = [jobs[s] for s in order.tolist()]
        self.job_keys = keys[order].tolist()
        self.member_dirty = False
        self.key_dirty = False
        return self.job_order, self.job_keys, 2


class ReplanEngine:
    """Drop-in incremental replacement for ``venn_schedule`` +
    ``compile_plan`` inside ``VennScheduler._reschedule``."""

    def __init__(self, check: Optional[bool] = None,
                 order_backend: Optional[str] = None,
                 device: DeviceLike = None):
        if check is None:
            check = bool(os.environ.get("REPRO_REPLAN_CHECK"))
        self.check = check
        self.device = resolve_device(device)
        # intra-group resort backend: "numpy" (np.lexsort) or "kernel" (the
        # segmented_order CUDA kernel with the exact-order guard).  Pinned by
        # the argument or by REPRO_REPLAN_ORDER; otherwise "kernel" on a CUDA
        # device and "numpy" on the CPU.
        if order_backend is None:
            order_backend = os.environ.get("REPRO_REPLAN_ORDER") or (
                "kernel" if self.device.type == "cuda" else "numpy")
        if order_backend not in ("numpy", "kernel"):
            raise ValueError(f"unknown replan order backend {order_backend!r}")
        self.order_backend = order_backend
        if order_backend == "kernel" and self.device.type == "cuda":
            # build + load here, outside the guard's fallback: a kernel that
            # cannot be built must fail the run, not fall back to lexsort
            from .kernels import replan_order
            replan_order.ensure_built()
        self._sorter = functools.partial(_kernel_order, device=self.device) \
            if order_backend == "kernel" else None
        self._states: Dict[str, _GroupOrder] = {}
        self._synced = False
        # atom key -> (constituent lowered lists, merged list): cross-replan
        # reuse of per-atom merged rows.  Values hold strong refs to the
        # parts, so identity comparison below can never hit a recycled id().
        self._merged: Dict[frozenset, Tuple[tuple, List[list]]] = {}
        # stats for the obs layer (reset every schedule()/compile() pair)
        self.last_stats: Dict[str, int] = {}

    # ---------------------------------------------------------------- sync

    def sync(self, groups: Sequence[JobGroup]) -> None:
        """Full recompute escape hatch: rebuild every group state from the
        authoritative group objects (first use, post-restore, or after a
        validation failure)."""
        if self._synced:
            return
        tr = _obstrace.TRACER
        tok = tr.begin("venn.replan.sync", cat="sched") if tr.enabled else None
        self._states.clear()
        self._merged.clear()
        for g in groups:
            st = self._state(g.requirement.name)
            for j in g.pending_jobs():
                st.add(j, _demand_key(j, j.current))
        self._synced = True
        if tok is not None:
            tr.end(tok, groups=len(self._states))

    def _state(self, name: str) -> _GroupOrder:
        st = self._states.get(name)
        if st is None:
            st = self._states[name] = _GroupOrder(name, self._sorter)
        return st

    # --------------------------------------------------------- event hooks

    def on_request(self, request: JobRequest) -> None:
        if not self._synced:
            return
        job = request.job
        self._state(request.requirement.name).add(
            job, _demand_key(job, request))

    def on_complete(self, request: JobRequest) -> None:
        if not self._synced:
            return
        st = self._states.get(request.requirement.name)
        if st is not None:
            st.remove(request.job.job_id)

    def on_grant(self, request: JobRequest) -> None:
        if not self._synced:
            return
        st = self._states.get(request.requirement.name)
        if st is None:
            return
        s = st.slot.get(request.job.job_id)
        if s is None or st.jobs[s].current is not request:
            # stale-plan grant for a request we no longer track (documented
            # bit-exactness waiver) — nothing to maintain
            return
        rem = request.demand - request.granted
        if rem <= 0:
            st.remove(request.job.job_id)
        else:
            st.keys[s] = rem / max(request.job.priority, 1e-9)
            st.key_dirty = True

    # ------------------------------------------------------------- queries

    def pending_count(self, name: str) -> int:
        st = self._states.get(name)
        return st.n if st is not None else 0

    def total_pending(self) -> int:
        return sum(st.n for st in self._states.values())

    # ------------------------------------------------------------ schedule

    def schedule(self, active: Sequence[JobGroup],
                 queue_len: Callable[[JobGroup], float],
                 demand_key: Optional[Callable[[Job], float]] = None
                 ) -> SchedulePlan:
        """Alg. 1 with incremental intra-group ordering.  ``demand_key`` is
        None when fairness is off (keys are maintained at event time);
        otherwise it is the fairness-adjusted key and every group recomputes
        keys this replan (they drift with supply)."""
        plan = SchedulePlan(groups=list(active))
        reused = resorted = checked = 0
        for g in active:
            name = g.requirement.name
            st = self._state(name)
            if demand_key is not None:
                st.refresh_keys(demand_key)
            if self.check:
                self._verify(st, g, demand_key)
            jobs, keys, status = st.ordered()
            plan.job_order[name] = jobs
            plan.job_keys[name] = keys
            if status == 0:
                reused += 1
            elif status == 1:
                checked += 1
            else:
                resorted += 1
        inter_group_allocate(active, queue_len)
        plan.atom_priority = atom_priorities(active)
        self.last_stats = {"order_reused": reused, "order_checked": checked,
                           "order_resorted": resorted}
        return plan

    def _verify(self, st: _GroupOrder, g: JobGroup,
                demand_key: Optional[Callable[[Job], float]]) -> None:
        """Paranoid mode (REPRO_REPLAN_CHECK=1): re-derive membership and
        keys from the group object and compare exactly."""
        pend = g.pending_jobs()
        want = {j.job_id for j in pend}
        have = set(st.slot)
        if want != have or len(pend) != st.n:
            raise RuntimeError(
                f"replan engine drift in group {st.name!r}: "
                f"missing={sorted(want - have)} extra={sorted(have - want)}")
        for j in pend:
            expect = (demand_key(j) if demand_key is not None
                      else _demand_key(j, j.current))
            got = float(st.keys[st.slot[j.job_id]])
            if got != expect:
                raise RuntimeError(
                    f"replan engine key drift for job {j.job_id} in group "
                    f"{st.name!r}: have {got!r}, want {expect!r}")

    # ------------------------------------------------------------- compile

    def compile(self, plan: SchedulePlan, intern, num_atoms: int,
                tier_decisions: Dict[int, object]) -> DispatchTable:
        """Incremental ``compile_plan``: identical table content, with the
        per-group lowered rows reused while a group's published order object
        and head tier band are unchanged, and merged rows (memoized per
        priority-group-name sequence, like the scalar compiler) reused
        across replans while every constituent lowered list is the same
        object (a fill or completion in any constituent dirties its group,
        forcing a fresh order object — so identity implies the cached merged
        row was never touched by slot invalidation either)."""
        table = DispatchTable(num_atoms)
        slots_by_atom = table._slots
        lowered_by_group: Dict[str, List[list]] = {}
        low_reused = 0
        nlo, nhi = _NO_BAND
        for gname, jobs in plan.job_order.items():
            st = self._states.get(gname)
            head = jobs[0].current if jobs else None
            lo, hi = nlo, nhi
            if head is not None:
                d = tier_decisions.get(id(head))
                if d is not None and getattr(d, "tiered", False):
                    lo, hi = d.speed_lo, d.speed_hi
            band = (id(head), lo, hi)
            if (st is not None and st.lowered is not None
                    and st.lowered_for is jobs and st.lowered_band == band):
                lowered = st.lowered
                low_reused += 1
            else:
                lowered = []
                append = lowered.append
                first = True    # positional head: only slot 0 carries a band
                for job in jobs:
                    req = job.current
                    if req is None or req.demand - req.granted <= 0:
                        first = False
                        continue
                    if first:
                        append([req, lo, hi])
                        first = False
                    else:
                        append([req, nlo, nhi])
                if st is not None:
                    st.lowered = lowered
                    st.lowered_for = jobs
                    st.lowered_band = band
            lowered_by_group[gname] = lowered
        # merged rows: one memo hit per atom (keyed by the priority
        # name-sequence, matching compile_plan's sharing granularity), with
        # the previous replan's rows reused when the constituent lowered
        # lists are identity-unchanged
        merged_next: Dict[tuple, Tuple[tuple, List[list]]] = {}
        memo: Dict[tuple, List[list]] = {}     # this compile's rows
        old = self._merged
        mrg_reused = 0
        for key, groups in plan.atom_priority.items():
            aid = intern(key)
            if aid >= len(slots_by_atom):
                slots_by_atom.extend([None] * (aid + 1 - len(slots_by_atom)))
            names = tuple([g.requirement.name for g in groups])
            merged = memo.get(names)
            if merged is None:
                parts = tuple([lowered_by_group.get(n, ()) for n in names])
                cached = old.get(names)
                if cached is not None and len(cached[0]) == len(parts) and \
                        all(a is b for a, b in zip(cached[0], parts)):
                    merged = cached[1]
                    mrg_reused += 1
                else:
                    merged = []
                    for p in parts:
                        merged.extend(p)
                memo[names] = merged
                merged_next[names] = (parts, merged)
            slots_by_atom[aid] = merged
        self._merged = merged_next
        self.last_stats["lowered_reused"] = low_reused
        self.last_stats["merged_reused"] = mrg_reused
        return table
