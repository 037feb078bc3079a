"""Intersection Resource Scheduling — Algorithm 1 of the paper (§4.2).

Two-level decomposition:

* **Intra-group** (§4.2.1): within a resource-homogeneous job group, order jobs
  by remaining demand ascending (smallest-remaining-demand-first), optionally
  fairness-adjusted (§4.4).
* **Inter-group** (§4.2.2): (i) initial allocation — groups claim their
  eligible atoms scarcest-first with no sharing; (ii) greedy reallocation —
  from the most abundant group down, group ``j`` takes the intersected atoms
  owned by a scarcer overlapping group ``k`` iff the queue-pressure ratio
  ``m'_j/|S'_j| > m'_k/|S'_k|`` (Alg. 1 line 13, justified by Lemma 2:
  prioritize the side whose (queue length × per-job delay) product shrinks
  the average scheduling delay most).

The output is a :class:`SchedulePlan`: an ownership partition of atoms plus a
per-atom priority list of groups, so that device→job assignment is an O(1)
lookup on every check-in (devices are never "scattered" across jobs; the fixed
job order both minimizes delay and keeps the hot path cheap).

Complexity: ``max(O(m log m), O(n^2))`` for m jobs, n groups — measured in
benchmarks/fig10_overhead.py.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, FrozenSet, List, Optional, Sequence, Tuple

from .types import Job, JobGroup

AtomKey = FrozenSet[str]

# A queue-length provider:  group -> effective queue length m'_j (possibly
# fairness-adjusted, possibly counting previously-deprioritized jobs).
QueueLenFn = Callable[[JobGroup], float]
# A demand key for intra-group ordering (fairness-adjusted d'_i).
DemandKeyFn = Callable[[Job], float]


@dataclass
class SchedulePlan:
    """Result of one VENN-SCHED invocation."""

    groups: List[JobGroup] = field(default_factory=list)
    # atom -> groups in assignment-priority order (owner first, then fallbacks)
    atom_priority: Dict[AtomKey, List[JobGroup]] = field(default_factory=dict)
    # group.requirement.name -> ordered pending jobs (head = currently served)
    job_order: Dict[str, List[Job]] = field(default_factory=dict)
    # group.requirement.name -> the demand keys that produced job_order
    # (parallel lists; the audit recorder exports them so a snapshot shows
    # *why* the ordering came out the way it did)
    job_keys: Dict[str, List[float]] = field(default_factory=dict)

    def owner(self, atom: AtomKey) -> Optional[JobGroup]:
        order = self.atom_priority.get(atom)
        return order[0] if order else None

    def served_jobs(self) -> List[Job]:
        """{G_j[0]} — the head job of every group (Alg. 1 return value)."""
        return [order[0] for order in self.job_order.values() if order]


def _atom_order(g: JobGroup):
    """Canonical per-group atom iteration order.

    The manager builds ``g.atom_rates`` in ascending interned-id order, which
    makes every order-sensitive float accumulation below (allocation
    insertion order, hence ``alloc_rate`` summation order) deterministic and
    independent of frozenset hash order — the property the incremental
    replan engine and cross-process audit byte-identity both rely on.  Falls
    back to ``eligible_atoms`` for hand-built groups without rates."""
    return g.atom_rates if g.atom_rates else g.eligible_atoms


def intra_group_order(g: JobGroup, demand_key: DemandKeyFn):
    """Alg. 1 lines 2-3 for one group: smallest-(fairness-adjusted-)demand
    first.  Returns ``(jobs, keys)`` parallel lists."""
    # sort decorated tuples (job_id is unique, so the Job itself is never
    # compared) — identical order to key=(demand_key, job_id), but the
    # keys survive for the plan's audit surface
    keyed = sorted((demand_key(j), j.job_id, j) for j in g.pending_jobs())
    return [j for _, _, j in keyed], [k for k, _, _ in keyed]


def inter_group_allocate(active: Sequence[JobGroup],
                         queue_len: QueueLenFn) -> None:
    """Alg. 1 lines 4-17: initial scarcest-first atom claim + greedy
    pressure-driven reallocation.  Mutates ``g.allocation`` in place.

    Shared verbatim by the scalar :func:`venn_schedule` and the incremental
    :class:`repro_torch.accel.replan.ReplanEngine` (group counts are small; the
    job-dimension work is what the engine vectorizes), so the two paths are
    bit-identical here by construction."""
    # ---- initial allocation: scarcest group claims first -------------------
    # per-atom rate share: supply estimator stores rate per atom on the group
    # (all groups see the same per-atom rate; g.supply = Σ rates over atoms).
    claimed = set()
    by_scarcity = sorted(active, key=lambda g: (g.supply, g.requirement.name))
    for g in by_scarcity:
        alloc = {}
        for a in _atom_order(g):
            if a not in claimed:
                alloc[a] = g.atom_rate(a)
                claimed.add(a)
        g.allocation = alloc

    # ---- greedy inter-group reallocation -----------------------------------
    by_abundance = sorted(active, key=lambda g: (-g.supply, g.requirement.name))
    for gj in by_abundance:
        # |S'_j| may be 0 after initial allocation; ``_pressure`` treats a
        # zero-rate group with pending jobs as infinite pressure, so it wins
        # any intersected atoms from scarcer donors below.
        # candidate donors: scarcer groups with intersecting eligible sets,
        # visited from most abundant down ("take from relatively abundant
        # groups first").
        donors = [
            gk for gk in active
            if gk is not gj
            and gk.supply < gj.supply
            and not gk.eligible_atoms.isdisjoint(gj.eligible_atoms)
        ]
        donors.sort(key=lambda g: (-g.supply, g.requirement.name))
        for gk in donors:
            mj = queue_len(gj)
            mk = queue_len(gk)
            rj = _pressure(mj, gj.alloc_rate)
            rk = _pressure(mk, gk.alloc_rate)
            if rj > rk:
                shared = [a for a in _atom_order(gj) if a in gk.allocation]
                if not shared:
                    continue
                for a in shared:
                    gj.allocation[a] = gj.allocation.get(a, 0.0) + gk.allocation.pop(a)
            else:
                # if G_j wants more it must first have out-pressured the more
                # abundant donors; stop here (Alg. 1 line 17).
                break


def atom_priorities(active: Sequence[JobGroup]) -> Dict[AtomKey, List[JobGroup]]:
    """Per-atom assignment priority lists over the active groups' eligible
    union: owner first, then fallbacks scarcest-first so leftover devices
    keep serving the most constrained queues.  Shared by both replan paths."""
    universe: Dict[AtomKey, None] = {}
    for g in active:
        for a in _atom_order(g):
            universe.setdefault(a)
    out: Dict[AtomKey, List[JobGroup]] = {}
    for a in universe:
        owners = [g for g in active if a in g.allocation]
        fallbacks = [
            g for g in active
            if a in g.eligible_atoms and a not in g.allocation
        ]
        fallbacks.sort(key=lambda g: (g.supply, g.requirement.name))
        out[a] = owners + fallbacks
    return out


def venn_schedule(
    groups: Sequence[JobGroup],
    queue_len: QueueLenFn,
    demand_key: Optional[DemandKeyFn] = None,
) -> SchedulePlan:
    """Run Algorithm 1 over job groups whose ``eligible_atoms``, ``supply``
    and per-atom rates have been refreshed by the caller (manager)."""

    demand_key = demand_key or (lambda j: float(j.remaining_demand))
    active = [g for g in groups if g.pending_jobs()]
    plan = SchedulePlan(groups=list(groups))

    # ---- intra-group order (Alg. 1 lines 2-3) ------------------------------
    for g in active:
        jobs, keys = intra_group_order(g, demand_key)
        plan.job_order[g.requirement.name] = jobs
        plan.job_keys[g.requirement.name] = keys

    if not active:
        return plan

    inter_group_allocate(active, queue_len)
    plan.atom_priority = atom_priorities(active)
    return plan


def _pressure(queue: float, alloc_rate: float) -> float:
    """m'/|S'| with the empty-allocation convention: a group with pending jobs
    and zero allocated rate has infinite pressure; an idle group has none."""
    if queue <= 0:
        return 0.0
    if alloc_rate <= 0:
        return float("inf")
    return queue / alloc_rate
