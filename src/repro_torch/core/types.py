"""Domain types for the Venn resource manager.

The control-plane vocabulary of the paper (§3, §4.1):

* a **Device** checks in, carries a capability vector and a speed factor;
* a **Requirement** is a job's device specification (predicate over capability);
* an **Atom** is an equivalence class of devices w.r.t. the set of requirements
  they satisfy — the intersection structure of the IRS problem is a set system
  over atoms (eligible sets can be inclusive / overlapping / nested);
* a **Job** issues one **JobRequest** per training round (demand ``D_i``);
* a **JobGroup** collects jobs with identical requirements (resource-homogeneous
  job groups, §4.2).
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from enum import Enum
from typing import Callable, Dict, FrozenSet, List, Optional, Tuple

# --------------------------------------------------------------------------- #
# Devices
# --------------------------------------------------------------------------- #

_device_ids = itertools.count()


@dataclass(slots=True)
class Device:
    """An ephemeral edge device that has just checked in.

    On the vectorized fast path devices live as struct-of-arrays chunks and a
    ``Device`` object is only materialized for *granted* check-ins; ``atom``
    (frozenset key) and ``atom_id`` (dense interned id) are filled in by the
    eligibility index."""

    caps: Dict[str, float]              # e.g. {"cpu": 4.0, "mem": 6.0} (GHz, GB)
    speed: float = 1.0                  # relative task-execution speed (1.0 = ref)
    checkin_time: float = 0.0
    dev_id: int = field(default_factory=_device_ids.__next__)
    atom: Optional[FrozenSet[str]] = None   # filled in by the eligibility index
    atom_id: Optional[int] = None           # dense interned id of ``atom``

    def __hash__(self) -> int:
        return self.dev_id


# --------------------------------------------------------------------------- #
# Requirements (device specifications)
# --------------------------------------------------------------------------- #

@dataclass(frozen=True)
class Requirement:
    """A job's device specification: minimum capability thresholds.

    Two requirements with equal ``mins`` define the same eligible set, hence
    the same job group.  The name is only for reporting.
    """

    name: str
    mins: Tuple[Tuple[str, float], ...] = ()     # sorted ((cap, min_value), ...)

    @staticmethod
    def of(name: str, **mins: float) -> "Requirement":
        return Requirement(name, tuple(sorted(mins.items())))

    def matches(self, device: Device) -> bool:
        return all(device.caps.get(cap, 0.0) >= lo for cap, lo in self.mins)

    def subsumes(self, other: "Requirement") -> bool:
        """True if every device eligible to ``other`` is eligible to ``self``
        (i.e. self's thresholds are all <= other's)."""
        mine = dict(self.mins)
        theirs = dict(other.mins)
        return all(mine.get(cap, 0.0) <= lo for cap, lo in theirs.items()) and all(
            lo <= theirs.get(cap, float("inf")) for cap, lo in self.mins
        )


# --------------------------------------------------------------------------- #
# Jobs and round requests
# --------------------------------------------------------------------------- #

class JobStatus(Enum):
    PENDING = "pending"        # arrived, no outstanding request
    WAITING = "waiting"        # request submitted, acquiring devices
    COLLECTING = "collecting"  # demand met, waiting for responses
    DONE = "done"


@dataclass(eq=False)
class JobRequest:
    """One round's resource request (demand + spec), the schedulable unit.

    Identity semantics (``eq=False``): a request is the same request only if
    it is the same object — the schedulers' ``pending`` lists and the
    simulator's stale-entry checks all mean identity, and dataclass
    field-wise ``__eq__`` made every ``list.remove`` a deep compare."""

    job: "Job"
    round_index: int
    demand: int
    submit_time: float
    granted: int = 0                   # devices handed out so far
    responses: int = 0                 # successful responses received
    failures: int = 0
    quorum: int = 0                    # responses needed (simulator fills in)
    alloc_complete_time: Optional[float] = None
    complete_time: Optional[float] = None
    aborted: int = 0                   # times this round has been aborted/retried
    # --- simulator-internal response buffer (sim/simulator.py) ---
    # granted devices' responses wait here as data, delivered when something
    # reads them; the simulator's event heap holds at most ONE entry per
    # request, at the response that completes its round (``resp_t``)
    resp_buf: Optional[List[tuple]] = field(default=None, repr=False)
    resp_new: Optional[List[tuple]] = field(default=None, repr=False)
    # the time of each entry the one-event-a-response model armed
    resp_armed: Optional[List[float]] = field(default=None, repr=False)
    resp_t: float = float("inf")       # completing response's time (inf = none)
    resp_ties: int = 0                 # of those entries, the ones at the
    #                                    deadline's time armed before the fill

    @property
    def remaining(self) -> int:
        d = self.demand - self.granted
        return d if d > 0 else 0

    @property
    def requirement(self) -> Requirement:
        return self.job.requirement


@dataclass(eq=False)
class Job:
    """A synchronous collaborative-learning job (a sequence of rounds).

    Identity semantics (``eq=False``), consistent with the job_id ``__hash__``
    below: group membership tests are identity tests, not deep compares."""

    job_id: int
    requirement: Requirement
    demand_per_round: int
    total_rounds: int
    arrival_time: float
    # --- FL execution profile (used by the simulator's data plane) ---
    task_time_mean: float = 60.0       # seconds on a speed-1.0 device
    task_time_sigma: float = 0.35      # log-normal sigma of response time
    quorum_fraction: float = 0.8       # fraction of demand that must report back
    deadline: float = 600.0            # response deadline (5-15 min per paper)
    overcommit: float = 1.0            # job-chosen overcommit factor (§3: fault
    #                                    tolerance is delegated to jobs)
    # --- multi-tenant tags (scenario engine: priority-tiered tenants) ---
    priority: float = 1.0              # scheduling weight (1.0 = neutral; higher
    #                                    priorities shrink the effective demand
    #                                    key, serving the job earlier in-group)
    tenant: str = "default"            # owning tenant, for per-tier reporting
    # --- bookkeeping ---
    status: JobStatus = JobStatus.PENDING
    rounds_done: int = 0
    current: Optional[JobRequest] = None
    completion_time: Optional[float] = None
    attained_service: float = 0.0      # Σ served time (fairness knob input, §4.4)
    first_service_time: Optional[float] = None
    tier_profile: Optional[List[float]] = None   # capacity samples from past rounds

    def __hash__(self) -> int:
        return self.job_id

    @property
    def remaining_demand(self) -> int:
        """Remaining demand of the *current request* (§4.2.1 default)."""
        r = self.current
        if r is not None:
            d = r.demand - r.granted
            return d if d > 0 else 0
        return self.demand_per_round

    @property
    def remaining_rounds(self) -> int:
        return max(0, self.total_rounds - self.rounds_done)

    def jct(self) -> Optional[float]:
        if self.completion_time is None:
            return None
        return self.completion_time - self.arrival_time


# --------------------------------------------------------------------------- #
# Job groups (resource-homogeneous, §4.2)
# --------------------------------------------------------------------------- #

@dataclass
class JobGroup:
    """All jobs sharing one requirement; `eligible_atoms`/`supply` are filled
    in by the eligibility index + supply estimator."""

    requirement: Requirement
    jobs: List[Job] = field(default_factory=list)
    eligible_atoms: FrozenSet[FrozenSet[str]] = frozenset()
    supply: float = 0.0                # |S_j|: eligible-device rate (devices/s)
    atom_rates: Dict[FrozenSet[str], float] = field(default_factory=dict)
    allocation: Dict[FrozenSet[str], float] = field(default_factory=dict)
    # `allocation` is S'_j: atom -> rate share owned by this group.

    def atom_rate(self, atom: FrozenSet[str]) -> float:
        return self.atom_rates.get(atom, 0.0)

    @property
    def queue_len(self) -> int:
        return len([j for j in self.jobs if j.current is not None])

    @property
    def alloc_rate(self) -> float:
        return sum(self.allocation.values())

    def pending_jobs(self) -> List[Job]:
        # hot on every replan (called a few times over every job in the
        # group): inline the request-remaining check
        return [j for j in self.jobs
                if (r := j.current) is not None and r.demand > r.granted]


# --------------------------------------------------------------------------- #
# Assignment result
# --------------------------------------------------------------------------- #

@dataclass(frozen=True)
class Assignment:
    device: Device
    request: JobRequest
    time: float


EligibilityFn = Callable[[Device], bool]
