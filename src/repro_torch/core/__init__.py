"""Venn core: the paper's contribution — IRS scheduling (Alg 1), tier-based
device matching (Alg 2), fairness knob, supply estimation, and baselines."""
from .baselines import BaseScheduler, FifoScheduler, RandomScheduler, SrsfScheduler
from .dispatch import DispatchTable, MISS, compile_plan
from .eligibility import EligibilityIndex
from .fairness import FairnessPolicy
from .irs import SchedulePlan, venn_schedule
from .manager import VennScheduler
from .matching import JobProfile, TierDecision, TierMatcher
from .supply import SupplyEstimator
from .types import Assignment, Device, Job, JobGroup, JobRequest, JobStatus, Requirement

SCHEDULERS = {
    "random": RandomScheduler,
    "fifo": FifoScheduler,
    "srsf": SrsfScheduler,
    "venn": VennScheduler,
}

__all__ = [
    "Assignment", "BaseScheduler", "Device", "DispatchTable", "EligibilityIndex",
    "FairnessPolicy", "FifoScheduler", "Job", "JobGroup", "JobProfile",
    "JobRequest", "JobStatus", "MISS", "RandomScheduler", "Requirement",
    "SCHEDULERS", "SchedulePlan", "SrsfScheduler", "SupplyEstimator",
    "TierDecision", "TierMatcher", "VennScheduler", "compile_plan", "venn_schedule",
]
