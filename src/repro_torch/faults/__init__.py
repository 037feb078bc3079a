"""Fault injection + crash-consistent recovery for the Venn simulator.

The fault taxonomy is :mod:`.plan`'s dataclasses, composed onto a stream by
:mod:`.injector`; :mod:`.recovery` snapshots and restores whole simulators,
and its drift bound is zero — restore is bit-exact.
"""
from .plan import (Blackout, ChunkChaos, ClockSkew, FaultPlan, FlakyIngest)
from .injector import FaultInjector, inject
from .recovery import (latest_snapshot_step, restore_simulator,
                       run_with_crashes, snapshot_simulator)

__all__ = [
    "Blackout",
    "ChunkChaos",
    "ClockSkew",
    "FaultPlan",
    "FlakyIngest",
    "FaultInjector",
    "inject",
    "snapshot_simulator",
    "restore_simulator",
    "latest_snapshot_step",
    "run_with_crashes",
]
