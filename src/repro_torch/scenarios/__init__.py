"""Scenario engine: declarative scenario registry + trace-replay device streams.

The evaluation surface of the repro: named, declarative workload/population
scenarios (``spec.py`` + ``library.py``), compiled into
:class:`~repro_torch.sim.devices.ChunkStream` device sources (``streams.py``),
recordable to / replayable from trace files in bounded memory
(``trace_io.py``), and executed across schedulers and seeds with a comparison
report (``runner.py``).  CLI: ``python -m repro_torch.scenarios run <name>``.
"""
from . import library  # noqa: F401  (registers the built-in scenarios)
from .runner import (RunResult, comparison_table, fast_scaled, run_one,
                     run_scenario)
from .spec import (CapacityDrift, FailureStorm, RateSpike, ScenarioSpec,
                   SpeedTail, TenantTier, all_scenarios, get_scenario,
                   register, scenario_names)
from .streams import ModulatedGenerator, build_jobs, build_stream
from .trace_io import RecordingStream, TraceReplayStream, record_stream

__all__ = [
    "CapacityDrift", "FailureStorm", "ModulatedGenerator", "RateSpike",
    "RecordingStream", "RunResult", "ScenarioSpec", "SpeedTail", "TenantTier",
    "TraceReplayStream", "all_scenarios", "build_jobs", "build_stream",
    "comparison_table", "fast_scaled", "get_scenario", "record_stream",
    "register", "run_one", "run_scenario", "scenario_names",
]
