"""Event-driven simulation of multi-job collaborative learning (§5.1 testbed)."""
from .devices import (CHUNK_SECONDS, ChunkStream, DeviceChunk, DeviceGenerator,
                      GeneratorStream, PopulationConfig,
                      REQ_COMPUTE, REQ_GENERAL, REQ_HIGHPERF, REQ_MEMORY,
                      REQUIREMENT_CLASSES)
from .metrics import RoundRecord, SimMetrics
from .simulator import SimConfig, Simulator, run_workload
from .traces import BIASED, JobTraceConfig, WORKLOADS, generate_jobs, workload_variants

__all__ = [
    "BIASED", "CHUNK_SECONDS", "ChunkStream", "DeviceChunk", "DeviceGenerator",
    "GeneratorStream", "JobTraceConfig", "PopulationConfig",
    "REQ_COMPUTE", "REQ_GENERAL", "REQ_HIGHPERF", "REQ_MEMORY",
    "REQUIREMENT_CLASSES", "RoundRecord", "SimConfig", "SimMetrics",
    "Simulator", "WORKLOADS", "generate_jobs", "run_workload", "workload_variants",
]
