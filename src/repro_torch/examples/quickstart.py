"""Quickstart (60s): Venn vs random matching on a shared device population.

Reproduces the paper's Figure 3 story at small scale: three jobs with
nested/overlapping device requirements compete for one check-in stream;
Venn's intersection-aware ordering finishes them sooner on average.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
import argparse

from ..core import SCHEDULERS
from ..device import resolve_device
from ..sim import (JobTraceConfig, PopulationConfig, SimConfig,
                   generate_jobs, run_workload)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="default cuda:0; 'cpu' for the host path")
    dev = resolve_device(ap.parse_args(argv).device)
    print("Venn quickstart: 12 collaborative-learning jobs, shared devices\n")
    results = {}
    for name in ("random", "fifo", "srsf", "venn"):
        jobs = generate_jobs(JobTraceConfig(num_jobs=12, seed=42))
        sched = SCHEDULERS[name](seed=42, device=dev) if name == "venn" \
            else SCHEDULERS[name](seed=42)
        m = run_workload(jobs, sched,
                         PopulationConfig(seed=7, base_rate=1.5),
                         SimConfig(max_time=14 * 24 * 3600),
                         engine="array", device=dev)
        results[name] = m
        print(f"{name:8s} avg JCT {m.avg_jct/3600:6.2f} h   "
              f"(scheduling delay {m.avg_scheduling_delay:6.0f} s, "
              f"response collection {m.avg_response_collection:5.0f} s)")
    base = results["random"].avg_jct
    print("\nspeedup vs random matching:")
    for name, m in results.items():
        print(f"  {name:8s} {base/m.avg_jct:.2f}x")
    assert results["venn"].avg_jct <= base, "Venn should beat random"
    print("\nOK — see repro_torch.benchmarks for the full Table 1-4 "
          "reproduction.")


if __name__ == "__main__":
    main()
