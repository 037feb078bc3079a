"""Benchmark suite driver: one module per paper table/figure.
Prints ``name,us_per_call,derived`` CSV (harness contract).

    python -m repro_torch.benchmarks.run [names] [--device cpu]

The reference's ``ALL`` in its order.  A failing entry prints its traceback
and the run exits 1.
"""
import argparse
import sys
import time
import traceback

from . import (bench_hotpath, bench_kernels, bench_scenarios, fig10_overhead,
               fig11_breakdown, fig12_numjobs, fig13_tiers, fig14_fairness,
               table1_workloads, table2_demand_percentiles,
               table3_resource_types, table4_biased)
from .common import device_arg
from ..device import resolve_device

ALL = [
    ("hotpath", bench_hotpath.main),
    ("scenarios", bench_scenarios.main),
    ("table1", table1_workloads.main),
    ("table2", table2_demand_percentiles.main),
    ("table3", table3_resource_types.main),
    ("table4", table4_biased.main),
    ("fig10", fig10_overhead.main),
    ("fig11", fig11_breakdown.main),
    ("fig12", fig12_numjobs.main),
    ("fig13", fig13_tiers.main),
    ("fig14", fig14_fairness.main),
    ("kernels", bench_kernels.main),
]


def main(argv=None) -> None:
    ap = device_arg(argparse.ArgumentParser())
    ap.add_argument("names", nargs="*")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    only = args.names or None
    print("name,us_per_call,derived")
    failures = []
    for name, fn in ALL:
        if only and name not in only:
            continue
        t0 = time.time()
        print(f"\n## {name}")
        try:
            fn(device=device)
        except Exception:                      # noqa: BLE001
            traceback.print_exc()
            failures.append(name)
        print(f"## {name} done in {time.time()-t0:.0f}s")
    if failures:
        print(f"\nFAILED: {failures}")
        sys.exit(1)
    print("\nall benchmarks completed")


if __name__ == '__main__':
    main()
