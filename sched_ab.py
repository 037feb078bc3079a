#!/usr/bin/env python3
"""The scheduler workloads of ``chip_smoke.py`` for several checkouts in
turns, on one card, in one process each:

    python3 sched_ab.py PARENT_ROOT . . PARENT_ROOT

For each root given (the root of a checkout that holds ``chip_smoke.py``
and ``src/``), in the order given, a child process builds that checkout's
kernels and runs its ``run_both`` on ``tenx_r500_j2000`` and
``heavy_r50_j200`` (array engine and per-device loop, metrics asserted
identical, then a profiled tenth of each horizon), printing that
checkout's JSON lines after a ``{"tree": ...}`` line.  Interleaving the
two checkouts (A B B A) lets host-clock drift show as the spread between
the two runs of one side.  Needs a CUDA device; exits non-zero if any run
fails.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

_CHILD = """
import sys, time
sys.path.insert(0, ".")
import chip_smoke as cs
from repro_torch.sim import JobTraceConfig, PopulationConfig, generate_jobs
cs.phase_env()
t0 = time.perf_counter()
cs.run_both("main_path", cs._tenx_jobs,
            PopulationConfig(seed=1001, base_rate=500.0, cpu_med=1.8,
                             mem_med=1.8),
            0.25 * 24 * 3600.0, "tenx_r500_j2000")
cs.run_both("dense_path",
            lambda: generate_jobs(JobTraceConfig(num_jobs=200, seed=1)),
            PopulationConfig(seed=1001, base_rate=50.0), 3.0 * 24 * 3600.0,
            "heavy_r50_j200")
cs.emit("workloads_seconds", time.perf_counter() - t0)
"""


def main() -> int:
    roots = sys.argv[1:]
    if not roots:
        print(__doc__, file=sys.stderr)
        return 2
    failed = 0
    for root in roots:
        print(json.dumps({"tree": root}), flush=True)
        rc = subprocess.run([sys.executable, "-c", _CHILD],
                            cwd=os.path.abspath(root)).returncode
        if rc:
            print(json.dumps({"tree_failed": root, "rc": rc}), flush=True)
            failed += 1
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
