"""Run one cell of the benchmark and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout.  The cells are ``BENCHMARK.json``'s
``workloads``.  The last line of standard output is one JSON object
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``: each number compared with
its limit, also the last lines of standard error).  Without a CUDA device
it exits with code 2 and prints no result.
"""
import os
import sys
import time

# One string-hash seed for every run: the port's speed depends on its dict
# and set layouts (frozenset atom keys, requirement names) by up to a
# quarter from one process to the next on one input (PERF.md §6), so
# the run re-executes itself under PYTHONHASHSEED=0, its start time passed
# on (perf_counter is the system's monotonic clock).
if os.environ.get("PYTHONHASHSEED") != "0":
    os.environ["PERFBENCH_START"] = repr(time.perf_counter())
    os.environ["PYTHONHASHSEED"] = "0"
    os.execv(sys.executable, [sys.executable] + sys.argv)
T_START = float(os.environ.pop("PERFBENCH_START", time.perf_counter()))

import argparse  # noqa: E402
import json  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()
    # every cache the run could write stays inside the checkout, at fixed
    # paths; one host thread a library, for steady host timings
    out = HERE / "_out"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(out / sub)
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ.setdefault(var, "1")
    with open(HERE.parent / "BENCHMARK.json") as f:
        cells = {w["name"]: w for w in json.load(f)["workloads"]}
    if args.workload not in cells:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    import torch
    n_chips = cells[args.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < n_chips:
        print("no CUDA device: the benchmark runs on the card only",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    import harness
    res = harness.run_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace), T_START)
    found = harness.forbidden_modules()
    if found:
        print("JAX or the JAX package was loaded: " + ", ".join(found),
              file=sys.stderr)
        return 3
    for line in res.pop("_log"):
        print(line, file=sys.stderr, flush=True)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
