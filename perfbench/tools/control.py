"""The control of the comparison that decides ``correct``, at a cell's own
size: the reference itself, computed in float32 (every input and every
stored float rounded to float32), put in the program's place and held
against the float64 reference by ``perfbench/check.py``.  Not part of a
run; ``PERF.md`` gives its readings, from which the limits were set.

    python3 perfbench/tools/control.py --workload even.drain \
        --seeds 1,2,3

The span replayed is the one a run compares: a whole episode of the
closed-loop cell.  Prints one JSON line a seed.
"""
import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args()
    sys.path.insert(0, str(HERE))
    import check
    import harness
    from gen import checkins as gen_checkins
    from gen import jobs as gen_jobs
    from reference import sim as reference
    bench = harness.load_json("..", "BENCHMARK.json")
    spec = harness.cell_spec(bench, args.workload)
    cfg = harness.load_json("configs", f"{spec['config']}.json")
    names = [r["name"] for r in cfg["requirements"]]
    jobs = gen_jobs.generate(cfg["jobs"], cfg["jobs"]["trace_seed"],
                             len(names))
    for seed in [int(s) for s in args.seeds.split(",")]:
        horizon = until = float(cfg["horizon_s"])
        stream = gen_checkins.generate(cfg["population"], seed, horizon)
        out = {"seed": seed, "until": until}
        t = time.perf_counter()
        ref = reference.run(cfg, jobs, stream, seed, horizon, until)
        out["reference_s"] = time.perf_counter() - t
        t = time.perf_counter()
        low = reference.run(cfg, jobs, stream, seed, horizon, until,
                            precision="float32")
        out["control_s"] = time.perf_counter() - t
        # the control answers for the span it reached, as a run of the
        # program does: to its last job's completion
        reached = min(until, low["finished_at"] or until)
        got = check.compare(check.as_program(low, stream.arrays["times"],
                                             reached), ref,
                            stream.arrays["times"], names)
        out["reached"] = reached
        out.update(got, correct=check.verdict(got))
        print(json.dumps(out), flush=True)
        del ref, low, stream
    return 0


if __name__ == "__main__":
    sys.exit(main())
