"""Tour of the scenario engine: declarative scenarios, trace record/replay,
and the scheduler flight recorder.

Runs two contrasting scenarios across venn + random, prints the comparison
tables, records one run's device stream to a trace file and replays it
bit-identically, then walks through explaining one scheduling decision from
an audit stream.

Every run takes the array drain on ``--device`` (default ``cuda:0``):
its check-ins matched by ``match_segment``, VENN's resorts by
``segmented_order``.

    PYTHONPATH=src python -m repro_torch.examples.scenario_tour [--device cpu]
"""
import argparse
import os
import tempfile

from ..device import resolve_device
from ..obs.audit import read_audit
from ..obs.contention import explain_job, pressure_timelines
from ..scenarios import (comparison_table, fast_scaled, get_scenario,
                         run_one, run_scenario, scenario_names)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="default cuda:0; 'cpu' for the host path")
    dev = resolve_device(ap.parse_args(argv).device)
    print("registered scenarios:", ", ".join(scenario_names()))

    for name in ("flash_crowd", "priority_tenants"):
        spec = fast_scaled(get_scenario(name))
        results = run_scenario(spec, scheds=("venn", "random"), seeds=(0,),
                               engine="array", device=dev)
        print(f"\n== {spec.name} ==  {spec.description}")
        print(comparison_table(results))

    # --- record a synthetic run, then replay it from the trace file -------
    spec = fast_scaled(get_scenario("churn_storm"))
    with tempfile.NamedTemporaryFile(suffix=".csv", delete=False) as f:
        trace = f.name
    try:
        rec = run_one(spec, "venn", seed=0, record=trace, engine="array",
                      device=dev)
        rep = run_one(spec, "venn", seed=0, replay=trace, engine="array",
                      device=dev)
        print(f"\nrecorded {os.path.getsize(trace)} bytes to {trace}")
        print("replay bit-identical:",
              rec.metrics.jcts == rep.metrics.jcts
              and rec.metrics.rounds == rep.metrics.rounds)
    finally:
        os.unlink(trace)

    # --- before/after: the incremental replan engine ----------------------
    # The same scenario under both replan backends: "scalar" pins the
    # reference venn_schedule + compile_plan pair, "array" is the
    # incremental ReplanEngine (dirty-set deltas over maintained key
    # arrays).  Metrics are bit-identical by contract; the venn.replan.*
    # sub-spans show where the time went.  The same table comes from any
    # run via --trace-out T.json + `python -m repro_torch.obs summarize T.json`
    # (self-time sorted, so venn.replan doesn't double-count its phases).
    from .. import obs
    from ..obs.summarize import span_stats

    spec = fast_scaled(get_scenario("churn_storm"))
    stats, mets = {}, {}
    for mode in ("scalar", "array"):
        os.environ["REPRO_REPLAN"] = mode
        try:
            with obs.session(tracing=True, categories={"sched"}) as (tr, _):
                mets[mode] = run_one(spec, "venn", seed=0,
                                     engine="array", device=dev).metrics
                stats[mode] = span_stats(tr.events)
        finally:
            del os.environ["REPRO_REPLAN"]
    print("\n== replan cost, scalar reference vs incremental engine ==")
    print(f"{'span':<24} {'scalar':>12} {'array':>12}")
    names = ["venn.replan", "venn.replan.supply", "venn.replan.irs",
             "venn.replan.tiers", "venn.replan.compile"]
    for name in names:
        cols = []
        for mode in ("scalar", "array"):
            st = stats[mode].get(name)
            cols.append(f"{st['total_us'] / 1e3:.1f}ms" if st else "-")
        print(f"{name:<24} {cols[0]:>12} {cols[1]:>12}")
    print("metrics bit-identical across backends:",
          mets["scalar"].jcts == mets["array"].jcts
          and mets["scalar"].rounds == mets["array"].rounds)

    # --- explain a scheduling decision from the flight recorder -----------
    # The audit stream answers "why did job J wait?" after the fact: its
    # queue-position history names the exact contending jobs ahead of it
    # (with the fairness keys that ordered them), and its sampled grant rows
    # show which dispatch-table slot won each round's opening check-in.
    spec = fast_scaled(get_scenario("priority_tenants"))
    with tempfile.NamedTemporaryFile(suffix=".jsonl", delete=False) as f:
        audit = f.name
    try:
        run_scenario(spec, scheds=("venn",), seeds=(0,), audit_out=audit,
                     engine="array", device=dev)
        recs = read_audit(audit)
        # pick a job that actually queued behind someone
        jid = next((r["job"] for r in recs
                    if r["kind"] == "queue_pos" and r["pos"] > 0),
                   next(r["job"] for r in recs if r["kind"] == "queue_pos"))
        print(f"\n== explain job {jid} (from {len(recs)} audit records) ==")
        print(explain_job(recs, jid))
        print("\n== per-atom pressure (queued demand / supply rate) ==")
        print(pressure_timelines(recs, top=4))
        print("\n(same reports from the CLI: python -m repro_torch.obs audit "
              f"A.jsonl --job {jid}  /  python -m repro_torch.obs contention "
              "A.jsonl)")
    finally:
        os.unlink(audit)


if __name__ == "__main__":
    main()
