"""Scenario-engine smoke benchmark (the CLI's ``run --all --fast`` as a
``benchmarks/run.py`` target).

Runs every registered scenario at ``--fast`` sizing across venn + random and
emits one CSV row per scenario: wall-clock of the pair of runs and the
venn-vs-random JCT ratio.  Catches scenario-registry regressions (a scenario
that stops running) and gross slowdowns of the scenario compilation path.
The runs take the array drain on ``device`` (metrics identical to the
per-device loop).
"""
from __future__ import annotations

import time

from .common import cli, emit
from ..scenarios import all_scenarios, run_scenario


def main(device=None):
    for spec in all_scenarios():
        t0 = time.time()
        results = run_scenario(spec, scheds=("venn", "random"), seeds=(0,),
                               fast=True, engine="array", device=device)
        wall = time.time() - t0
        jct = {r.scheduler: r.metrics.avg_jct for r in results}
        unfinished = sum(r.metrics.unfinished for r in results)
        speedup = jct["random"] / jct["venn"] if jct.get("venn") else float("nan")
        emit(f"scenario_{spec.name}", wall * 1e6,
             f"venn_vs_random={speedup:.2f}x unfinished={unfinished}")


if __name__ == "__main__":
    cli(main)
