"""The benchmark's harness: one run of one cell.

``BENCHMARK.json`` names the cells; each cell's file
(``perfbench/workloads/<cell>.json``) names its configuration
(``perfbench/configs/<config>.json``) and its traffic, whose driver is
``perfbench/traffic/<traffic>.py``; each per-layer metric is read by
``perfbench/metrics/<metric>.py``.  All are found by name, so a new cell,
configuration, traffic mix or metric is a new file.

A run: set-up (the traffic driver makes the cell's jobs and check-in
stream from the seed, builds the program and warms it), the measured
window, then, once the window has closed, the per-layer readings (traced
runs), the program's answers against the plain reference
(``perfbench/check.py``), and the result line (``run.py`` prints it once
it has seen that no JAX module was loaded).
"""
from __future__ import annotations

import gc
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
OUT = HERE / "_out"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# the scheduler settings that both the program (``program.Episode``) and
# the plain reference (``reference.sim.build``) read
SCHEDULER_KEYS = ("name", "num_tiers", "epsilon", "supply_window_s")


def load_json(*parts) -> dict:
    with open(HERE.joinpath(*parts)) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``perfbench/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = HERE / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_spec(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            spec = load_json("workloads", f"{name}.json")
            if spec["config"] != w["config"] or \
                    spec["traffic"] != w["traffic"]:
                raise ValueError(f"{name}: its file and BENCHMARK.json "
                                 "disagree on config or traffic")
            return spec
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def check_scheduler(cfg: dict) -> None:
    """Refuse a configuration whose ``scheduler`` states a setting that
    only one side would honour: a key other than ``SCHEDULER_KEYS``, one
    of them left out, or a scheduler other than VENN."""
    s = cfg["scheduler"]
    if set(s) != set(SCHEDULER_KEYS):
        raise ValueError(
            f"{cfg.get('name')}: the scheduler states {sorted(s)}; the "
            f"program and the reference read exactly {list(SCHEDULER_KEYS)}")
    if s["name"] != "venn":
        raise ValueError(f"{cfg.get('name')}: scheduler {s['name']!r}; the "
                         "reference replays VENN only")


def metrics_of(bench: dict, cell: str, group: str):
    """The metrics of ``group`` (``end_to_end`` / ``per_layer``) this cell
    reports: those that list it, or list no cells and move a metric the
    cell reports."""
    reported = {m["name"] for m in bench["end_to_end"]
                if cell in m.get("workloads", [cell])}
    out = []
    for m in bench[group]:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif group == "end_to_end" or m["moves"] in reported:
            out.append(m)
    return out


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def device_info(device) -> dict:
    import torch
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def breakdown(dev: dict) -> dict:
    ops = sorted(dev["kernels"].items(), key=lambda kv: -kv[1][1])[:10]
    gaps = sorted(dev["gap_names"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n[:120], s] for n, (_, s) in ops],
            "idle_gaps": [[n, s] for n, s in gaps]}


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             t_start: float, device=None, overrides=None) -> dict:
    """One run; returns the result line's object (``checks`` last) and,
    under ``"_log"``, what goes to standard error.  ``overrides`` (tests)
    updates the configuration's and the traffic's parameters."""
    import torch
    sys.path.insert(0, str(HERE))
    sys.path.insert(0, str(ROOT / "src"))
    import check
    from reference import sim as reference
    bench = load_json("..", "BENCHMARK.json")
    spec = cell_spec(bench, workload)
    cfg = load_json("configs", f"{spec['config']}.json")
    params = dict(spec.get("params", {}))
    if overrides:
        cfg.update(overrides.get("config", {}))
        params.update(overrides.get("params", {}))
    check_scheduler(cfg)
    device = torch.device("cuda", 0) if device is None else \
        torch.device(device)
    OUT.mkdir(exist_ok=True)
    driver = load_module("traffic", spec["traffic"])
    ctx = {"cfg": cfg, "params": params, "seed": seed, "seconds": seconds,
           "trace": trace, "device": device, "t_start": t_start,
           "trace_path": str(OUT / f"trace.{workload}.{os.getpid()}.json")}
    res = driver.drive(ctx)

    # ---- the window has closed
    dev = device_info(device)
    metrics = {}
    out = {}
    trace_log = None
    if trace:
        t_read = time.perf_counter()
        r = res["capture"].readings()
        dev["busy_s"] = r["device"]["busy_s"]
        dev["window_s"] = r["device"]["window_s"]
        for m in metrics_of(bench, workload, "per_layer"):
            v = load_module("metrics", m["name"]).read(r)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        out["breakdown"] = breakdown(r["device"])
        trace_log = (f"traced window {r['window_s']:.3f} s, profiler export "
                     f"{r['trace_export_s']:.3f} s, read "
                     f"{time.perf_counter() - t_read:.3f} s, host-device "
                     f"clock drift {r['device']['clock_drift_us']:.1f} us")
    else:
        for m in metrics_of(bench, workload, "end_to_end"):
            metrics[m["name"]] = {"value": res["e2e"][m["name"]],
                                  "unit": m["unit"]}
    answers = [ep.answers() for ep in res["episodes"]]
    stream, trace_arrays = res["stream"], res["jobs"]
    del res["episodes"], res["capture"]
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # ---- the reference replays the farthest episode once: every episode
    # of the window is the same computation over the same inputs
    t = time.perf_counter()
    until = max(a["until"] for a in answers)
    ref = reference.run(cfg, trace_arrays, stream, seed, res["horizon"],
                        until)
    numbers = check.total(check.compare(
        a, ref, stream.arrays["times"],
        [r["name"] for r in cfg["requirements"]]) for a in answers)
    ref_s = time.perf_counter() - t
    correct = check.verdict(numbers)
    failed = numbers["atom_mismatch"] + numbers["grant_mismatch"]
    log = res.get("log", []) + ([trace_log] if trace_log else []) + [
        f"window {res['window_s']:.3f} s, set-up {res['e2e']['setup_s']:.3f}"
        f" s; reference replay to {until:.0f} s of {res['horizon']:.0f}: "
        f"{ref_s:.3f} s, {len(answers)} episode(s), "
        f"{numbers['rounds_compared']} rounds compared"]
    checks = {k: {"value": numbers[k], "limit": lim}
              for k, lim in check.LIMITS.items()}
    for k in ("checkins_compared", "grants_compared"):
        checks[k] = {"value": numbers[k], "limit": "> 0"}
    log += [f"{k} {v['value']} limit {v['limit']}" for k, v in
            checks.items()]
    out = {"correct": bool(correct), "attempted": int(res["attempted"]),
           "failed": int(min(failed, res["attempted"])), "metrics": metrics,
           "device": dev, **out, "checks": checks, "_log": log}
    return out
