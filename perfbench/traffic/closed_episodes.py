"""Closed loop: the configuration's episode replayed back to back.

Set-up makes the cell's jobs and its whole check-in stream from the seed
(``perfbench/gen``), then warms the program on a prefix of the episode
(``warm_s`` simulated seconds: the CUDA context, the kernels' libraries,
the pinned stage, every path of the drain).  The window then replays the
episode through a new simulator each time, over the same arrays, as fast
as the program goes, in ``step_until`` slices of ``slice_s`` simulated
seconds, and ends at the first slice boundary after ``--seconds``: the
last episode is cut there.

End-to-end metric: ``checkins_per_s``, every check-in the program decided
in the window (examined, skipped or refused) over the window's whole wall
time.  Parameters: ``slice_s``, ``warm_s``.
"""
from __future__ import annotations

import contextlib
import gc
import time


def drive(ctx: dict) -> dict:
    import torch
    import program
    import tracing
    from gen import checkins as gen_checkins
    from gen import jobs as gen_jobs
    cfg, p, seed, dev = ctx["cfg"], ctx["params"], ctx["seed"], ctx["device"]
    horizon = float(cfg["horizon_s"])
    slice_s = float(p["slice_s"])
    jobs = gen_jobs.generate(cfg["jobs"], cfg["jobs"]["trace_seed"],
                             len(cfg["requirements"]))
    stream = gen_checkins.generate(cfg["population"], seed, horizon)
    mods = program.port()
    warm = program.Episode(mods, cfg, jobs, stream, seed, horizon, dev)
    t = 0.0
    while t < min(float(p["warm_s"]), horizon):
        t += slice_s
        warm.step_until(t)
    del warm
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - ctx["t_start"]

    episodes = []
    cap = tracing.Capture(ctx["trace_path"],
                          lambda: program.counters(episodes), dev) \
        if ctx["trace"] else None
    span = cap.span if cap is not None else \
        (lambda name: contextlib.nullcontext())
    if cap is not None:
        cap.start()
    w0 = time.perf_counter()
    end = w0 + ctx["seconds"]
    over = False
    before = 0                      # decided in the episodes before this
    marks = []                      # (wall, decided) at each slice's end
    while not over:
        with span("harness.new_episode"):
            ep = program.Episode(mods, cfg, jobs, stream, seed, horizon, dev)
        episodes.append(ep)
        if cap is not None:
            cap.watch(ep)
        t = 0.0
        done = False
        while not done:
            t = min(t + slice_s, horizon)
            with span("sim.step_until"):
                done = ep.step_until(t) or t >= horizon
            now = time.perf_counter()
            marks.append((now, before + ep.decided))
            if cap is not None and cap.due(now):
                cap.stop()
                if not cap.ok and end - now > tracing.TRACE_WINDOW_S + 1:
                    cap.start()
            if now >= end:
                over = True
                break
        before += ep.decided
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    window_s = time.perf_counter() - w0
    if cap is not None and cap.active:
        cap.stop()
    decided = sum(ep.decided for ep in episodes)
    return {"e2e": {"setup_s": setup_s,
                    "checkins_per_s": decided / window_s},
            "attempted": decided, "window_s": window_s,
            "log": [_per_second(w0, marks)],
            "episodes": episodes, "capture": cap, "stream": stream,
            "jobs": jobs, "horizon": horizon}


def _per_second(w0: float, marks) -> str:
    """Check-ins decided in each second of the window (millions)."""
    out, last, sec = [], 0, 1
    for t, n in marks:
        if t - w0 >= sec:
            out.append(f"{(n - last) / 1e6:.3f}")
            last, sec = n, sec + 1
    return "M check-ins a second of the window: " + " ".join(out)

