"""Crash-consistent simulator snapshot/restore + a crash-restart loop.

The snapshot captures the *whole* simulator object graph — scheduler open
requests, supply rings, event heap, device-stream cursor, RNG states — with
one pickle, committed via the same atomic-rename discipline as
``ckpt/checkpoint.py``: write into ``.tmp-step_N/``, fsync, then
``os.replace`` into ``step_N/``.  A writer killed mid-snapshot leaves only a
``.tmp-step_*`` directory, which the next writer sweeps and readers ignore.

Restore is exact: everything the event loop consults is restored as data, so
resuming from step N and running to completion is bit-identical to the
crash-free run (drift bound: zero).  Only derived accelerator caches are
dropped and rebuilt by the normal lazy paths: ``ArrayMatchEngine`` pickles
with ``state=None`` (the mirror, on the engine's device — a CUDA card
included) and without its uploaded chunk, so the next ``prepare`` rebuilds
the mirror and segments upload their rows until the next chunk is bound;
``VennScheduler`` pickles without its replan engine, which the next replan
rebuilds.  The kernel libraries and the pinned transfer stages are
per-process caches and never part of the graph, so a snapshot holds no
device tensor.  ``sim._after_restore()`` invalidates the mirror and bumps
the recovery counter.

No torch, no Simulator import — everything is duck-typed so this module
stays importable in minimal environments.
"""
from __future__ import annotations

import json
import os
import pickle
import shutil
import tempfile
from typing import Callable, Iterable, Optional

from ..obs import trace as _obstrace   # pure stdlib — keeps this module
#                                        importable in minimal environments

_MANIFEST_FORMAT = "venn-sim-snapshot"


def _step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:08d}")


def _sweep_stale_tmp(ckpt_dir: str, keep: Optional[str] = None) -> int:
    """Remove ``.tmp-step_*`` leftovers from a killed writer."""
    swept = 0
    try:
        entries = os.listdir(ckpt_dir)
    except FileNotFoundError:
        return 0
    for name in entries:
        if not name.startswith(".tmp-step_"):
            continue
        path = os.path.join(ckpt_dir, name)
        if keep is not None and os.path.abspath(path) == os.path.abspath(keep):
            continue
        shutil.rmtree(path, ignore_errors=True)
        swept += 1
    return swept


def snapshot_simulator(sim, ckpt_dir: str, step: int) -> str:
    """Atomically persist ``sim`` under ``ckpt_dir/step_{step:08d}``.

    Returns the committed directory path.  Safe against a writer killed at
    any point: the final directory either fully exists or doesn't.
    """
    tr = _obstrace.TRACER
    tok = tr.begin("ckpt.snapshot", cat="ckpt", step=step) \
        if tr.enabled else None
    os.makedirs(ckpt_dir, exist_ok=True)
    _sweep_stale_tmp(ckpt_dir)
    blob = pickle.dumps(sim, protocol=pickle.HIGHEST_PROTOCOL)
    tmp = os.path.join(ckpt_dir, f".tmp-step_{step:08d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    with open(os.path.join(tmp, "state.pkl"), "wb") as f:
        f.write(blob)
        f.flush()
        os.fsync(f.fileno())
    manifest = {
        "format": _MANIFEST_FORMAT,
        "version": 1,
        "step": step,
        "now": float(getattr(sim, "now", 0.0)),
        "done": int(getattr(sim, "_done", 0)),
        "engine": type(getattr(sim, "engine", None)).__name__
        if getattr(sim, "engine", None) is not None else "python",
        "n_jobs": len(getattr(sim, "jobs", ())),
        "bytes": len(blob),
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2)
        f.flush()
        os.fsync(f.fileno())
    final = _step_dir(ckpt_dir, step)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    if tok is not None:
        tr.end(tok, bytes=len(blob))
    return final


def latest_snapshot_step(ckpt_dir: str) -> Optional[int]:
    try:
        entries = os.listdir(ckpt_dir)
    except FileNotFoundError:
        return None
    steps = []
    for name in entries:
        if not name.startswith("step_"):
            continue
        try:
            steps.append(int(name.split("_", 1)[1]))
        except (IndexError, ValueError):
            continue
    return max(steps) if steps else None


def restore_simulator(ckpt_dir: str, step: Optional[int] = None):
    """Load the simulator persisted at ``step`` (default: latest).

    Raises ``ValueError`` with context on a missing/foreign checkpoint, and
    calls ``sim._after_restore()`` so derived accelerator state is rebuilt
    and the recovery counter bumped.
    """
    if step is None:
        step = latest_snapshot_step(ckpt_dir)
        if step is None:
            raise ValueError(f"no snapshot found under {ckpt_dir!r}")
    tr = _obstrace.TRACER
    tok = tr.begin("ckpt.restore", cat="ckpt", step=step) \
        if tr.enabled else None
    final = _step_dir(ckpt_dir, step)
    manifest_path = os.path.join(final, "manifest.json")
    try:
        with open(manifest_path) as f:
            manifest = json.load(f)
    except FileNotFoundError:
        raise ValueError(
            f"snapshot step {step} under {ckpt_dir!r} has no manifest "
            f"({manifest_path})")
    except json.JSONDecodeError as e:
        raise ValueError(f"snapshot manifest {manifest_path} is corrupt: {e}")
    if manifest.get("format") != _MANIFEST_FORMAT:
        raise ValueError(
            f"{manifest_path}: format {manifest.get('format')!r} is not a "
            f"{_MANIFEST_FORMAT!r} checkpoint")
    with open(os.path.join(final, "state.pkl"), "rb") as f:
        sim = pickle.load(f)
    after = getattr(sim, "_after_restore", None)
    if after is not None:
        after()
    if tok is not None:
        tr.end(tok, bytes=manifest.get("bytes", 0))
    return sim


def run_with_crashes(make_sim: Callable[[], "object"],
                     crash_times: Iterable[float],
                     ckpt_dir: Optional[str] = None,
                     snapshot_lag: float = 0.0):
    """Run a simulator to completion while crashing it at ``crash_times``.

    For each crash time ``t`` the loop snapshots at ``t - snapshot_lag``
    (work done in the lag window is lost with the crashed process and
    deterministically re-executed after restore — the crash-consistency
    property under test), advances to ``t``, discards the live simulator,
    and restores from the snapshot.  Returns the finished ``SimMetrics``.
    """
    owns_dir = ckpt_dir is None
    if owns_dir:
        ckpt_dir = tempfile.mkdtemp(prefix="venn-crash-")
    try:
        sim = make_sim()
        sim.start()
        step = 0
        for t in sorted(float(t) for t in crash_times):
            snap_t = max(0.0, t - snapshot_lag)
            if sim.step_until(snap_t):
                break
            snapshot_simulator(sim, ckpt_dir, step)
            if sim.step_until(t):
                break
            # -- crash: the live process dies here --
            sim = restore_simulator(ckpt_dir, step)
            step += 1
        return sim.finish()
    finally:
        if owns_dir:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
