#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (built for an H100).

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout, holds each
against its plain PyTorch version on the card, holds the device matcher
against the sequential oracle, and drives the resource manager's main path —
the check-in drain of ``Simulator(engine="array")`` under VENN-SCHED — at a
size its users would call real (``tenx_r500_j2000``: base rate 500, about 15
million check-ins in a quarter of a simulated day, 2000 jobs contending for
the scarce high-performance tier), asserting metrics identical to the
per-device loop.  It imports ``repro_torch`` only.

Output: one JSON object per line (``env``, ``kernel_checks``, ``matcher``,
``main_path``, ``dense_path``), the card's name and power limit, the
``kernels`` summary line, and as the last line
``{"ok": true, "device": {"platform": "gpu", ...}}``.  Any failure raises;
without a CUDA device the script exits non-zero before printing a result.

After each workload one more ``engine="array"`` run of it, at a tenth of its
horizon, goes under ``torch.profiler`` and prints a ``*_profile`` line: the
device's busy time and idle share over that drain, and the device time per
launch of the two hand-written kernels.  (A tenth, because the profiler's own
bookkeeping takes minutes per million recorded events; the share does not
depend on the horizon, every segment costs the same.)
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.stderr.write("chip_smoke: no CUDA device available\n")
    sys.exit(1)

from repro_torch.accel import replan as replan_mod
from repro_torch.accel.engine import match_chunk_seq, match_chunk_torch
from repro_torch.accel.kernels import build, replan_order, schedule_match
from repro_torch.accel.state import MatchState
from repro_torch.core import SCHEDULERS
from repro_torch.device import default_device
from repro_torch.sim import (JobTraceConfig, PopulationConfig, SimConfig,
                             generate_jobs)
from repro_torch.sim.devices import REQ_HIGHPERF
from repro_torch.sim.simulator import Simulator

# Published peaks of one H100 SXM: HBM bandwidth; and for the scalar f64 / i32
# compares of segmented_rank the f64 rate outside the tensor cores, 34 TFLOP/s
# (half the 67 TFLOP/s of f32), which counts a fused multiply-add as two: a
# compare is one instruction, so 17e12 of them a second.
PEAK_BYTES_PER_S = 3.35e12
PEAK_SCALAR_OPS_PER_S = 17e12

DEV = default_device()
T_START = time.perf_counter()


def emit(tag: str, obj: dict) -> None:
    print(json.dumps({tag: obj}), flush=True)


def time_ms(fn, reps: int = 50, batches: int = 5) -> float:
    """Median over ``batches`` of the mean time of ``reps`` back-to-back
    calls, by CUDA events, after a warm-up (inputs stay warm in L2, as they
    are for the real caller, which has just written them)."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(batches):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b) / reps)
    return statistics.median(out)


# --------------------------------------------------------------------------- #
# 1. env + build
# --------------------------------------------------------------------------- #

def phase_env() -> str:
    schedule_match.ensure_built()
    replan_order.ensure_built()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    nvcc = subprocess.run([build.find_nvcc(), "--version"],
                          capture_output=True, text=True, check=True).stdout
    release = [ln.strip() for ln in nvcc.splitlines() if "release" in ln]
    ptxas = [ln.strip() for ln in build.build_log.splitlines()
             if "registers" in ln or "Compiling entry" in ln]
    emit("env", {"torch": torch.__version__, "cuda": torch.version.cuda,
                 "nvcc": release[0] if release else nvcc.strip(),
                 "gpu": smi, "device_name": torch.cuda.get_device_name(0),
                 "build_seconds": build.build_seconds,
                 "ptxas": ptxas, "python": sys.version.split()[0]})
    return smi


# --------------------------------------------------------------------------- #
# 2. kernels vs their plain versions
# --------------------------------------------------------------------------- #

def _first_fit_inputs(n, K, R, rng, fill_frac=0.3):
    reqix = rng.integers(-1, R, size=(n, K)).astype(np.int32)
    elig = (rng.uniform(size=(n, K)) < 0.4) & (reqix >= 0)
    # a share of the requests fill somewhere inside the segment
    fill = np.where(rng.uniform(size=R) < fill_frac,
                    rng.integers(-1, n, size=R), n).astype(np.int32)
    pos = np.arange(n, dtype=np.int32)
    return tuple(torch.from_numpy(a).to(DEV) for a in (elig, reqix, fill, pos))


def _first_fit_bound(elig, reqix, fill, kidx):
    """Bytes this data needs.  The candidate axis is walked in groups of 32
    columns up to and including the group of the first fit: per row the mask
    bytes of those whole groups, the request index of every eligible column
    in them, pos, both outputs; the fill vector once."""
    n, K = reqix.shape
    groups = torch.clamp(kidx.long(), max=K - 1) // 32 + 1
    upto = torch.clamp(groups * 32, max=K)                          # columns
    cols = torch.arange(K, device=DEV)[None, :] < upto[:, None]
    n_elig = int((elig & cols).sum())
    nbytes = int(upto.sum()) * 1 + n_elig * 4 + fill.numel() * 4 \
        + n * 4 + 2 * n * 4
    return nbytes, nbytes / PEAK_BYTES_PER_S * 1e3


def check_first_fit(n, K, R, seed, timed):
    rng = np.random.default_rng(seed)
    elig, reqix, fill, pos = _first_fit_inputs(n, K, R, rng)
    kidx, choice = schedule_match.first_fit_choice(elig, reqix, fill, pos)
    torch.cuda.synchronize()
    kidx_p, choice_p = schedule_match.first_fit_choice_ref(
        elig, reqix, fill, pos)
    assert kidx.dtype == torch.int32 and choice.dtype == torch.int32
    assert torch.equal(kidx, kidx_p), ("first_fit_choice kidx", n, K, R)
    assert torch.equal(choice, choice_p), ("first_fit_choice choice", n, K, R)
    # the reference's (elig, fillcand, pos) contract, same kernel source
    fillcand = fill[reqix.clamp(min=0).long()].contiguous()
    got = schedule_match.masked_first_fit(elig, fillcand, pos)
    want = schedule_match.masked_first_fit_ref(elig, fillcand, pos)
    assert torch.equal(got, want), ("masked_first_fit", n, K)
    assert torch.equal(got, kidx), ("contract vs fused form", n, K)
    err = int((kidx.long() - kidx_p.long()).abs().max()) if n else 0
    row = {"n": n, "K": K, "R": R, "equal": True, "max_abs_err": err}
    if timed:
        nbytes, bound_ms = _first_fit_bound(elig, reqix, fill, kidx)
        row.update(
            ms=time_ms(lambda: schedule_match.first_fit_choice(
                elig, reqix, fill, pos)),
            plain_ms=time_ms(lambda: schedule_match.first_fit_choice_ref(
                elig, reqix, fill, pos)),
            contract_ms=time_ms(lambda: schedule_match.masked_first_fit(
                elig, fillcand, pos)),
            bound_ms=bound_ms, bound_bytes=nbytes, bound_by="bytes",
            library_ms=None)
    return row


def _rank_inputs(n, nseg, seed):
    rng = np.random.default_rng(seed)
    seg = np.sort(rng.integers(0, nseg, n)).astype(np.int32)
    # demand keys with exact ties and with pairs that collide only in f32
    base = rng.choice([0.5, 1.25, 2.0, 7.0, 1e6 / 3.0], size=n) \
        * rng.integers(1, 40, n)
    keys = base * (1.0 + rng.integers(0, 3, n) * 2.0 ** -40)
    ties = rng.permutation(n).astype(np.int32)
    return seg, keys, ties


def check_rank(n, nseg, seed, timed, f32_keys=False):
    seg, keys, ties = _rank_inputs(n, nseg, seed)
    if f32_keys:
        keys = keys.astype(np.float32).astype(np.float64)
    elif n > 64:
        assert len(np.unique(keys.astype(np.float32))) < len(np.unique(keys))
    d = [torch.from_numpy(a).to(DEV) for a in (seg, keys, ties)]
    rank = replan_order.segmented_rank(*d)
    torch.cuda.synchronize()
    rank_p = replan_order.segmented_rank_ref(*d)
    assert torch.equal(rank, rank_p), ("segmented_rank", n, nseg)
    perm = replan_order.segmented_order(*d).cpu().numpy()
    assert np.array_equal(perm, np.lexsort((ties, keys, seg))), \
        ("segmented_order vs lexsort", n, nseg)
    err = int((rank.long() - rank_p.long()).abs().max()) if n else 0
    row = {"n": n, "segments": nseg, "equal": True, "max_abs_err": err}
    if timed:
        counts = np.bincount(seg)
        same_pairs = int((counts.astype(np.int64) ** 2).sum())
        ops = n * n + 3 * same_pairs     # seg compare; +3 where it matches
        nbytes = n * (4 + 8 + 4) + n * 4
        t_ops = ops / PEAK_SCALAR_OPS_PER_S * 1e3
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        row.update(
            ms=time_ms(lambda: replan_order.segmented_rank(*d)),
            plain_ms=time_ms(lambda: replan_order.segmented_rank_ref(*d),
                             reps=10),
            order_ms=time_ms(lambda: replan_order.segmented_order(*d)),
            bound_ms=max(t_ops, t_bytes), bound_ops=ops, bound_bytes=nbytes,
            bound_by="operations" if t_ops >= t_bytes else "bytes",
            library_ms=None)
    return row


def phase_kernels():
    ff = [check_first_fit(16384, 32, 2048, 1, timed=True),
          check_first_fit(16384, 130, 2048, 2, timed=True),
          check_first_fit(48, 32, 2048, 3, timed=True)]
    for i, (n, K) in enumerate(((1, 1), (7, 3), (64, 5), (300, 17),
                                (1024, 130), (33, 33), (5, 64))):
        ff.append(check_first_fit(n, K, max(1, n // 2), 10 + i, timed=False))
    rk = [check_rank(2000, 1, 1, timed=True),
          check_rank(1024, 113, 2, timed=True)]
    for n in (1, 2, 7, 64, 200, 513, 1024):
        rk.append(check_rank(n, max(1, n // 9) + 1, 20 + n, timed=False,
                             f32_keys=True))
    emit("kernel_checks", {"masked_first_fit": ff, "segmented_rank": rk,
                           "tolerance": "exact (torch.equal); integer outputs",
                           "timing": "median of 5 batches of 50 launches, "
                                     "CUDA events, inputs warm in L2"})
    return ff, rk


# --------------------------------------------------------------------------- #
# 3. device matcher vs the sequential oracle
# --------------------------------------------------------------------------- #

class FakeReq:
    def __init__(self, demand, granted=0):
        self.demand, self.granted = demand, granted


class FakeSched:
    def __init__(self, slots):
        self._slots = slots

    def export_match_slots(self, limit=None):
        if limit is None:
            return self._slots
        return [s if s is None else s[:limit] for s in self._slots]


def _random_state(rng, kcap=8):
    A = int(rng.integers(1, 6))
    R = int(rng.integers(1, 8))
    reqs = [FakeReq(int(rng.integers(1, 6))) for _ in range(R)]
    slots = []
    for _ in range(A):
        if rng.uniform() < 0.1:
            slots.append(None)
            continue
        row = []
        for r in rng.permutation(R)[:int(rng.integers(0, R + 1))]:
            if rng.uniform() < 0.3:
                lo, hi = sorted(rng.uniform(0, 3, 2))
            else:
                lo, hi = -math.inf, math.inf
            row.append((reqs[int(r)], float(lo), float(hi)))
        slots.append(row)
    return MatchState.from_scheduler(FakeSched(slots), token=("t",),
                                     kcap=kcap, device=DEV)


def phase_matcher():
    checked = rounds = 0
    for seed in range(200):
        rng = np.random.default_rng(seed)
        state = _random_state(rng)
        cov = np.flatnonzero(state.covered)
        if len(cov) == 0:
            continue
        n = 1 + 7 * seed % 80
        aids = rng.choice(cov, size=n)
        speeds = rng.uniform(0, 3, size=n)
        want = match_chunk_seq(aids, speeds, state)
        got = match_chunk_torch(aids, speeds, state, DEV)
        assert got.choice.dtype == np.int64 and got.granted.dtype == np.bool_
        assert np.array_equal(got.choice, want.choice), ("choice", seed)
        assert np.array_equal(got.granted, want.granted), ("granted", seed)
        checked += 1
        rounds += got.rounds
    # one dense segment: 16384 rows, 64 atoms, K = 32, 2048 requests
    rng = np.random.default_rng(12345)
    reqs = [FakeReq(int(rng.integers(1, 24))) for _ in range(2048)]
    slots = []
    for _ in range(64):
        row = []
        for j, r in enumerate(rng.permutation(2048)[:32]):
            lo, hi = (sorted(rng.uniform(0, 3, 2)) if j < 4
                      and rng.uniform() < 0.5 else (-math.inf, math.inf))
            row.append((reqs[int(r)], float(lo), float(hi)))
        slots.append(row)
    state = MatchState.from_scheduler(FakeSched(slots), token=("d",),
                                      kcap=32, device=DEV)
    aids = rng.integers(0, 64, size=16384)
    speeds = rng.uniform(0, 3, size=16384)
    t0 = time.perf_counter()
    want = match_chunk_seq(aids, speeds, state)
    t_seq = time.perf_counter() - t0
    match_chunk_torch(aids, speeds, state, DEV)             # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = match_chunk_torch(aids, speeds, state, DEV)
    torch.cuda.synchronize()
    t_dev = time.perf_counter() - t0
    assert np.array_equal(got.choice, want.choice), "dense choice"
    assert np.array_equal(got.granted, want.granted), "dense granted"
    emit("matcher", {
        "random_states_checked": checked, "random_states_rounds": rounds,
        "dense": {"rows": 16384, "atoms": 64, "K": int(state.cand_req.shape[1]),
                  "requests": 2048, "granted": int(got.granted.sum()),
                  "rounds": got.rounds, "device_match_s": t_dev,
                  "sequential_oracle_s": t_seq},
        "equal_to_sequential_oracle": True})


# --------------------------------------------------------------------------- #
# 4./5. the main path, both drain engines
# --------------------------------------------------------------------------- #

def _tenx_jobs(seed: int = 1):
    """2000 jobs contending for the scarce high-performance tier."""
    jobs = generate_jobs(JobTraceConfig(num_jobs=2000, seed=seed,
                                        mean_interarrival=60.0))
    for j in jobs:
        j.requirement = REQ_HIGHPERF
    return jobs


def _profiled(run):
    """``run()`` under ``torch.profiler``: its result, and the device time by
    kernel (kernel and memcpy rows only — an operator's row would repeat the
    device time of the kernels it launched)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as tp:
        res = run()
        torch.cuda.synchronize()
    rows = [e for e in tp.key_averages() if e.device_type == DeviceType.CUDA]
    busy_s = sum(e.self_device_time_total for e in rows) / 1e6
    assert busy_s > 0, "the profiler saw no device time"
    top = sorted(rows, key=lambda e: -e.self_device_time_total)
    prof = {"device_busy_s": busy_s,
            "top_device_rows": [{"name": e.key[:80], "count": e.count,
                                 "device_s": e.self_device_time_total / 1e6}
                                for e in top[:12]]}
    for name in ("masked_first_fit", "segmented_rank"):
        mine = [e for e in rows if name in e.key]
        prof[name + "_device_us_per_launch"] = \
            sum(e.self_device_time_total for e in mine) \
            / sum(e.count for e in mine) if mine else None
    return res, prof


def _run(make_jobs, pop, max_time, engine, seed=1, profile=False):
    schedule_match.reset_launches()
    replan_order.reset_launches()
    replan_mod.order_fallbacks = 0
    sched = SCHEDULERS["venn"](seed=seed)
    sim = Simulator(make_jobs(), sched, pop, SimConfig(max_time=max_time),
                    engine=engine)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if profile:
        metrics, prof = _profiled(sim.run)
    else:
        metrics = sim.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {"masked_first_fit": schedule_match.launches,
              "segmented_rank": replan_order.launches}
    checkins = sim.checkins_seen + sim.checkins_skipped
    out = {"wall_s": wall, "drain_seconds": sim.drain_seconds,
           "stream_seconds": sim.stream_seconds,
           "checkin_loop_s": sim.drain_seconds - sim.stream_seconds,
           "checkins": checkins, "checkins_per_s_of_loop":
               checkins / max(sim.drain_seconds - sim.stream_seconds, 1e-9),
           "rounds_completed": len(metrics.rounds),
           "sched_invocations": sched.sched_invocations,
           "order_backend": sched._replan.order_backend
           if sched._replan is not None else None,
           "order_fallbacks": replan_mod.order_fallbacks,
           "launches": counts}
    eng = sim.engine
    if eng is not None:
        out.update(segments=eng.segments, matcher_calls=eng.matcher_calls,
                   matcher_rows=eng.matcher_rows,
                   fixedpoint_rounds=eng.fixedpoint_rounds,
                   matcher_s=eng.matcher_s, rebuild_s=eng.rebuild_s,
                   patch_s=eng.patch_s,
                   rebuilds=eng.rebuilds, patches=eng.patches,
                   expansions=eng.expansions, degraded=dict(eng.degraded),
                   kcap=eng.kcap, device=str(eng.device))
    if profile:
        out.update(prof, wall_s_under_profiler=out.pop("wall_s"),
                   device_idle_share_of_drain=
                   1.0 - prof["device_busy_s"] / sim.drain_seconds)
    return metrics, out


def _rounds_sig(m):
    return [(r.job_id, r.round_index, r.submit, r.alloc_complete, r.complete,
             r.demand, r.responses, r.failures, r.retries) for r in m.rounds]


PROFILE_HORIZON_SHARE = 0.1


def run_both(tag, make_jobs, pop, max_time, note):
    m_arr, arr = _run(make_jobs, pop, max_time, "array")
    m_py, py = _run(make_jobs, pop, max_time, "python")
    assert m_arr.jcts == m_py.jcts, f"{tag}: jcts differ between engines"
    assert _rounds_sig(m_arr) == _rounds_sig(m_py), f"{tag}: rounds differ"
    assert len(m_arr.rounds) > 0, f"{tag}: no round completed"
    assert all(math.isfinite(v) for v in m_arr.jcts.values()), tag
    assert arr["device"].startswith("cuda"), arr["device"]
    assert arr["launches"]["masked_first_fit"] > 0, f"{tag}: first-fit idle"
    assert arr["launches"]["segmented_rank"] > 0, f"{tag}: rank idle"
    assert arr["order_backend"] == "kernel"
    assert arr["degraded"]["exception"] == 0, arr["degraded"]
    assert arr["degraded"]["implausible"] == 0, arr["degraded"]
    assert arr["order_fallbacks"] == 0 and py["order_fallbacks"] == 0
    emit(tag, {"workload": note, "max_time_s": max_time,
               "metrics_identical": True, "array": arr, "python": py})
    _, prof = _run(make_jobs, pop, max_time * PROFILE_HORIZON_SHARE, "array",
                   profile=True)
    emit(tag + "_profile", {"max_time_s": max_time * PROFILE_HORIZON_SHARE,
                            "horizon_share": PROFILE_HORIZON_SHARE,
                            "array": prof})
    return arr, prof


def main() -> None:
    smi = phase_env()
    ff, rk = phase_kernels()
    phase_matcher()

    main_arr, main_prof = run_both(
        "main_path", _tenx_jobs,
        PopulationConfig(seed=1001, base_rate=500.0, cpu_med=1.8, mem_med=1.8),
        0.25 * 24 * 3600.0,
        "tenx_r500_j2000: base_rate 500, 2000 jobs on the high-performance "
        "tier, seed 1, 0.25 simulated days")
    run_both(
        "dense_path",
        lambda: generate_jobs(JobTraceConfig(num_jobs=200, seed=1)),
        PopulationConfig(seed=1001, base_rate=50.0),
        3.0 * 24 * 3600.0,
        "heavy_r50_j200: base_rate 50, 200 jobs, general requirement mix, "
        "seed 1, 3 simulated days (horizon cut from 30)")

    print(smi, flush=True)
    src = "src/repro_torch/accel/kernels/csrc/"
    kernels = [
        dict(name="masked_first_fit", route="cuda",
             source=src + "masked_first_fit.cu",
             replaces="src/repro/accel/kernels/schedule_match.py:66",
             launches=main_arr["launches"]["masked_first_fit"],
             max_abs_err=max(r["max_abs_err"] for r in ff),
             ms=ff[0]["ms"], plain_ms=ff[0]["plain_ms"],
             bound_ms=ff[0]["bound_ms"], bound_by=ff[0]["bound_by"],
             library_ms=None,
             main_path_device_us_per_launch=main_prof[
                 "masked_first_fit_device_us_per_launch"],
             shape="first_fit_choice n=16384 K=32 R=2048",
             other_shapes=[{k: r[k] for k in ("n", "K", "R", "ms", "plain_ms",
                                              "bound_ms")} for r in ff[1:3]]),
        dict(name="segmented_rank", route="cuda",
             source=src + "segmented_rank.cu",
             replaces="src/repro/accel/kernels/replan_order.py:68",
             launches=main_arr["launches"]["segmented_rank"],
             max_abs_err=max(r["max_abs_err"] for r in rk),
             ms=rk[0]["ms"], plain_ms=rk[0]["plain_ms"],
             bound_ms=rk[0]["bound_ms"], bound_by=rk[0]["bound_by"],
             library_ms=None,
             main_path_device_us_per_launch=main_prof[
                 "segmented_rank_device_us_per_launch"],
             shape="n=2000, one segment, f64 keys",
             other_shapes=[{k: rk[1][k] for k in ("n", "segments", "ms",
                                                  "plain_ms", "bound_ms")}]),
    ]
    for k in kernels:
        assert k["launches"] > 0 and k["max_abs_err"] == 0, k
    emit("total_seconds", time.perf_counter() - T_START)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
