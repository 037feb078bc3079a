#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (built for an H100).

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout, holds each
against its plain PyTorch version on the card, holds the device matcher — one
launch of ``match_segment`` a call, the whole fill-position fixed point of a
segment, on one CTA or (above ``GRID_ROWS`` rows) on a cooperative grid, both
routes timed side by side at six sizes — against the plain program (choice,
granted and round count, bit for bit) and the sequential oracle, and drives
the resource manager's main path —
the check-in drain of ``Simulator(engine="array")`` under VENN-SCHED — at a
size its users would call real (``tenx_r500_j2000``: base rate 500, about 15
million check-ins in a quarter of a simulated day, 2000 jobs contending for
the scarce high-performance tier), asserting metrics identical to the
per-device loop. Then the scenario registry (``scenarios``): all eleven
registered scenarios at their library size (one simulated week, 24 jobs,
0.3-0.5 million check-ins each) through ``repro_torch.scenarios.run_one``
under VENN on both drain engines, metrics identical between them, one
``match_segment`` launch a matcher call and one ``segmented_order`` launch a
resort, ``flaky_ingest``'s non-finite speeds the only degradation; a recorded
``flash_crowd`` stream replayed to the same metrics; the audit stream of two
scenarios byte-identical between the engines; ``blackout_storm`` crashed
three times and restored from snapshots to the crash-free metrics; and
``python -m repro_torch.scenarios run`` in a child process with no device
flag. Then the server half of a federated round: the three
federated-learning kernels (``fedavg_reduce``, ``quantize``, ``dequantize``)
against their plain versions at llama3.2-1b's largest leaf
(``fl_kernel_checks``), and two rounds of three jobs under one Venn scheduler,
job 0 llama3.2-1b at full width (1 235 814 400 parameters): each granted
client's local update (``make_local_update``: two SGD steps on its Dirichlet
data shard, attention in the flash kernel) compressed to int8 and back,
aggregated and applied by FedAdam (``fl_round``). Then serving: the two
flash-attention kernels — the tensor-core one (``wgmma``, bf16) and the FMA
one (f32), each row naming its route — against their plain version at the
reference's test shapes, ragged lengths, a query offset and the serve shape,
where the tensor-core kernel, the FMA kernel on the same inputs, the plain
version and SDPA are timed in turns (``flash_kernel_checks``); and
llama3.2-1b at full width serving four prompts of 1024 tokens for 32 new
tokens through ``Engine.generate``, its prefill's attention in the
tensor-core kernel, checked against a prefill on the plain version and
against full re-forwards (``serve``); then the five configurations of the
MoE, MLA, Mamba-2, hybrid and cross-attention families at published width
(mamba2-1.3b and llama-3.2-vision-11b's text decoder whole, mixtral-8x22b
and deepseek-v3-671b at two layers, jamba-v0.1-52b at one period of
eight), each served the same way one at a time, its prefill through the
kernel held against the plain route where it launches the kernel and its
cached decode against full re-forwards in f32 (``serve_families``). Then
training: the
gradient through the flash kernel (``FlashAttentionFn``: the kernel's
forward, a plain recompute for its backward) against autograd through the
plain version, alone at the serve shape and as every gradient leaf of
llama3.2-1b at full width (bf16, 16 layers; f32, 2 layers) and of one
period of llama-3.2-vision-11b (its cross-attention on the bidirectional
T 1024 × S 1601 shape), with the bare wrapper's missing gradient shown
(``train_checks``); ``python -m
repro_torch.launch.train`` for llama3.2-1b at full width, 4 × 1024 tokens a
step, 6 AdamW steps, one step more profiled, then a checkpoint and resume at
smoke size (``train``); and the trainer for the whole mamba2-1.3b, 6 steps,
with its first step's gradient norms and a profiled step
(``train_families``). Then the launch layer (``launch``): (b) the dry-run's
predictions against the card at three shapes the earlier phases run
(llama3.2-1b and mamba2-1.3b training at 4 × 1024 tokens, llama3.2-1b's
prefill of 4 × 1024): ``dryrun.run_shape``, launching no kernel, then one
real step, predicted / measured peak memory within 0.8-1.25, the roofline
step beside the measured one, the counted FLOPs beside ``6·N·D``; (c)
``python -m repro_torch.launch.elastic --arch llama3.2-1b`` in a child
process: 10 steps, the full-width state (12.4 GB) saved, restored bit-equal
onto a fresh mesh, 5 more steps, every loss finite; and last, when nothing
else is timed, (a) the whole dry-run — ``python -m repro_torch.launch.dryrun
--all`` in a child process, tracing every supported arch × shape cell of the
ten configs on fake ``cuda:0`` tensors — every cell ``ok``; beside it, in
two more child processes at ``REPRO_BENCH_FAST=1``, the paper's
reproduction suite and the examples (``paper``): (a) every entry of
``python -m repro_torch.benchmarks.run`` on ``cuda:0`` (the hot-path record
``bench_hotpath`` first, then Tables 1-4, Figures 10-14, the scenario
bench, the kernel bench), its rows and ``*_validates`` flags printed, the
hot path's report and history written to the phase's temporary directory
and its history held by the port's ``regress check``, (c) its
``match_segment`` and ``segmented_order`` launches, the hot path's own
among them, (e) the kernel bench's three kernels against their plain
versions at the reference's shapes; (b) Table 1's simulations again on the
per-device loop,
identical to the array drain's; (d) the five examples of
``repro_torch.examples``, each with its launches. It imports
``repro_torch`` only.

Output: one JSON object per line (``env``, ``kernel_checks``, ``matcher``,
``main_path``, ``dense_path``, one ``scenario`` per registered scenario,
``scenarios``, ``fl_kernel_checks``, ``fl_round_setup``,
one ``fl_round_job`` per job and round, ``fl_round``,
``flash_kernel_checks``, ``serve``, ``serve_families``, ``train_checks``,
``train``, ``train_families``, the paper phase's children's output,
``paper``, ``launch_dryrun_cells``, ``launch``, ``total_seconds``), the
card's name and power limit, the
``kernels`` summary line, and as the last line
``{"ok": true, "device": {"platform": "gpu", ...}}``.  Any failure raises;
without a CUDA device the script exits non-zero before printing a result.

After each of the two drain workloads one more ``engine="array"`` run of it,
at a tenth of its horizon, goes under ``torch.profiler`` and prints a
``*_profile`` line: the device's busy time and idle share over that drain,
its device operations a matcher call, and the device time per launch of the
scheduler's kernels.
(A tenth, because the profiler's own bookkeeping takes minutes per million
recorded events; the share does not depend on the horizon, every segment
costs the same.)
"""
from __future__ import annotations

import contextlib
import gc
import io
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.stderr.write("chip_smoke: no CUDA device available\n")
    sys.exit(1)

from repro_torch import scenarios as scen
from repro_torch import tree as tree_util
from repro_torch.accel import replan as replan_mod
from repro_torch.accel.engine import match_chunk_seq, match_chunk_torch
from repro_torch.accel.kernels import build, replan_order, schedule_match
from repro_torch.accel.kernels import match_segment as segment_mod
from repro_torch.accel.kernels.stage import stage_for
from repro_torch.accel.state import MatchState
from repro_torch.ckpt import checkpoint as ckpt_mod
from repro_torch.configs import ShapeConfig, get_config
from repro_torch.core import SCHEDULERS, Job, JobRequest, VennScheduler
from repro_torch.data import SyntheticLM, dirichlet_client_mixes
from repro_torch.device import default_device
from repro_torch.faults import FaultInjector, run_with_crashes
from repro_torch.fed import aggregation as fed_aggregation
from repro_torch.fed.aggregation import FedAdam, FedAvg, aggregate_deltas
from repro_torch.fed.client import make_local_update
from repro_torch.fed.compression import (QuantizeConfig, compress,
                                         compressed_bytes, decompress)
from repro_torch.kernels import fedavg_reduce as fedavg_mod
from repro_torch.kernels import flash_attention as flash_mod
from repro_torch.kernels import ops as fl_ops
from repro_torch.kernels import quantize as quant_mod
from repro_torch.kernels import ref as fl_ref
from repro_torch.kernels.flash_attention import valid_pairs
from repro_torch.launch import dryrun as dryrun_mod
from repro_torch.launch import train as train_mod
from repro_torch.launch.mesh import HBM_BW as PEAK_BYTES_PER_S
from repro_torch.launch.mesh import PEAK_FLOPS_BF16 as PEAK_BF16_FLOPS
from repro_torch.models import attention as attn_mod
from repro_torch.models import build_model
from repro_torch.serve import Engine, grow_caches
from repro_torch.sim import (JobTraceConfig, PopulationConfig, SimConfig,
                             generate_jobs)
from repro_torch.sim.devices import (REQ_HIGHPERF, REQUIREMENT_CLASSES,
                                     DeviceGenerator)
from repro_torch.sim.simulator import Simulator
from repro_torch.train.optimizer import AdamW
from repro_torch.train.train_step import (make_prefill_step,
                                          make_train_step, value_and_grad)

# Published peaks of one H100 SXM — HBM bandwidth and the dense bf16
# tensor-core rate — from the package, which the dry-run's roofline divides
# by too; and for the scalar f64 / i32 compares of segmented_rank the f64
# rate outside the tensor cores, 34 TFLOP/s (half the 67 TFLOP/s of f32),
# which counts a fused multiply-add as two: a compare is one instruction, so
# 17e12 of them a second.
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
    schedule_match.ensure_built()          # builds every kernel source at once
    segment_mod.ensure_built()
    replan_order.ensure_built()
    fedavg_mod.ensure_built()
    quant_mod.ensure_built()
    flash_mod.ensure_built()
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
    # the order entry: sorted segment ids, or None when there is one segment
    od = [None if nseg == 1 else d[0], d[1], d[2]]
    perm = replan_order.segmented_order(*od)
    torch.cuda.synchronize()
    perm_p = replan_order.segmented_order_ref(*d)
    assert torch.equal(perm, perm_p), ("segmented_order vs plain", n, nseg)
    assert np.array_equal(perm.cpu().numpy(), np.lexsort((ties, keys, seg))), \
        ("segmented_order vs lexsort", n, nseg)
    err = int((rank.long() - rank_p.long()).abs().max()) if n else 0
    order_err = int((perm.long() - perm_p.long()).abs().max()) if n else 0
    row = {"n": n, "segments": nseg, "equal": True, "max_abs_err": err,
           "order_max_abs_err": order_err}
    if timed:
        counts = np.bincount(seg)
        same_pairs = int((counts.astype(np.int64) ** 2).sum())
        ops = n * n + 3 * same_pairs     # seg compare; +3 where it matches
        nbytes = n * (4 + 8 + 4) + n * 4
        t_ops = ops / PEAK_SCALAR_OPS_PER_S * 1e3
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        # the order entry compares only inside a row's segment (the 3
        # compares of a same-segment pair), after a binary search for the
        # segment's bounds when segment ids are given
        order_ops = 3 * same_pairs \
            + (n * math.ceil(math.log2(n)) if nseg > 1 else 0)
        t_order_ops = order_ops / PEAK_SCALAR_OPS_PER_S * 1e3
        order_bytes = n * (8 + 4 + 4) + (4 * n if nseg > 1 else 0)
        t_order_bytes = order_bytes / PEAK_BYTES_PER_S * 1e3
        row.update(
            order_bound_ms=max(t_order_ops, t_order_bytes),
            order_bound_ops=order_ops, order_bound_bytes=order_bytes,
            order_bound_by="operations" if t_order_ops >= t_order_bytes
            else "bytes",
            ms=time_ms(lambda: replan_order.segmented_rank(*d)),
            plain_ms=time_ms(lambda: replan_order.segmented_rank_ref(*d),
                             reps=10),
            order_ms=time_ms(lambda: replan_order.segmented_order(*od)),
            order_plain_ms=time_ms(
                lambda: replan_order.segmented_order_ref(*d), reps=10),
            bound_ms=max(t_ops, t_bytes), bound_ops=ops, bound_bytes=nbytes,
            bound_by="operations" if t_ops >= t_bytes else "bytes",
            library_ms=None)
    return row


def _dense_state(seed, atoms, K, R, cover=False, demand_hi=24):
    """A mirror of ``atoms`` atoms, each with ``K`` candidate slots among
    ``R`` requests (the first four slots of a row with a tier band half the
    time), on the card.  ``cover``: the rows run through one permutation of
    the requests in turn, so that all ``R`` are in the mirror when
    ``atoms * K >= R``; else each row is a random ``K`` of them."""
    rng = np.random.default_rng(seed)
    reqs = [FakeReq(int(rng.integers(1, demand_hi))) for _ in range(R)]
    slots = []
    perm = rng.permutation(R) if cover else None
    for a in range(atoms):
        picks = perm[(a * K + np.arange(K)) % R] if cover \
            else rng.permutation(R)[:K]
        row = []
        for j, r in enumerate(picks):
            lo, hi = (sorted(rng.uniform(0, 3, 2)) if j < 4
                      and rng.uniform() < 0.5 else (-math.inf, math.inf))
            row.append((reqs[int(r)], float(lo), float(hi)))
        slots.append(row)
    state = MatchState.from_scheduler(FakeSched(slots), token=("d", seed),
                                      kcap=K, device=DEV)
    assert state.d_cand_req.shape == (atoms, K), state.d_cand_req.shape
    return state, rng


def _segment_plain(state, ids_d, sp_d, start, live, n):
    """The plain program on the card (torch only, no kernel of the
    package): choice, granted, rounds (0 rounds when the mirror holds no
    request, as the engine's entry returns)."""
    R = len(state.remaining)
    if R == 0:
        return np.full(n, -1, dtype=np.int32), np.zeros(n, dtype=bool), 0
    live_d = None if live is None else torch.from_numpy(
        live.astype(np.int32)).to(DEV)
    rem_d = torch.from_numpy(state.remaining.astype(np.int32)).to(DEV)
    out = segment_mod.match_segment_ref(
        state.d_cand_req, state.d_cand_lo, state.d_cand_hi, ids_d, sp_d,
        start, live_d, n, rem_d).cpu().numpy()
    assert out[2 * n + 1] == 1, "plain program did not settle"
    return out[:n], out[n:2 * n] != 0, int(out[2 * n])


def _segment_bound(state, ids, live, n):
    """Bytes this call must move: the rows' ids and speeds, the candidate
    rows of the distinct atoms they name, rem, the live indices, the
    outputs; operations: the two f64 band compares of every (row, column)."""
    K = state.d_cand_req.shape[1]
    R = len(state.remaining)
    atoms = len(np.unique(ids))
    nbytes = n * (4 + 8) + atoms * K * (4 + 8 + 8) + 4 * R \
        + (4 * n if live is not None else 0) + 4 * (2 * n + 2)
    ops = 2 * n * K
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_SCALAR_OPS_PER_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops), bound_bytes=nbytes,
                bound_ops=ops,
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def check_segment(state, chunk_ids, chunk_sp, start, n, live, label,
                  timed=False, seq=True):
    """The one-launch matcher on rows of a bound chunk vs the plain program
    on the card (choice, granted, rounds) and vs the sequential oracle."""
    ids_d = torch.from_numpy(chunk_ids.astype(np.int32)).to(DEV)
    sp_d = torch.from_numpy(chunk_sp).to(DEV)
    args = (state.d_cand_req, state.d_cand_lo, state.d_cand_hi, ids_d, sp_d,
            state.remaining)
    kw = dict(n=n, start=start, live=live)
    got = segment_mod.match_segment(*args, **kw)
    assert got.settled, (label, "did not settle")
    choice_p, granted_p, rounds_p = _segment_plain(state, ids_d, sp_d, start,
                                                   live, n)
    assert np.array_equal(got.choice, choice_p), (label, "choice")
    assert np.array_equal(got.granted, granted_p), (label, "granted")
    assert got.rounds == rounds_p, (label, "rounds", got.rounds, rounds_p)
    rows = start + (live if live is not None else np.arange(n))
    aids, speeds = chunk_ids[rows], chunk_sp[rows]
    t_seq = None
    if seq:
        t0 = time.perf_counter()
        want = match_chunk_seq(aids, speeds, state)
        t_seq = time.perf_counter() - t0
        assert np.array_equal(got.choice, want.choice), (label, "oracle")
        assert np.array_equal(got.granted, want.granted), (label, "oracle")
    lay = segment_mod.plan_layout(n, state.d_cand_req.shape[1],
                                  len(state.remaining))
    row = {"case": label, "n": n, "K": int(state.d_cand_req.shape[1]),
           "R": len(state.remaining), "live_rows": live is not None,
           "route": "grid" if lay.grid else "cta",
           "rounds": got.rounds, "granted": int(got.granted.sum()),
           "state_in_shared": [lay.req_in_smem, lay.row_in_smem],
           "equal": True, "max_abs_err": 0, "sequential_oracle_s": t_seq}
    if timed:
        row.update(
            ms=time_ms(lambda: segment_mod.match_segment(*args, **kw)),
            plain_ms=time_ms(lambda: _segment_plain(
                state, ids_d, sp_d, start, live, n), reps=10, batches=3),
            library_ms=None, **_segment_bound(state, aids, live, n))
    return row


# the main path's mean segment first: it is the kernels line's shape
SEG_TIMED = ((2, "tenx_r500_j2000's mean segment: n=2 of the dense mirror"),
             (78, "heavy_r50_j200's mean segment: n=78 of the dense mirror"),
             (1024, "n=1024 of the dense mirror: one CTA, one full tile"),
             (16384, "the dense segment: n=16384 K=32 (the grid route)"))


@contextlib.contextmanager
def _grid_rows(rows):
    """Send every segment of more than ``rows`` rows to the matcher's grid
    route (the route comparison below only)."""
    old = segment_mod.GRID_ROWS
    segment_mod.GRID_ROWS = rows
    try:
        yield
    finally:
        segment_mod.GRID_ROWS = old


def route_comparison(state, chunk_ids, chunk_sp):
    """Both routes of the matcher at each size of ROUTE_SIZES on the dense
    mirror, each held against the plain program (choice, granted, rounds)
    and timed as the kernels line's rows are; what GRID_ROWS rests on."""
    ids_d = torch.from_numpy(chunk_ids.astype(np.int32)).to(DEV)
    sp_d = torch.from_numpy(chunk_sp).to(DEV)
    args = (state.d_cand_req, state.d_cand_lo, state.d_cand_hi, ids_d, sp_d,
            state.remaining)
    rows = []
    for n in ROUTE_SIZES:
        row = {"n": n}
        for route, limit in (("cta", 1 << 30), ("grid", 0)):
            with _grid_rows(limit):
                chk = check_segment(state, chunk_ids, chunk_sp, 0, n, None,
                                    f"{route} n={n}", seq=False)
                assert chk["route"] == route, chk
                row[route + "_ms"] = time_ms(
                    lambda: segment_mod.match_segment(*args, n=n),
                    reps=10, batches=3)
            row["rounds"] = chk["rounds"]
        row["route_taken"] = "grid" if n > segment_mod.GRID_ROWS else "cta"
        rows.append(row)
    return rows


ROUTE_SIZES = (1024, 1536, 2048, 4096, 8192, 16384)


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
    # the one-launch matcher on phase_matcher's dense mirror (64 atoms, K =
    # 32, a random 32 of 2048 requests each; a chunk of 16384 rows) and on
    # the workloads' mean segment sizes
    state, rng = _dense_state(12345, 64, 32, 2048)
    chunk_ids = rng.integers(0, 64, size=16384)
    chunk_sp = rng.uniform(0, 3, size=16384)
    seg = []
    for n, label in SEG_TIMED:
        seg.append(check_segment(state, chunk_ids, chunk_sp, 0, n, None,
                                 label, timed=True, seq=n < 16384))
    routes = route_comparison(state, chunk_ids, chunk_sp)
    emit("kernel_checks", {"masked_first_fit": ff, "segmented_rank": rk,
                           "match_segment": seg,
                           "match_segment_routes": routes,
                           "grid_rows": segment_mod.GRID_ROWS,
                           "tolerance": "exact (torch.equal); integer outputs",
                           "timing": "median of 5 batches of 50 launches, "
                                     "CUDA events, inputs warm in L2"})
    return ff, rk, seg


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
    """The engine's matcher entry (one launch of match_segment a call) vs
    the plain program on the card (choice, granted and rounds, bit for bit)
    and the sequential oracle, on 200 seeded small states — every fourth
    through a padded chunk with a live-row list — and on three wide cases."""
    segment_mod.reset_launches()
    checked = rounds = calls = 0
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
        if seed % 4:
            got = match_chunk_torch(aids, speeds, state, DEV)
            chunk_ids, chunk_sp, start, live = aids, speeds, 0, None
        else:
            # the rows inside a bound chunk, between rows that are not live
            start, m = 3, 2 * n + 5
            live = np.sort(rng.choice(m - start, size=n, replace=False))
            chunk_ids = rng.choice(cov, size=m)
            chunk_sp = rng.uniform(0, 3, size=m)
            chunk_ids[start + live], chunk_sp[start + live] = aids, speeds
            got = match_chunk_torch(
                aids, speeds, state, DEV,
                on_device=(torch.from_numpy(chunk_ids.astype(np.int32)).to(DEV),
                           torch.from_numpy(chunk_sp).to(DEV)),
                start=start, live=live)
        calls += len(state.remaining) > 0       # no request: no launch
        assert got.choice.dtype == np.int64 and got.granted.dtype == np.bool_
        assert np.array_equal(got.choice, want.choice), ("choice", seed)
        assert np.array_equal(got.granted, want.granted), ("granted", seed)
        choice_p, granted_p, rounds_p = _segment_plain(
            state, torch.from_numpy(chunk_ids.astype(np.int32)).to(DEV),
            torch.from_numpy(chunk_sp).to(DEV), start, live, n)
        assert np.array_equal(got.choice, choice_p), ("plain choice", seed)
        assert np.array_equal(got.granted, granted_p), ("plain granted", seed)
        assert got.rounds == rounds_p, ("rounds", seed, got.rounds, rounds_p)
        checked += 1
        rounds += got.rounds
    assert segment_mod.launches == calls, (segment_mod.launches, calls)
    wide = []
    # the dense segment: 16384 rows, 64 atoms, K = 32, 2048 requests,
    # through the engine's entry (rows uploaded) and the wrapper
    state, rng = _dense_state(12345, 64, 32, 2048)
    aids = rng.integers(0, 64, size=16384)
    speeds = rng.uniform(0, 3, size=16384)
    t0 = time.perf_counter()
    want = match_chunk_seq(aids, speeds, state)
    t_seq = time.perf_counter() - t0
    match_chunk_torch(aids, speeds, state, DEV)             # warm-up
    torch.cuda.synchronize()
    before = segment_mod.launches
    t0 = time.perf_counter()
    got = match_chunk_torch(aids, speeds, state, DEV)
    torch.cuda.synchronize()
    t_dev = time.perf_counter() - t0
    assert segment_mod.launches == before + 1
    # the route that serves the workloads' segments of this size
    assert segment_mod.launches_grid == 2, segment_mod.launches_grid
    assert np.array_equal(got.choice, want.choice), "dense choice"
    assert np.array_equal(got.granted, want.granted), "dense granted"
    # the stage holds no stream: a call runs on the stream current at call
    # time, read through torch's raw getter (timed here against the public
    # one it replaces)
    stage = stage_for(DEV)
    assert stage.stream_handle() == torch.cuda.current_stream(DEV).cuda_stream
    side = torch.cuda.Stream(DEV)
    with torch.cuda.stream(side):
        assert stage.stream_handle() == side.cuda_stream
        got_side = match_chunk_torch(aids, speeds, state, DEV)
    assert np.array_equal(got_side.choice, want.choice), "side stream"
    assert np.array_equal(got_side.granted, want.granted), "side stream"
    stream_us = {}
    for name, fn in (("raw_getter", stage.stream_handle),
                     ("current_stream", lambda: torch.cuda.current_stream(
                         DEV).cuda_stream)):
        for _ in range(1000):
            fn()
        t0 = time.perf_counter()
        for _ in range(20000):
            fn()
        stream_us[name] = (time.perf_counter() - t0) / 20000 * 1e6
    row = check_segment(state, aids, speeds, 0, 16384, None, "dense",
                        seq=False)
    assert row["rounds"] == got.rounds
    row.update(device_match_s=t_dev, sequential_oracle_s=t_seq)
    wide.append(row)
    # K = 130 (five mask words a row) and R = 4096 on the grid route; R =
    # 16384 on one CTA (the request state spills to scratch); R = 2200 on
    # one CTA with 47 488 bytes of dynamic shared memory (with the static
    # 4 KB over the 48 KB that needs no opt-in)
    for atoms, K, R, n, live_every in ((48, 130, 4096, 16384, 3),
                                       (512, 32, 16384, 1536, 0),
                                       (80, 32, 2200, 1024, 2)):
        # demands of 1-2: the rows outnumber the capacity, grants run out
        state, rng = _dense_state(7 + K + R, atoms, K, R, cover=True,
                                  demand_hi=3)
        assert len(state.remaining) == R, len(state.remaining)
        m = n + 100
        chunk_ids = rng.integers(0, atoms, size=m)
        chunk_sp = rng.uniform(0, 3, size=m)
        live = np.arange(0, n * live_every, live_every)[:n] \
            if live_every else None
        if live is not None:
            m = int(live[-1]) + 101
            chunk_ids = rng.integers(0, atoms, size=m)
            chunk_sp = rng.uniform(0, 3, size=m)
        wide.append(check_segment(state, chunk_ids, chunk_sp, 100, n, live,
                                  f"K={K} R={R} n={n}"))
    # both routes, and the one-CTA route with state in global scratch
    assert segment_mod.launches_grid >= 4 and segment_mod.launches_scratch, \
        (segment_mod.launches_grid, segment_mod.launches_scratch)
    emit("matcher", {
        "random_states_checked": checked, "random_states_rounds": rounds,
        "launches": segment_mod.launches,
        "launches_grid": segment_mod.launches_grid,
        "launches_scratch": segment_mod.launches_scratch,
        "stream_handle_host_us": stream_us,
        "wide": wide, "equal_to_plain_program_and_sequential_oracle": True})


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


KERNEL_KINDS = (  # (kind, substrings of a device row's name), first match
    ("flash_wgmma", ("flash_wgmma_kernel",)),
    ("matmul", ("gemm", "nvjet", "cutlass", "xmma", "cublas", "splitK")),
    ("copy", ("Memcpy", "Memset", "copy", "Copy", "cat_", "CatArray")),
    ("gather_scatter", ("index", "gather", "scatter", "Index")),
    ("sort", ("sort", "Sort", "radix")),
    ("reduce", ("reduce", "Reduce", "softmax", "Softmax", "cumsum", "scan")),
    ("elementwise", ("elementwise", "vectorized", "Elementwise")),
)


def _kernel_kind(name: str) -> str:
    for kind, keys in KERNEL_KINDS:
        if any(k in name for k in keys):
            return kind
    return "other"


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
    prof["device_ops"] = sum(e.count for e in rows)
    kinds = {}
    for e in rows:
        kinds[_kernel_kind(e.key)] = kinds.get(_kernel_kind(e.key), 0.0) \
            + e.self_device_time_total / 1e6
    prof["device_s_by_kind"] = dict(sorted(kinds.items(),
                                           key=lambda kv: -kv[1]))
    for name, key in (("masked_first_fit", "masked_first_fit"),
                      ("match_segment", "match_segment_kernel"),
                      ("segmented_rank", "segmented_rank_kernel<false>"),
                      ("segmented_order", "segmented_rank_kernel<true>"),
                      ("flash_kernel", "flash_kernel"),
                      ("flash_wgmma_kernel", "flash_wgmma_kernel")):
        mine = [e for e in rows if key in e.key]
        prof[name + "_device_us_per_launch"] = \
            sum(e.self_device_time_total for e in mine) \
            / sum(e.count for e in mine) if mine else None
    return res, prof


def _run(make_jobs, pop, max_time, engine, seed=1, profile=False):
    schedule_match.reset_launches()
    segment_mod.reset_launches()
    replan_order.reset_launches()
    replan_mod.order_fallbacks = 0
    replan_mod.kernel_resorts = 0
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
    counts = {"match_segment": segment_mod.launches,
              "match_segment_grid": segment_mod.launches_grid,
              "match_segment_scratch": segment_mod.launches_scratch,
              "masked_first_fit": schedule_match.launches,
              "segmented_order": replan_order.launches_order,
              "segmented_rank": replan_order.launches_rank}
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
           "kernel_resorts": replan_mod.kernel_resorts,
           "launches": counts}
    eng = sim.engine
    if eng is not None:
        out.update(segments=eng.segments, matcher_calls=eng.matcher_calls,
                   matcher_rows=eng.matcher_rows,
                   fixedpoint_rounds=eng.fixedpoint_rounds,
                   matcher_s=eng.matcher_s,
                   matcher_host_us_per_call=eng.matcher_s
                   / max(eng.matcher_calls, 1) * 1e6,
                   matcher_max_rows=eng.matcher_max_rows,
                   matcher_grid_calls=eng.matcher_grid_calls,
                   matcher_grid_s=eng.matcher_grid_s,
                   matcher_grid_share_of_matcher_s=eng.matcher_grid_s
                   / max(eng.matcher_s, 1e-12),
                   rebuild_s=eng.rebuild_s,
                   patch_s=eng.patch_s,
                   rebuilds=eng.rebuilds, patches=eng.patches,
                   expansions=eng.expansions, degraded=dict(eng.degraded),
                   kcap=eng.kcap, device=str(eng.device))
    if profile:
        out.update(prof, wall_s_under_profiler=out.pop("wall_s"),
                   device_idle_share_of_drain=
                   1.0 - prof["device_busy_s"] / sim.drain_seconds,
                   device_ops_per_matcher_call=prof["device_ops"]
                   / max(out.get("matcher_calls", 0), 1))
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
    # one launch of the fused matcher a matcher call, whatever the layout
    assert arr["launches"]["match_segment"] == arr["matcher_calls"] > 0, \
        (tag, arr["launches"], arr["matcher_calls"])
    # the grid route serves exactly the calls above GRID_ROWS rows
    assert arr["launches"]["match_segment_grid"] \
        == arr["matcher_grid_calls"], (tag, arr["launches"])
    # one launch of the order kernel a resort; the contract entries of both
    # kernels are off the path
    for res in (arr, py):
        assert res["launches"]["segmented_order"] == res["kernel_resorts"] \
            > 0, (tag, res["launches"], res["kernel_resorts"])
        assert res["launches"]["masked_first_fit"] == 0, res["launches"]
        assert res["launches"]["segmented_rank"] == 0, res["launches"]
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


# --------------------------------------------------------------------------- #
# 5b. the scenario registry, fault injection, record/replay, audit, crashes
# --------------------------------------------------------------------------- #

def _scenario_run(spec, engine, **kw):
    """One registered scenario under VENN, seed 0, on the card, through the
    runner a user calls; the run's metrics and its drain and kernel counts."""
    segment_mod.reset_launches()
    replan_order.reset_launches()
    replan_mod.kernel_resorts = 0
    replan_mod.order_fallbacks = 0
    r = scen.run_one(spec, "venn", 0, engine=engine, device=DEV, **kw)
    torch.cuda.synchronize()
    sim = r.sim
    out = {"wall_s": r.wall,
           "checkins": sim.checkins_seen + sim.checkins_skipped,
           "checkin_loop_s": sim.drain_seconds - sim.stream_seconds,
           "stream_seconds": sim.stream_seconds,
           "sched_invocations": sim.sched.sched_invocations,
           "kernel_resorts": replan_mod.kernel_resorts,
           "order_fallbacks": replan_mod.order_fallbacks,
           "launches": {"match_segment": segment_mod.launches,
                        "match_segment_grid": segment_mod.launches_grid,
                        "segmented_order": replan_order.launches_order,
                        "segmented_rank": replan_order.launches_rank}}
    eng = sim.engine
    if eng is not None:
        out.update(device=str(eng.device), segments=eng.segments,
                   matcher_calls=eng.matcher_calls,
                   matcher_rows=eng.matcher_rows,
                   matcher_max_rows=eng.matcher_max_rows,
                   matcher_s=eng.matcher_s,
                   matcher_host_us_per_call=eng.matcher_s
                   / max(eng.matcher_calls, 1) * 1e6,
                   degraded=dict(eng.degraded),
                   degraded_segments=eng.degraded_segments)
    return r.metrics, out


def _same_run(tag, a, b, skip=()):
    """Metrics of two runs bit for bit: ``summary()``, JCTs, rounds and
    ``resilience()`` but for the counters in ``skip`` (``degraded_segments``,
    which only the array engine counts, between engines; the recoveries
    between a crashed run and a crash-free one)."""
    assert a.jcts == b.jcts, f"{tag}: jcts differ"
    assert _rounds_sig(a) == _rounds_sig(b), f"{tag}: rounds differ"
    assert a.summary() == b.summary(), f"{tag}: summary differs"
    ra, rb = a.resilience(), b.resilience()
    for k in skip:
        ra.pop(k)
        rb.pop(k)
    assert ra == rb, (tag, ra, rb)


def _scenario_sim(spec, engine):
    """``run_one``'s simulator, built for ``run_with_crashes`` to restart."""
    plan = spec.fault_plan.resolve(spec.sim.max_time) \
        if spec.fault_plan is not None else None
    stream = scen.build_stream(spec, 0)
    if plan is not None and not plan.is_empty:
        stream = FaultInjector(stream, plan)
    return Simulator(scen.build_jobs(spec, 0), VennScheduler(seed=0,
                                                             device=DEV),
                     cfg=spec.sim, stream=stream, engine=engine, faults=plan,
                     device=DEV)


def phase_scenarios():
    """Every registered scenario at its library size on both drain engines,
    then record/replay, audit bytes, a three-crash restore and the CLI."""
    t_phase = time.perf_counter()
    names = scen.scenario_names()
    assert len(names) == 11, names
    arr_metrics = {}
    sums = {"match_segment": 0, "segmented_order": 0, "matcher_calls": 0,
            "kernel_resorts": 0, "checkins": 0}
    for name in names:
        spec = scen.get_scenario(name)
        m_arr, arr = _scenario_run(spec, "array")
        m_py, py = _scenario_run(spec, "python")
        _same_run(name, m_arr, m_py, skip=("degraded_segments",))
        assert len(m_arr.rounds) > 0, name
        assert all(math.isfinite(v) for v in m_arr.jcts.values()), name
        assert arr["device"].startswith("cuda"), arr["device"]
        # one match_segment launch a matcher call, one segmented_order launch
        # a resort on either engine; the contract entries stay off the path
        assert arr["launches"]["match_segment"] == arr["matcher_calls"], \
            (name, arr["launches"], arr["matcher_calls"])
        for res in (arr, py):
            assert res["launches"]["segmented_order"] \
                == res["kernel_resorts"], (name, res["launches"])
            assert res["launches"]["segmented_rank"] == 0, res["launches"]
            assert res["order_fallbacks"] == 0, (name, res)
        assert py["launches"]["match_segment"] == 0, py["launches"]
        # on the card only non-finite speeds may reach the sequential oracle
        assert arr["degraded"]["exception"] == 0, (name, arr["degraded"])
        assert arr["degraded"]["implausible"] == 0, (name, arr["degraded"])
        assert arr["degraded_segments"] == arr["degraded"]["nonfinite"] \
            == m_arr.degraded_segments, (name, arr)
        if name == "flaky_ingest":
            assert arr["degraded"]["nonfinite"] > 0, arr["degraded"]
        else:
            assert arr["degraded"]["nonfinite"] == 0, (name, arr["degraded"])
        arr_metrics[name] = m_arr
        sums["match_segment"] += arr["launches"]["match_segment"]
        sums["segmented_order"] += arr["launches"]["segmented_order"] \
            + py["launches"]["segmented_order"]
        sums["matcher_calls"] += arr["matcher_calls"]
        sums["kernel_resorts"] += arr["kernel_resorts"] + py["kernel_resorts"]
        sums["checkins"] += arr["checkins"]
        emit("scenario", {
            "name": name, "checkins": arr["checkins"],
            "rounds": len(m_arr.rounds), "avg_jct_s": m_arr.avg_jct,
            "sched_invocations": arr["sched_invocations"],
            "array_checkin_loop_s": arr["checkin_loop_s"],
            "python_checkin_loop_s": py["checkin_loop_s"],
            "array_wall_s": arr["wall_s"], "python_wall_s": py["wall_s"],
            "stream_seconds": arr["stream_seconds"],
            "segments": arr["segments"],
            "matcher_calls": arr["matcher_calls"],
            "matcher_rows": arr["matcher_rows"],
            "matcher_max_rows": arr["matcher_max_rows"],
            "matcher_s": arr["matcher_s"],
            "matcher_host_us_per_call": arr["matcher_host_us_per_call"],
            "resorts": {"array": arr["kernel_resorts"],
                        "python": py["kernel_resorts"]},
            "launches": {"array": arr["launches"],
                         "python": py["launches"]},
            "degraded": arr["degraded"],
            "resilience": m_arr.resilience(), "metrics_identical": True})
    assert sums["match_segment"] > 0 and sums["segmented_order"] > 0, sums

    with tempfile.TemporaryDirectory(prefix="venn-smoke-") as tmp:
        # record flash_crowd's stream on the array engine, replay it
        spec = scen.get_scenario("flash_crowd")
        trace = os.path.join(tmp, "flash_crowd.csv")
        t0 = time.perf_counter()
        m_rec, _ = _scenario_run(spec, "array", record=trace)
        t_rec = time.perf_counter() - t0
        t0 = time.perf_counter()
        m_rep, rep = _scenario_run(spec, "array", replay=trace)
        t_rep = time.perf_counter() - t0
        _same_run("flash_crowd record", m_rec, arr_metrics["flash_crowd"])
        _same_run("flash_crowd replay", m_rep, m_rec)
        replay = {"scenario": "flash_crowd", "trace_bytes":
                  os.path.getsize(trace), "record_s": t_rec,
                  "replay_s": t_rep, "replay_checkins": rep["checkins"],
                  "metrics_identical": True}

        # the audit stream is byte-identical between the drain engines
        audit = {}
        for name in ("baseline_even", "blackout_storm"):
            blobs = {}
            for engine in ("array", "python"):
                path = os.path.join(tmp, f"{name}.{engine}.audit.jsonl")
                scen.run_scenario(name, scheds=["venn"], seeds=[0],
                                  engine=engine, audit_out=path, device=DEV)
                with open(path, "rb") as fh:
                    blobs[engine] = fh.read()
            assert blobs["array"] == blobs["python"], \
                f"{name}: audit bytes differ between engines"
            audit[name] = {"bytes": len(blobs["array"]),
                           "records": blobs["array"].count(b"\n"),
                           "identical": True}

        # three crashes with lost work, restored from snapshots of the card's
        # run, give the crash-free metrics
        spec = scen.get_scenario("blackout_storm")
        free = arr_metrics["blackout_storm"]
        last = max(r.complete for r in free.rounds)
        crash_times = [0.2 * last, 0.45 * last, 0.7 * last]
        lag = 0.05 * last
        t0 = time.perf_counter()
        crashed = run_with_crashes(lambda: _scenario_sim(spec, "array"),
                                   crash_times=crash_times,
                                   ckpt_dir=os.path.join(tmp, "ckpt"),
                                   snapshot_lag=lag)
        t_crash = time.perf_counter() - t0
        _same_run("blackout_storm crashes", crashed, free,
                  skip=("recovery_events",))
        assert crashed.resilience()["recovery_events"] == 3, \
            crashed.resilience()
        assert free.resilience()["recovery_events"] == 0
        crash = {"scenario": "blackout_storm", "engine": "array",
                 "crash_times_s": crash_times, "snapshot_lag_s": lag,
                 "recovery_events": 3, "wall_s": t_crash,
                 "metrics_identical": True}

    # the CLI a user runs, with no --device: the card by default
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    cli = subprocess.run(
        [sys.executable, "-m", "repro_torch.scenarios", "run",
         "baseline_even", "--sched", "venn,random", "--engine", "array"],
        capture_output=True, text=True, cwd=ROOT, env=env, timeout=900)
    assert cli.returncode == 0, cli.stderr[-3000:]
    speedup = [ln for ln in cli.stdout.splitlines()
               if ln.startswith("speedup venn vs random")]
    assert speedup, cli.stdout[-3000:]
    emit("scenarios", {
        "scenarios": names, "seed": 0, "scheduler": "venn",
        "size": "library (one simulated week, 24 jobs)",
        "checkins": sums["checkins"],
        "match_segment_launches": sums["match_segment"],
        "matcher_calls": sums["matcher_calls"],
        "segmented_order_launches": sums["segmented_order"],
        "kernel_resorts": sums["kernel_resorts"],
        "record_replay": replay, "audit": audit, "crash_restore": crash,
        "cli": {"returncode": cli.returncode, "speedup": speedup[0],
                "wall_s": time.perf_counter() - t0},
        "phase_wall_s": time.perf_counter() - t_phase})
    return sums


# --------------------------------------------------------------------------- #
# 6. the federated-learning kernels vs their plain versions
# --------------------------------------------------------------------------- #

def _bits(t: torch.Tensor) -> torch.Tensor:
    """Bit patterns of a float tensor (so NaN equals NaN of the same bits)."""
    return t.contiguous().view(torch.int32 if t.element_size() == 4
                               else torch.int16)


def check_fedavg(K, N, dtype, seed, timed):
    g = torch.Generator(device=DEV).manual_seed(seed)
    u = torch.randn((K, N), generator=g, device=DEV).to(dtype)
    w = torch.rand(K, generator=g, device=DEV) * 4.9 + 0.1
    got = fl_ops.fedavg_reduce(u, w)
    torch.cuda.synchronize()
    want = fl_ref.fedavg_reduce_ref(u, w)
    assert got.dtype == dtype and tuple(got.shape) == (N,)
    assert bool(torch.isfinite(got.float()).all()), ("fedavg_reduce", K, N)
    err = float((got.float() - want.float()).abs().max())
    tol = 1e-6 if dtype == torch.float32 else 2e-2
    assert err <= tol, ("fedavg_reduce", K, N, dtype, err)
    row = {"K": K, "N": N, "dtype": str(dtype).removeprefix("torch."),
           "max_abs_err": err, "tolerance": tol,
           "bit_equal": bool(torch.equal(_bits(got), _bits(want)))}
    if timed:
        wn = fl_ref.normalized_weights(w)
        lib_err = float((torch.mv(u.t(), wn) - want).abs().max())
        nbytes = (K + 1) * N * u.element_size() + K * 4
        row.update(
            ms=time_ms(lambda: fl_ops.fedavg_reduce(u, w), reps=10, batches=3),
            plain_ms=time_ms(lambda: fl_ref.fedavg_reduce_ref(u, w), reps=2,
                             batches=3),
            library_ms=time_ms(lambda: torch.mv(u.t(), wn), reps=10,
                               batches=3),
            library="torch.mv(u.t(), w_normalised)", library_max_abs_err=lib_err,
            bound_bytes=nbytes, bound_ms=nbytes / PEAK_BYTES_PER_S * 1e3,
            bound_by="bytes")
    del u
    return row


def check_quant(N, block, seed, timed, nan_block=None):
    g = torch.Generator(device=DEV).manual_seed(seed)
    x = torch.randn(N, generator=g, device=DEV) * (0.01 + 10.0 * (seed % 7))
    if nan_block is not None:
        x[nan_block * block + 17] = float("nan")
    q, s = fl_ops.quantize(x, block=block, rows_per_tile=1)
    torch.cuda.synchronize()
    q_p, s_p = fl_ref.quantize_ref(x, block)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert torch.equal(q, q_p) and torch.equal(_bits(s), _bits(s_p)), (
        "quantize", N, block, int((q != q_p).sum()),
        int((_bits(s) != _bits(s_p)).sum()))
    if nan_block is not None:
        assert math.isnan(float(s[nan_block]))
        assert not q[nan_block * block:(nan_block + 1) * block].any()
    row_q = {"N": N, "block": block, "codes_equal": True,
             "scales_bit_equal": True, "nan_block": nan_block,
             "max_abs_err": int((q.int() - q_p.int()).abs().max())}
    row_d = {"N": N, "block": block}
    errs = []
    for dt in (torch.float32, torch.bfloat16):
        d = fl_ops.dequantize(q, s, block=block, rows_per_tile=1, dtype=dt)
        torch.cuda.synchronize()
        d_p = fl_ref.dequantize_ref(q, s, block, dt)
        assert d.dtype == dt and torch.equal(_bits(d), _bits(d_p)), \
            ("dequantize", N, block, dt)
        fin = torch.isfinite(d_p)
        errs.append(float((d.float() - d_p.float())[fin].abs().max()))
        row_d["bit_equal_" + str(dt).removeprefix("torch.")] = True
    row_d["max_abs_err"] = max(errs)
    if timed:
        nbytes = N * 4 + N + (N // block) * 4
        bound = nbytes / PEAK_BYTES_PER_S * 1e3
        row_q.update(
            ms=time_ms(lambda: fl_ops.quantize(x, block=block,
                                               rows_per_tile=1), reps=20,
                       batches=3),
            plain_ms=time_ms(lambda: fl_ref.quantize_ref(x, block), reps=3,
                             batches=3),
            library_ms=None, bound_bytes=nbytes, bound_ms=bound,
            bound_by="bytes")
        # one PyTorch call for the same function: int8 x f32 promotes to f32
        def lib():
            return torch.mul(q.view(-1, block), s[:, None])
        d = fl_ops.dequantize(q, s, block=block, rows_per_tile=1)
        lib_bit_equal = bool(torch.equal(_bits(lib().view(-1)), _bits(d)))
        row_d.update(
            ms=time_ms(lambda: fl_ops.dequantize(q, s, block=block,
                                                 rows_per_tile=1), reps=20,
                       batches=3),
            plain_ms=time_ms(lambda: fl_ref.dequantize_ref(q, s, block),
                             reps=3, batches=3),
            library_ms=time_ms(lib, reps=20, batches=3),
            library="torch.mul(codes.view(-1, block), scales[:, None])",
            library_bit_equal=lib_bit_equal, bound_bytes=nbytes,
            bound_ms=bound, bound_by="bytes", dtype="float32")
        del d
    return row_q, row_d


FL_BIG_N = 16 * 2048 * 8192        # llama3.2-1b's largest leaf, 2^28


def phase_fl_kernels():
    torch.backends.cuda.matmul.allow_tf32 = False
    fa = [check_fedavg(8, FL_BIG_N, torch.float32, 1, timed=True)]
    torch.cuda.empty_cache()
    for i, (K, N) in enumerate(((5, 1000), (16, 4096), (3, 7), (64, 513),
                                (1, 300))):
        for dt in (torch.float32, torch.bfloat16):
            fa.append(check_fedavg(K, N, dt, 10 + i, timed=False))
    qz, dq = [], []
    rq, rd = check_quant(FL_BIG_N, 256, 2, timed=True,
                         nan_block=FL_BIG_N // 256 // 3)
    qz.append(rq)
    dq.append(rd)
    torch.cuda.empty_cache()
    for i, (N, block) in enumerate(((1024, 256), (256 * 192, 256),
                                    (512, 128), (4096, 512))):
        rq, rd = check_quant(N, block, 20 + i, timed=False,
                             nan_block=1 if i == 1 else None)
        qz.append(rq)
        dq.append(rd)
    emit("fl_kernel_checks", {
        "fedavg_reduce": fa, "quantize": qz, "dequantize": dq,
        "tolerance": "fedavg_reduce 1e-6 f32, 2e-2 bf16 against the plain "
                     "version; quantize codes and scales, dequantize f32 and "
                     "bf16 bit-equal",
        "timing": "median of 3 batches of back-to-back launches, CUDA events"})
    return fa, qz, dq


# --------------------------------------------------------------------------- #
# 7. the federated server round: three jobs under one Venn scheduler
# --------------------------------------------------------------------------- #

FL_ROUNDS = 2
FL_JOBS = (  # (arch, reduced, demand per round, server, client lr)
    # job 0 at full width: the reference client's default lr (the example
    # has no full-width setting); jobs 1-2: the example's 0.15
    ("llama3.2-1b", False, 8, FedAdam(lr=1e-2), 0.05),
    ("stablelm-1.6b", True, 4, FedAvg(server_lr=1.0), 0.15),
    ("qwen3-32b", True, 4, FedAvg(server_lr=1.0), 0.15),
)
# examples/fl_multijob_training.py: B 4 × T 16 a local step, 2 local steps,
# the eval batch(8, seed=999)
FL_B, FL_T, FL_LOCAL_STEPS = 4, 16, 2
LLAMA_3_2_1B_PARAMS = 1_235_814_400


def _fl_counts():
    return (quant_mod.quantize_launches, quant_mod.dequantize_launches,
            fedavg_mod.launches, fed_aggregation.plain_leaves)


def _check_aggregate(deltas, agg):
    """A plain recomputation, leaf by leaf, from the same decompressed
    deltas."""
    w = torch.ones(len(deltas), dtype=torch.float32, device=DEV)
    per_client = [tree_util.leaves(d) for d in deltas]
    err = 0.0
    for i, leaf in enumerate(tree_util.leaves(agg)):
        stack = torch.stack([ls[i].reshape(-1) for ls in per_client])
        want = fl_ref.fedavg_reduce_ref(stack, w)
        del stack
        err = max(err, float((leaf.reshape(-1) - want).abs().max()))
    return err


def _ordered_bf16(t: torch.Tensor) -> torch.Tensor:
    """bf16 values as integers in value order, one per ulp."""
    b = t.contiguous().view(torch.int16).to(torch.int32)
    return torch.where(b < 0, -(b & 0x7FFF), b)


def _check_fedadam_step(server, old_params, agg, new_params, state):
    """The first FedAdam step written out plainly, leaf by leaf: ``g = -d``,
    ``m = (1-b1) g``, ``v = (1-b2) g²``, ``p - lr m̂ / (sqrt(v̂) + eps)``,
    with the reference's f32 bias corrections ``1 - b**1`` (a Python-double
    ``1 - b1`` is another f32 value, and where ``p ≈ lr`` the subtraction
    cancels and turns that last bit into a different bf16 result)."""
    b1, b2 = server.b1, server.b2
    c1 = 1.0 - torch.tensor(b1, dtype=torch.float32, device=DEV)
    c2 = 1.0 - torch.tensor(b2, dtype=torch.float32, device=DEV)
    ulps, mom = 0, 0.0
    for p, d, n, m, v in zip(tree_util.leaves(old_params),
                             tree_util.leaves(agg),
                             tree_util.leaves(new_params),
                             tree_util.leaves(state.mu),
                             tree_util.leaves(state.nu)):
        g = -d
        m_p = (1 - b1) * g
        v_p = (1 - b2) * g * g
        mom = max(mom, float((m - m_p).abs().max()),
                  float((v - v_p).abs().max()))
        upd = (m_p / c1) / (torch.sqrt(v_p / c2) + server.eps)
        want = (p.float() - server.lr * upd).to(p.dtype)
        ulps = max(ulps, int((_ordered_bf16(n) - _ordered_bf16(want))
                             .abs().max()))
    return ulps, mom


def _fl_eval(model, params, batch) -> float:
    with torch.no_grad():
        return float(model.loss_fn(params, batch))


def phase_fl_round():
    """``examples/fl_multijob_training.py``'s loop with the repo's settings:
    three jobs share one Venn scheduler and one device population; job 0 is
    llama3.2-1b at full width.  A granted client runs the real local update
    on the card (``make_local_update``: two SGD steps on its Dirichlet data
    shard, attention through the flash kernel, its backward a plain
    recompute); its delta is compressed to int8 and decompressed; the server
    aggregates and applies.  Each job's eval loss is read before and after
    the two rounds on the example's eval batch."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    allocated_at_start = torch.cuda.memory_allocated()
    jobs, models, params, servers, states = [], [], [], [], []
    updaters, datas, evals = [], [], []
    for i, (arch, reduced, demand, server, lr) in enumerate(FL_JOBS):
        cfg = get_config(arch)
        if reduced:
            cfg = cfg.reduced().with_(n_layers=2, vocab=128)
        model = build_model(cfg)
        p = model.init_params(torch.Generator(device=DEV).manual_seed(i), DEV)
        data = SyntheticLM(vocab=cfg.vocab, seq_len=FL_T, seed=i)
        jobs.append(Job(job_id=i, requirement=REQUIREMENT_CLASSES[i % 3],
                        demand_per_round=demand, total_rounds=FL_ROUNDS,
                        arrival_time=0.0))
        models.append(model)
        params.append(p)
        servers.append(server)
        states.append(server.init(p))
        updaters.append(make_local_update(model, lr=lr,
                                          local_steps=FL_LOCAL_STEPS))
        datas.append(data)
        evals.append({k: torch.from_numpy(v).to(DEV)
                      for k, v in data.batch(8, seed=999).items()})
    assert models[0].n_params() == LLAMA_3_2_1B_PARAMS
    assert sum(t.numel() for t in tree_util.leaves(params[0])) \
        == LLAMA_3_2_1B_PARAMS
    mixes = dirichlet_client_mixes(256, 8, alpha=0.3, seed=0)
    eval_before = [_fl_eval(m, p, e) for m, p, e in zip(models, params, evals)]
    emit("fl_round_setup", {
        "memory_allocated_at_start": allocated_at_start,
        "memory_allocated_with_models_and_state":
            torch.cuda.memory_allocated(),
        "eval_loss_before": eval_before})
    venn = VennScheduler(seed=0, device=DEV)
    devgen = DeviceGenerator(PopulationConfig(seed=3, base_rate=5.0))
    cfg_q = QuantizeConfig()
    rows = []
    quant_mod.reset_launches()
    fedavg_mod.reset_launches()
    fed_aggregation.reset_counts()
    flash_mod.reset_launches()
    attn_mod.reset_counts()
    orders_before = replan_order.launches_order
    torch.cuda.synchronize()
    t_phase = time.perf_counter()
    now = 0.0
    for rnd in range(FL_ROUNDS):
        reqs = []
        for j in jobs:
            req = JobRequest(job=j, round_index=rnd, demand=j.demand_per_round,
                             submit_time=now)
            j.current = req
            venn.on_request(req, now)
            reqs.append(req)
        assigned = {j.job_id: [] for j in jobs}
        times = devgen.checkin_times(now, now + 600.0)
        for dev in devgen.sample_devices(times):
            req = venn.assign(dev, float(dev.checkin_time))
            if req is not None and req.remaining > 0:
                req.granted += 1
                assigned[req.job.job_id].append(dev)
            if all(r.remaining == 0 for r in reqs):
                break
        now += 600.0
        for ji, job in enumerate(jobs):
            devs = assigned[job.job_id][:job.demand_per_round]
            n_leaves = len(tree_util.leaves(params[ji]))
            before = _fl_counts()
            bwd_before = flash_mod.backward_plain_calls
            t_lu = t_c = t_d = 0.0
            c_bytes = raw_bytes = 0
            deltas, loss_first, loss_last = [], [], []
            for ci, dev in enumerate(devs):
                mix = mixes[hash(dev.dev_id) % len(mixes)]
                bs = [datas[ji].batch(FL_B, topic_mix=mix,
                                      seed=1000 * rnd + ci + s)
                      for s in range(FL_LOCAL_STEPS)]
                batches = {k: torch.from_numpy(np.stack([b[k] for b in bs]))
                           .to(DEV) for k in bs[0]}
                if ji == 0:
                    job0_batches = batches
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                delta, metrics = updaters[ji](params[ji], batches)
                loss_first.append(float(metrics["loss_first"]))
                loss_last.append(float(metrics["loss_last"]))
                t_lu += time.perf_counter() - t0
                raw_bytes += sum(t.numel() * 4 for t in tree_util.leaves(delta))
                t0 = time.perf_counter()
                packed = compress(delta, cfg_q)
                torch.cuda.synchronize()
                t_c += time.perf_counter() - t0
                del delta
                c_bytes += compressed_bytes(packed)
                t0 = time.perf_counter()
                deltas.append(decompress(packed, cfg_q))
                torch.cuda.synchronize()
                t_d += time.perf_counter() - t0
                del packed
            assert deltas, f"job {ji} round {rnd}: no client was granted"
            assert all(math.isfinite(x) for x in loss_first + loss_last), \
                (ji, rnd, loss_first, loss_last)
            allocated_before_aggregate = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            agg = aggregate_deltas(deltas, [1.0] * len(deltas))
            torch.cuda.synchronize()
            t_a = time.perf_counter() - t0
            checks = {}
            if ji == 0 and rnd == 0:
                checks["aggregate_max_abs_err_vs_plain"] = \
                    _check_aggregate(deltas, agg)
                assert checks["aggregate_max_abs_err_vs_plain"] <= 1e-6, checks
            del deltas
            old = params[ji]
            t0 = time.perf_counter()
            params[ji], states[ji] = servers[ji].apply(params[ji], agg,
                                                       states[ji])
            torch.cuda.synchronize()
            t_p = time.perf_counter() - t0
            if ji == 0 and rnd == 0:
                ulps, mom = _check_fedadam_step(servers[0], old, agg,
                                                params[0], states[0])
                checks.update(params_max_bf16_ulps_vs_plain_fedadam=ulps,
                              moments_max_abs_err_vs_plain=mom)
                assert ulps <= 1 and mom <= 1e-6, checks
            del old, agg
            for t in tree_util.leaves(params[ji]):
                assert bool(torch.isfinite(t.float()).all()), (ji, rnd)
            venn.on_complete(job.current, now)
            job.current = None
            job.rounds_done += 1
            after = _fl_counts()
            q, dq, fa, plain = (a - b for a, b in zip(after, before))
            clients = len(devs)
            assert q == n_leaves * clients and dq == n_leaves * clients, \
                (ji, rnd, q, dq, n_leaves, clients)
            assert fa == n_leaves - plain, (ji, rnd, fa, plain, n_leaves)
            if ji == 0:
                assert plain == 0 and clients == job.demand_per_round, \
                    (plain, clients)
            bwd = flash_mod.backward_plain_calls - bwd_before
            n_layers = models[ji].cfg.n_layers
            assert bwd == n_layers * FL_LOCAL_STEPS * clients, (ji, rnd, bwd)
            rows.append(dict(
                job=ji, arch=FL_JOBS[ji][0], round=rnd, clients=clients,
                n_params=models[ji].n_params(), leaves=n_leaves,
                server=type(servers[ji]).__name__, client_lr=FL_JOBS[ji][4],
                local_update_s=t_lu, loss_first=loss_first,
                loss_last=loss_last,
                compress_s=t_c, decompress_s=t_d, aggregate_s=t_a,
                apply_s=t_p, compressed_bytes=c_bytes, raw_bytes=raw_bytes,
                uplink_ratio=c_bytes / raw_bytes,
                launches={"quantize": q, "dequantize": dq,
                          "fedavg_reduce": fa},
                backward_plain_calls=bwd,
                plain_leaves=plain,
                memory_allocated_before_aggregate=allocated_before_aggregate,
                max_memory_allocated=torch.cuda.max_memory_allocated(),
                **checks))
            emit("fl_round_job", rows[-1])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_phase
    totals = {"quantize": quant_mod.quantize_launches,
              "dequantize": quant_mod.dequantize_launches,
              "fedavg_reduce": fedavg_mod.launches,
              "flash_attention_wgmma": flash_mod.launches_wgmma,
              "flash_attention": flash_mod.launches_fma,
              "backward_plain_calls": flash_mod.backward_plain_calls,
              "segmented_order": replan_order.launches_order - orders_before}
    assert all(totals[k] > 0 for k in ("quantize", "dequantize",
                                       "fedavg_reduce",
                                       "flash_attention_wgmma")), totals
    # every forward of the local updates on the tensor-core kernel: bf16,
    # head_dim 64 (job 0) and 16 (jobs 1-2); none on the plain route
    assert totals["flash_attention"] == 0, totals
    assert attn_mod.attention_plain_calls == 0, attn_mod.attention_plain_calls
    assert totals["flash_attention_wgmma"] == totals["backward_plain_calls"]
    assert states[0].step.item() == FL_ROUNDS
    eval_after = [_fl_eval(m, p, e) for m, p, e in zip(models, params, evals)]
    assert all(math.isfinite(x) for x in eval_before + eval_after)
    peak = torch.cuda.max_memory_allocated()
    # one more local update of job 0 (its last client's batches), timed
    # alone and under the profiler: where local_update_s goes
    torch.cuda.synchronize()
    w0 = time.perf_counter()
    updaters[0](params[0], job0_batches)
    torch.cuda.synchronize()
    wall_lu = time.perf_counter() - w0
    _, prof = _profiled(lambda: updaters[0](params[0], job0_batches))
    prof.update(wall_s=wall_lu,
                device_idle_share=1.0 - prof["device_busy_s"] / wall_lu)
    for key in ("masked_first_fit", "match_segment", "segmented_rank",
                "segmented_order", "flash_kernel"):
        prof.pop(key + "_device_us_per_launch")
    assert peak < torch.cuda.get_device_properties(DEV).total_memory
    emit("fl_round", {
        "rounds": FL_ROUNDS, "jobs": [a for a, *_ in FL_JOBS],
        "job0_n_params": LLAMA_3_2_1B_PARAMS, "wall_s": wall,
        "local_update": {"batch": FL_B, "seq": FL_T,
                         "local_steps": FL_LOCAL_STEPS,
                         "client_lr": [j[4] for j in FL_JOBS]},
        "eval_loss_before": eval_before, "eval_loss_after": eval_after,
        "launches": totals, "plain_leaves": fed_aggregation.plain_leaves,
        "attention_plain_calls": attn_mod.attention_plain_calls,
        "max_memory_allocated": peak, "profile_job0_local_update": prof})
    return totals


# --------------------------------------------------------------------------- #
# 8. the flash-attention kernel vs its plain version
# --------------------------------------------------------------------------- #

# tests/test_kernels.py::FLASH_CASES: (B, T, S, H, Hkv, D, causal, window, bq, bk)
FLASH_CASES = [
    (1, 128, 128, 2, 2, 64, True, 0, 128, 128),
    (2, 256, 256, 4, 2, 64, True, 0, 128, 64),
    (1, 128, 128, 4, 1, 128, True, 64, 64, 64),
    (1, 256, 256, 2, 2, 32, False, 0, 128, 128),
    (2, 128, 128, 8, 4, 64, True, 32, 64, 32),
    (1, 512, 512, 2, 1, 64, True, 128, 128, 128),
]
# ragged lengths, a query offset, every head_dim: (B, T, S, H, Hkv, D, causal,
# window, q_offset)
FLASH_EXTRA = [
    (2, 1000, 1000, 4, 2, 64, True, 0, 0),
    (1, 1000, 1000, 4, 4, 16, False, 0, 0),
    (2, 100, 356, 4, 2, 64, True, 0, 256),
    (1, 77, 77, 4, 2, 16, True, 32, 0),
    (1, 130, 130, 2, 1, 128, False, 50, 0),
    (1, 33, 97, 2, 2, 32, True, 40, 64),
    (1, 500, 500, 16, 16, 80, False, 0, 0),      # hubert-xlarge's heads
    # llama-3.2-vision's cross-attention: 1024 text rows to 1601 vision rows
    (4, 1024, 1601, 32, 8, 128, False, 0, 0),
    # mixtral-8x22b's prefill: 48 heads, a window of 4096 (wider than T)
    (4, 1024, 1024, 48, 8, 128, True, 4096, 0),
]
FLASH_TOL = {torch.float32: 2e-6, torch.bfloat16: 2e-2}
SERVE_B, SERVE_PROMPT, SERVE_NEW = 4, 1024, 32


def check_flash(B, T, S, H, Hkv, D, causal, window, q_offset, dtype, seed,
                blocks=None, timed=False):
    g = torch.Generator(device=DEV).manual_seed(seed)
    q = torch.randn((B, T, H, D), generator=g, device=DEV).to(dtype)
    k = torch.randn((B, S, Hkv, D), generator=g, device=DEV).to(dtype)
    v = torch.randn((B, S, Hkv, D), generator=g, device=DEV).to(dtype)
    if blocks is not None:          # the public wrapper, the reference's tiles
        got = fl_ops.flash_attention(q, k, v, causal=causal, window=window,
                                     block_q=blocks[0], block_k=blocks[1])
    else:
        got = flash_mod.flash_attention(q, k, v, causal=causal, window=window,
                                        q_offset=q_offset)
    torch.cuda.synchronize()
    want = flash_mod.flash_attention_plain(q, k, v, causal=causal,
                                           window=window, q_offset=q_offset)
    assert got.dtype == dtype and got.shape == q.shape
    assert bool(torch.isfinite(got.float()).all()), ("flash", B, T, S, D)
    err = float((got.float() - want.float()).abs().max())
    tol = FLASH_TOL[dtype]
    assert err <= tol, ("flash_attention", B, T, S, H, Hkv, D, causal,
                        window, q_offset, dtype, err)
    row = {"B": B, "T": T, "S": S, "H": H, "Hkv": Hkv, "D": D,
           "causal": causal, "window": window, "q_offset": q_offset,
           "dtype": str(dtype).removeprefix("torch."),
           "route": flash_mod.flash_route(dtype, D), "max_abs_err": err,
           "tolerance": tol}
    if timed:
        pairs = B * H * valid_pairs(T, S, causal, window, q_offset)
        flops = 4 * D * pairs
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        t_ops = flops / PEAK_BF16_FLOPS * 1e3
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True)
        lib_err = float((sdpa().transpose(1, 2).float() - want.float())
                        .abs().max())
        # the FMA kernel on the same inputs, through its C entry (a
        # comparison launch: not counted)
        out_fma = torch.empty_like(q)
        fma_entry = flash_mod.entry("fma")
        stream = torch.cuda.current_stream().cuda_stream

        def fma():
            build.check_launch(fma_entry(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out_fma.data_ptr(),
                B, T, S, H, Hkv, D, int(causal), window, q_offset,
                1.0 / math.sqrt(D), int(dtype == torch.bfloat16), stream),
                "flash_attention (fma)")
        fma()
        torch.cuda.synchronize()
        fma_err = float((out_fma.float() - want.float()).abs().max())
        # the kernel through the wrapper, as every path calls it; and the
        # op's CUDA implementation (its checks and routed launch) called
        # directly, without the op's dispatch (``_wrapper_host_us``)
        ms = time_interleaved({
            "kernel": lambda: flash_mod.flash_attention(
                q, k, v, causal=causal, window=window, q_offset=q_offset),
            "direct": lambda: flash_mod._flash_attention_cuda(
                q, k, v, causal, window, q_offset),
            "fma": fma,
            "plain": lambda: flash_mod.flash_attention_plain(
                q, k, v, causal=causal, window=window, q_offset=q_offset),
            "library": sdpa},
            reps={"kernel": 20, "direct": 20, "fma": 20, "plain": 5,
                  "library": 20})
        bound = max(t_ops, t_bytes)
        row.update(
            ms=ms["kernel"], direct_ms=ms["direct"], fma_ms=ms["fma"],
            plain_ms=ms["plain"],
            library_ms=ms["library"], timing_runs=ms["runs"],
            library="scaled_dot_product_attention(is_causal, enable_gqa)",
            library_max_abs_err=lib_err, fma_max_abs_err=fma_err,
            bound_flops=flops, bound_bytes=nbytes, bound_ms=bound,
            bound_by="operations" if t_ops >= t_bytes else "bytes",
            tflops=flops / ms["kernel"] / 1e9,
            fma_tflops=flops / ms["fma"] / 1e9,
            share_of_bound=bound / ms["kernel"],
            fma_over_kernel=ms["fma"] / ms["kernel"])
    return row


def time_interleaved(fns: dict, reps: dict, rounds: int = 3) -> dict:
    """Each function timed as by :func:`time_ms` (one batch of ``reps``),
    in turns A B .. B A, ``rounds`` times; the median for each, and every
    reading under ``"runs"``."""
    names = list(fns)
    runs = {n: [] for n in names}
    for _ in range(rounds):
        for n in names + names[::-1]:
            runs[n].append(time_ms(fns[n], reps=reps[n], batches=1))
    out = {n: statistics.median(v) for n, v in runs.items()}
    out["runs"] = runs
    return out


def _ptxas(source: str) -> list:
    """``nvcc -Xptxas -v``'s lines for one source of this process's build."""
    for sec in build.build_log.split("== ")[1:]:
        name, _, body = sec.partition("\n")
        if name.strip() == source:
            return [ln.strip() for ln in body.splitlines()
                    if "registers" in ln or "spill" in ln
                    or "Compiling entry" in ln or "warning" in ln]
    return []


def _wrapper_host_us(calls=300, rounds=3):
    """Host µs a call of the flash wrapper, which dispatches through its
    ``torch.library`` op, and of the same checks and launch called directly
    (the op's CUDA implementation), at a shape whose kernel takes a few µs,
    in turns: what the op's dispatch costs a launch.  Comparison launches."""
    g = torch.Generator(device=DEV).manual_seed(7)
    q = torch.randn((1, 64, 4, 64), generator=g, device=DEV).bfloat16()
    k = torch.randn((1, 64, 2, 64), generator=g, device=DEV).bfloat16()
    v = torch.randn((1, 64, 2, 64), generator=g, device=DEV).bfloat16()
    fns = {"wrapper": lambda: flash_mod.flash_attention(q, k, v, causal=True),
           "direct": lambda: flash_mod._flash_attention_cuda(q, k, v, True,
                                                             0, 0)}
    runs = {n: [] for n in fns}
    for _ in range(rounds):
        for n in list(fns) + list(fns)[::-1]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fns[n]()
            runs[n].append((time.perf_counter() - t0) / calls * 1e6)
            torch.cuda.synchronize()
    return {n: statistics.median(r) for n, r in runs.items()} | {"runs": runs}


def phase_flash_kernels():
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = []
    for i, (B, T, S, H, Hkv, D, causal, window, bq, bk) in enumerate(
            FLASH_CASES):
        for dt in (torch.float32, torch.bfloat16):
            rows.append(check_flash(B, T, S, H, Hkv, D, causal, window, 0, dt,
                                    100 + i, blocks=(bq, bk)))
    for i, case in enumerate(FLASH_EXTRA):
        for dt in (torch.float32, torch.bfloat16):
            rows.append(check_flash(*case, dt, 200 + i))
    serve = check_flash(SERVE_B, SERVE_PROMPT, SERVE_PROMPT, 32, 8, 64, True,
                        0, 0, torch.bfloat16, 300, timed=True)
    assert serve["route"] == "wgmma", serve
    smem_of = build.load_library(
        "flash_attention_wgmma").venn_flash_attention_wgmma_smem
    smem = {d: smem_of(d) for d in flash_mod.HEAD_DIMS}
    wgmma_build = {"ptxas": _ptxas("flash_attention_wgmma.cu"),
                   "dynamic_smem_bytes": smem}
    assert min(smem.values()) > 0, smem
    bf16_err = {}
    for r in rows + [serve]:
        if r["dtype"] == "bfloat16":
            key = (f"B{r['B']} T{r['T']} S{r['S']} H{r['H']}/{r['Hkv']} "
                   f"D{r['D']} c{int(r['causal'])} w{r['window']} "
                   f"o{r['q_offset']} {r['route']}")
            bf16_err[key] = r["max_abs_err"]
    emit("flash_kernel_checks", {
        "rows": rows, "serve_shape": serve, "wgmma_build": wgmma_build,
        "bf16_max_abs_err_by_shape": bf16_err,
        "wrapper_host_us_per_call": _wrapper_host_us(),
        "tolerance": "2e-6 f32, 2e-2 bf16 (max abs) against the plain "
                     "version; f32 oracles without TF32",
        "timing": "serve shape: kernel (the wrapper, through the op), "
                  "direct (the op's CUDA implementation alone), FMA kernel, "
                  "plain, SDPA in turns (A B C D E E D C B A, 3 rounds), each a batch of "
                  "back-to-back launches by CUDA events; the median"})
    return rows, serve


# --------------------------------------------------------------------------- #
# 9. serving llama3.2-1b at full width
# --------------------------------------------------------------------------- #

def _bf16_ulp(x: float) -> float:
    """One bf16 ulp at magnitude ``x`` (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(x)) - 7)


def _plain_prefill(model, params, batch):
    """``Model.prefill`` with ``chunked_attention`` on the kernel's plain
    version (the wrapper's kernel launch swapped out for this one call)."""
    kernel = flash_mod.flash_attention

    def plain(q, k, v, *, causal=True, window=0, q_offset=0):
        return flash_mod.flash_attention_plain(q, k, v, causal=causal,
                                               window=window,
                                               q_offset=q_offset)
    flash_mod.flash_attention = plain
    try:
        return model.prefill(params, batch)
    finally:
        flash_mod.flash_attention = kernel


def phase_serve():
    """``Engine.generate`` on llama3.2-1b at full width (seeded bf16
    weights): four prompts of 1024 seeded tokens, 32 new tokens each."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config("llama3.2-1b")
    model = build_model(cfg)
    params = model.init_params(torch.Generator(device=DEV).manual_seed(0), DEV)
    assert model.n_params() == LLAMA_3_2_1B_PARAMS
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab, (SERVE_B, SERVE_PROMPT),
                          dtype=np.int32)
    batch = {"tokens": torch.from_numpy(prompt).to(DEV)}
    eng = Engine(cfg, params, device=DEV)
    eng.generate(batch, max_new=2)                # warm-up: cuBLAS, modules
    torch.cuda.synchronize()

    flash_mod.reset_launches()
    attn_mod.reset_counts()
    gen, stats = eng.generate(batch, max_new=SERVE_NEW)
    launches = flash_mod.launches
    by_route = {"launches_wgmma": flash_mod.launches_wgmma,
                "launches_fma": flash_mod.launches_fma}
    plain_calls = attn_mod.attention_plain_calls
    assert gen.shape == (SERVE_B, SERVE_NEW)
    assert ((gen >= 0) & (gen < cfg.vocab)).all()
    assert launches == cfg.n_layers, launches           # 16: one prefill
    # bf16 at head_dim 64: every launch on the tensor-core route
    assert by_route == {"launches_wgmma": cfg.n_layers,
                        "launches_fma": 0}, by_route
    assert plain_calls == 0, plain_calls
    peak = torch.cuda.max_memory_allocated()

    # (a) prefill through the kernel == prefill through the plain version
    with torch.no_grad():
        logits_k, caches = model.prefill(params, batch)
        logits_p, _ = _plain_prefill(model, params, batch)
    scale = float(logits_p.float().abs().max())
    tol_a = 8 * _bf16_ulp(scale)
    err_a = float((logits_k.float() - logits_p.float()).abs().max())
    assert bool(torch.isfinite(logits_k.float()).all())
    assert err_a <= tol_a, ("prefill kernel vs plain", err_a, tol_a)

    # (b) cached decode == full re-forward, at every one of the engine's
    # steps; the greedy tokens of these steps are the engine's, bit for bit
    steps = SERVE_NEW
    caches = grow_caches(model, caches, SERVE_NEW)
    toks = batch["tokens"]
    logits = logits_k
    tol_b = 2.0 ** -4 * scale
    rows_b, under_margin, worst = [], 0, 0.0
    greedy = []
    for i in range(steps):
        tok = torch.argmax(logits[:, -1, :], dim=-1)[:, None]
        greedy.append(tok)
        toks = torch.cat([toks, tok.to(toks.dtype)], dim=1)
        logits, caches = model.decode_step(params, caches, tok,
                                           SERVE_PROMPT + i)
        full, _ = model.forward(params, {"tokens": toks})
        ref_last = full[:, -1, :].float()
        del full
        dec = logits[:, -1, :].float()
        err = float((dec - ref_last).abs().max())
        top2 = torch.topk(ref_last, 2, dim=-1).values
        margin = (top2[:, 0] - top2[:, 1])
        same = torch.argmax(dec, -1) == torch.argmax(ref_last, -1)
        decided = margin > tol_b
        under_margin += int((~decided).sum())
        assert bool(same[decided].all()), ("greedy token", i, err)
        assert err <= tol_b, ("decode vs re-forward", i, err, tol_b)
        worst = max(worst, err)
        rows_b.append({"step": i, "max_abs_err": err,
                       "min_top2_margin": float(margin.min()),
                       "tokens_equal": int(same.sum())})
    greedy = torch.cat(greedy, dim=1).cpu().numpy()
    engine_tokens_equal = bool(np.array_equal(greedy, gen))
    assert engine_tokens_equal, ("engine vs the same steps", greedy, gen)
    decided_rows = steps * SERVE_B - under_margin
    # a top-2 margin above 2^-4 of the largest logit: about a third of the
    # rows at these random weights; fewer than 16 would leave (b) toothless
    assert decided_rows >= 16, ("rows deciding the greedy token",
                                decided_rows)
    del caches, logits, toks

    # (c) one prefill and four decode steps under the profiler; the idle
    # share is against the same work's wall time without the profiler (the
    # median of three runs: the host's clock is shared)
    torch.cuda.synchronize()
    walls = []
    for _ in range(3):
        wall0 = time.perf_counter()
        eng.generate(batch, max_new=4)
        walls.append(time.perf_counter() - wall0)
    wall = float(np.median(walls))
    wall0 = time.perf_counter()
    _, prof = _profiled(lambda: eng.generate(batch, max_new=4))
    wall_prof = time.perf_counter() - wall0
    prof.update(wall_s=wall, wall_s_runs=walls,
                wall_s_under_profiler=wall_prof,
                device_idle_share=1.0 - prof["device_busy_s"] / wall)
    # the scheduler kernels and the FMA route are not launched here
    for key in ("masked_first_fit", "match_segment", "segmented_rank",
                "segmented_order", "flash_kernel"):
        prof.pop(key + "_device_us_per_launch")
    assert prof["flash_wgmma_kernel_device_us_per_launch"] is not None, prof

    tokens_generated = SERVE_B * SERVE_NEW
    out = {
        "arch": cfg.name, "n_params": model.n_params(), "dtype": "bfloat16",
        "batch": SERVE_B, "prompt": SERVE_PROMPT, "max_new": SERVE_NEW,
        "prefill_s": stats.prefill_s, "decode_s": stats.decode_s,
        "decode_ms_per_step": stats.decode_s / SERVE_NEW * 1e3,
        "tokens_per_s_per_sequence": stats.tokens_per_s,
        "tokens_per_s": tokens_generated / stats.decode_s,
        "prefill_tokens_per_s": SERVE_B * SERVE_PROMPT / stats.prefill_s,
        "launches": {"flash_attention": launches, **by_route},
        "attention_plain_calls": plain_calls,
        "max_memory_allocated": peak,
        "check_a_prefill_kernel_vs_plain": {
            "max_abs_err": err_a, "tolerance": tol_a,
            "logits_max_abs": scale,
            "tolerance_rule": "8 bf16 ulps at the largest logit"},
        "check_b_decode_vs_reforward": {
            "steps": rows_b, "max_abs_err": worst, "tolerance": tol_b,
            "tolerance_rule": "2^-4 of the largest logit (8-16 bf16 ulps there)",
            "rows": steps * SERVE_B, "rows_under_margin": under_margin,
            "rows_deciding": decided_rows,
            "engine_tokens_equal": engine_tokens_equal},
        "profile_prefill_plus_4_decode": prof,
        "sample_tokens": gen[0][:12].tolist()}
    emit("serve", out)
    del eng, params
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------- #
# 9b. serving the MoE, MLA, Mamba-2, hybrid and cross-attention families
# --------------------------------------------------------------------------- #

# (arch, depth overrides, cut): published widths, depth cut to fit one card
FAMILIES = (
    ("mamba2-1.3b", {}, "whole: 48 layers"),
    ("llama-3.2-vision-11b", {},
     "whole text decoder: 40 layers (8 cross-attention), vision_seq 1601 x "
     "7680 (the stub frontend's patch embeddings)"),
    ("mixtral-8x22b", {"n_layers": 2}, "n_layers 2 of 56"),
    ("jamba-v0.1-52b", {"n_layers": 8},
     "one period: n_layers 8 of 32 (1 attention, 7 Mamba-2, 4 MoE)"),
    ("deepseek-v3-671b", {"n_layers": 2, "n_dense_layers": 1},
     "n_layers 2 of 61: one dense layer, one layer of 256 experts"),
)


def _attention_layers(model):
    """(flash launches, plain attention calls) of one prefill: MLA layers
    go plain (``Dv != D``), every other self- and cross-attention layer
    through the kernel."""
    n = sum(g.count * sum(d.mixer in ("attn", "cross") for d in g.descs)
            for g in model.groups)
    mla = sum(g.count * sum(d.mixer == "attn" for d in g.descs)
              for g in model.groups) if model.cfg.use_mla else 0
    return n - mla, mla


def _family_batch(cfg, seed):
    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab, (SERVE_B, SERVE_PROMPT), dtype=np.int32)).to(DEV)}
    if cfg.family == "vlm":
        g = torch.Generator(device=DEV).manual_seed(seed)
        batch["vision_embeds"] = torch.randn(
            (SERVE_B, cfg.vision_seq, cfg.vision_dim), generator=g,
            device=DEV).to(torch.bfloat16)
    return batch


def _widen_(tree):
    """Every floating leaf of a nested dict of tensors to f32, in place,
    one leaf at a time (the bf16 leaf freed as its copy is made)."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _widen_(v)
        elif v.is_floating_point() and v.dtype != torch.float32:
            tree[k] = v.float()
            del v


def _decode_vs_reforward(model, params, batch, logits, caches, scale):
    """Check (b): ``SERVE_NEW`` greedy cached decode steps, each step's
    logits against the last row of a full re-forward of every token so
    far, within 2^-4 of ``scale`` (the largest prefill logit)."""
    tol = 2.0 ** -4 * scale
    caches = grow_caches(model, caches, SERVE_NEW)
    toks = batch["tokens"]
    worst, under_margin, steps, greedy = 0.0, 0, [], []
    for i in range(SERVE_NEW):
        tok = torch.argmax(logits[:, -1, :], dim=-1)[:, None]
        greedy.append(tok)
        toks = torch.cat([toks, tok.to(toks.dtype)], dim=1)
        logits, caches = model.decode_step(params, caches, tok,
                                           SERVE_PROMPT + i)
        full, _ = model.forward(params, dict(batch, tokens=toks))
        ref_last = full[:, -1, :].float()
        del full
        dec = logits[:, -1, :].float()
        assert bool(torch.isfinite(dec).all()), ("decode logits", i)
        err = float((dec - ref_last).abs().max())
        top2 = torch.topk(ref_last, 2, dim=-1).values
        margin = top2[:, 0] - top2[:, 1]
        same = torch.argmax(dec, -1) == torch.argmax(ref_last, -1)
        decided = margin > tol
        under_margin += int((~decided).sum())
        assert bool(same[decided].all()), ("greedy token", i, err)
        assert err <= tol, (model.cfg.name, "decode vs re-forward", i, err,
                            tol)
        worst = max(worst, err)
        steps.append(err)
    return {"steps": SERVE_NEW, "max_abs_err_by_step": steps,
            "max_abs_err": worst, "tolerance": tol,
            "tolerance_rule": "2^-4 of the largest prefill logit",
            "rows": SERVE_NEW * SERVE_B, "rows_under_margin": under_margin,
            "greedy": torch.cat(greedy, dim=1).cpu().numpy()}


def serve_family(arch, overrides, cut, smi, seed):
    """One family at published width through ``Engine.generate`` (bf16,
    seeded weights): a warm-up, the timed call of ``SERVE_NEW`` tokens, (a)
    kernel vs plain prefill where the kernel runs, one prefill + 4 decode
    steps under the profiler, then (b) cached decode vs full re-forwards in
    f32 (MoE at a capacity that drops nothing)."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_family = time.perf_counter()
    cfg = get_config(arch).with_(**overrides)
    model = build_model(cfg)
    params = model.init_params(torch.Generator(device=DEV).manual_seed(seed),
                               DEV)
    batch = _family_batch(cfg, seed)
    eng = Engine(cfg, params, device=DEV)
    eng.generate(batch, max_new=2)                 # warm-up
    torch.cuda.synchronize()
    flash_mod.reset_launches()
    attn_mod.reset_counts()
    gen, stats = eng.generate(batch, max_new=SERVE_NEW)
    launches = {"launches_wgmma": flash_mod.launches_wgmma,
                "launches_fma": flash_mod.launches_fma}
    plain_calls = attn_mod.attention_plain_calls
    peak = torch.cuda.max_memory_allocated()
    n_kernel, n_plain = _attention_layers(model)
    assert gen.shape == (SERVE_B, SERVE_NEW)
    assert ((gen >= 0) & (gen < cfg.vocab)).all()
    assert launches == {"launches_wgmma": n_kernel, "launches_fma": 0}, \
        (arch, launches, n_kernel)
    assert plain_calls == n_plain, (arch, plain_calls, n_plain)

    out = {"arch": arch, "cut": cut, "gpu": smi,
           "n_layers": cfg.n_layers, "n_params": model.n_params(),
           "n_active_params": model.n_active_params(), "dtype": "bfloat16",
           "batch": SERVE_B, "prompt": SERVE_PROMPT, "max_new": SERVE_NEW,
           "capacity_factor": cfg.capacity_factor if cfg.n_experts else None,
           "prefill_s": stats.prefill_s, "decode_s": stats.decode_s,
           "decode_ms_per_step": stats.decode_s / SERVE_NEW * 1e3,
           "tokens_per_s": SERVE_B * SERVE_NEW / stats.decode_s,
           "prefill_tokens_per_s": SERVE_B * SERVE_PROMPT / stats.prefill_s,
           "max_memory_allocated": peak,
           "launches": {"flash_attention": flash_mod.launches, **launches},
           "attention_plain_calls": plain_calls}

    with torch.no_grad():
        logits_k, _ = model.prefill(params, batch)
        scale = float(logits_k.float().abs().max())
        assert bool(torch.isfinite(logits_k.float()).all()), arch
        # (a) prefill through the kernel == prefill through the plain version
        if n_kernel:
            logits_p, _ = _plain_prefill(model, params, batch)
            tol_a = 8 * _bf16_ulp(scale)
            err_a = float((logits_k.float() - logits_p.float()).abs().max())
            assert err_a <= tol_a, (arch, "prefill kernel vs plain", err_a,
                                    tol_a)
            out["check_a_prefill_kernel_vs_plain"] = {
                "max_abs_err": err_a, "tolerance": tol_a,
                "logits_max_abs": scale,
                "tolerance_rule": "8 bf16 ulps at the largest logit"}
            del logits_p
        del logits_k

    # one prefill + 4 decode steps under the profiler; the idle share
    # against the same work's wall time without it (median of three)
    torch.cuda.synchronize()
    walls = []
    for _ in range(3):
        w0 = time.perf_counter()
        eng.generate(batch, max_new=4)
        walls.append(time.perf_counter() - w0)
    wall = float(np.median(walls))
    _, prof = _profiled(lambda: eng.generate(batch, max_new=4))
    prof.update(wall_s=wall, wall_s_runs=walls,
                device_idle_share=1.0 - prof["device_busy_s"] / wall)
    for key in ("masked_first_fit", "match_segment", "segmented_rank",
                "segmented_order", "flash_kernel"):
        prof.pop(key + "_device_us_per_launch")
    out["profile_prefill_plus_4_decode"] = prof
    del eng

    # (b) cached decode == full re-forward, in f32 (the bf16 weights
    # widened, exactly): in bf16 a rounding apart flips a near-tied MoE
    # route, and a random Mamba-2 stack amplifies bf16 rounding past the
    # bound in the reference as in the port — neither says anything of the
    # cache.  MoE at capacity_factor = n_experts / top_k, where no token
    # can be dropped (decode's N = 4 and the re-forward's N = 4224 have
    # other capacities otherwise)
    _widen_(params)
    batch = {k: v.float() if v.is_floating_point() else v
             for k, v in batch.items()}
    cf_b = cfg.n_experts / cfg.top_k if cfg.n_experts else None
    model_b = build_model(cfg.with_(capacity_factor=cf_b) if cf_b else cfg)
    torch.backends.cuda.matmul.allow_tf32 = False
    with torch.no_grad():
        logits, caches = model_b.prefill(params, batch)
        check_b = _decode_vs_reforward(model_b, params, batch, logits,
                                       caches, float(logits.abs().max()))
        del caches, logits
    check_b.pop("greedy")
    check_b.update(capacity_factor=cf_b, dtype="float32")
    out["check_b_decode_vs_reforward"] = check_b
    out["sample_tokens"] = gen[0][:12].tolist()
    out["family_wall_s"] = time.perf_counter() - t_family
    del params, batch, model, model_b
    torch.cuda.empty_cache()
    return out


def phase_serve_families(smi):
    """The five configurations the dense slice could not run, served one
    at a time (each freed before the next)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = [serve_family(arch, ov, cut, smi, seed=10 + i)
            for i, (arch, ov, cut) in enumerate(FAMILIES)]
    out = {"families": rows, "gpu": smi,
           "launches_wgmma": sum(r["launches"]["launches_wgmma"]
                                 for r in rows),
           "attention_plain_calls": sum(r["attention_plain_calls"]
                                        for r in rows)}
    emit("serve_families", out)
    return out


# --------------------------------------------------------------------------- #
# 10. training: gradients through the flash kernel, then the trainer
# --------------------------------------------------------------------------- #

TRAIN_B, TRAIN_T, TRAIN_STEPS = 4, 1024, 6
# dq, dk, dv of FlashAttentionFn vs autograd through the plain version,
# relative to each gradient's largest magnitude
FLASH_GRAD_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@contextlib.contextmanager
def _attention_route(route: str):
    """``chunked_attention``'s differentiable route swapped for one block:
    ``"plain"`` — autograd through the plain version, forward and backward
    (how the reference trains); ``"wrapper"`` — the kernel's wrapper called
    as it was before ``FlashAttentionFn`` (an output with no ``grad_fn``)."""
    saved = flash_mod.FlashAttentionFn

    class Route:
        @staticmethod
        def apply(q, k, v, causal, window, q_offset):
            fn = (flash_mod.flash_attention_plain if route == "plain"
                  else flash_mod.flash_attention)
            return fn(q, k, v, causal=causal, window=window,
                      q_offset=q_offset)
    flash_mod.FlashAttentionFn = Route
    try:
        yield
    finally:
        flash_mod.FlashAttentionFn = saved


def check_flash_grad(dtype, seed, timed=False):
    """``FlashAttentionFn`` at the serve and train shape against autograd
    through the plain version, on the same inputs and output gradient."""
    B, T, H, Hkv, D = TRAIN_B, TRAIN_T, 32, 8, 64
    g = torch.Generator(device=DEV).manual_seed(seed)
    q = torch.randn((B, T, H, D), generator=g, device=DEV).to(dtype)
    k = torch.randn((B, T, Hkv, D), generator=g, device=DEV).to(dtype)
    v = torch.randn((B, T, Hkv, D), generator=g, device=DEV).to(dtype)
    do = torch.randn((B, T, H, D), generator=g, device=DEV).to(dtype)
    ins = [t.detach().requires_grad_(True) for t in (q, k, v)]

    def fn_fwd_bwd():
        out = flash_mod.FlashAttentionFn.apply(*ins, True, 0, 0)
        return out, torch.autograd.grad(out, ins, do)

    def plain_fwd_bwd():
        out = flash_mod.flash_attention_plain(*ins, causal=True)
        return out, torch.autograd.grad(out, ins, do)
    out_k, got = fn_fwd_bwd()
    out_p, want = plain_fwd_bwd()
    torch.cuda.synchronize()
    row = {"B": B, "T": T, "S": T, "H": H, "Hkv": Hkv, "D": D,
           "causal": True, "dtype": str(dtype).removeprefix("torch."),
           "route": flash_mod.flash_route(dtype, D),
           "forward_max_abs_err": float((out_k - out_p).detach().float()
                                        .abs().max()),
           "tolerance": FLASH_GRAD_TOL[dtype],
           "tolerance_rule": "max |d_fn - d_plain| / max |d_plain| per "
                             "gradient"}
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert bool(torch.isfinite(a.float()).all()), (name, dtype)
        rel = float((a.float() - b.float()).abs().max()) \
            / float(b.float().abs().max())
        row[name + "_rel_err"] = rel
        assert rel <= FLASH_GRAD_TOL[dtype], row
    if timed:
        qt, kt, vt = (t.detach().transpose(1, 2).requires_grad_(True)
                      for t in (q, k, v))
        dot = do.transpose(1, 2)

        def sdpa_fwd_bwd():
            out = torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True)
            return torch.autograd.grad(out, (qt, kt, vt), dot)

        def kernel_fwd():
            with torch.no_grad():
                return flash_mod.flash_attention(q, k, v, causal=True)
        ms = time_interleaved({"fn": fn_fwd_bwd, "kernel_fwd": kernel_fwd,
                               "plain": plain_fwd_bwd,
                               "library": sdpa_fwd_bwd},
                              reps={"fn": 3, "kernel_fwd": 20, "plain": 3,
                                    "library": 10})
        # forward 4·D a valid (query, key) pair and head, the backward's
        # four products 8·D: 12·D; bytes: q, k, v, do read, dq, dk, dv and
        # the output written, once each
        pairs = B * H * valid_pairs(T, T, True, 0, 0)
        flops = 12 * D * pairs
        nbytes = 2 * (2 * q.numel() + k.numel() + v.numel()) \
            * q.element_size()
        t_ops = flops / PEAK_BF16_FLOPS * 1e3
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        row.update(fwd_bwd_ms=ms["fn"], kernel_fwd_ms=ms["kernel_fwd"],
                   backward_ms=ms["fn"] - ms["kernel_fwd"],
                   plain_fwd_bwd_ms=ms["plain"],
                   library_fwd_bwd_ms=ms["library"],
                   library="scaled_dot_product_attention(is_causal, "
                           "enable_gqa) forward + backward",
                   timing_runs=ms["runs"], bound_flops=flops,
                   bound_ms=max(t_ops, t_bytes),
                   bound_by="operations" if t_ops >= t_bytes else "bytes")
    return row


def _grads_vs_plain(model, params, batch, leaf_tol):
    """Loss and gradients with attention in the kernel (FlashAttentionFn)
    against attention in the plain version; per-leaf errors relative to the
    plain gradient's largest magnitude."""
    flash_mod.reset_launches()
    loss_k, grads_k = value_and_grad(model.loss_fn, params, batch)
    launches = {"launches_wgmma": flash_mod.launches_wgmma,
                "launches_fma": flash_mod.launches_fma,
                "backward_plain_calls": flash_mod.backward_plain_calls}
    with _attention_route("plain"):
        loss_p, grads_p = value_and_grad(model.loss_fn, params, batch)
    rel = {}
    for (path, a), b in zip(tree_util.leaves_with_path(grads_k),
                            tree_util.leaves(grads_p)):
        assert bool(torch.isfinite(a.float()).all()), path
        scale = float(b.float().abs().max())
        rel["/".join(map(str, path))] = \
            float((a.float() - b.float()).abs().max()) / max(scale, 1e-30)
    worst = max(rel, key=rel.get)
    assert rel[worst] <= leaf_tol, (worst, rel[worst], leaf_tol)
    return loss_k, loss_p, grads_p, rel, launches


def phase_train_checks():
    """Gradients through the hand-written flash kernel on the card:
    ``FlashAttentionFn`` alone at the serve shape (bf16 and f32), then the
    loss and every gradient leaf of llama3.2-1b at full width on one
    1024-token batch of ``SyntheticLM`` with attention in the kernel,
    against the same with attention in the plain version — bf16 at all 16
    layers (the tensor-core route), f32 at 2 layers (the FMA route) — and
    the f32 model once more through the bare wrapper, whose output has no
    ``grad_fn``: the fault ``FlashAttentionFn`` fixes."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    flash_rows = [check_flash_grad(torch.bfloat16, 400, timed=True),
                  check_flash_grad(torch.float32, 401)]
    torch.cuda.empty_cache()
    data = SyntheticLM(vocab=128256, seq_len=TRAIN_T, seed=0)
    batch = {k: torch.from_numpy(v).to(DEV)
             for k, v in data.batch(1, seed=0).items()}
    out = {"flash_attention_fn": flash_rows}
    for dtype, layers, tol in (("bfloat16", 16, 2.0 ** -4),
                               ("float32", 2, 1e-4)):
        cfg = get_config("llama3.2-1b").with_(n_layers=layers, dtype=dtype)
        model = build_model(cfg)
        # the parameters are declared bf16 (as in the reference); the f32
        # run casts the same seeded values
        params = tree_util.map(
            lambda t: t.to(getattr(torch, dtype)),
            model.init_params(torch.Generator(device=DEV).manual_seed(0), DEV))
        loss_k, loss_p, grads_p, rel, launches = _grads_vs_plain(
            model, params, batch, tol)
        loss_err = abs(float(loss_k) - float(loss_p))
        row = {"arch": cfg.name, "dtype": dtype, "n_layers": layers,
               "n_params": model.n_params(), "batch": [1, TRAIN_T],
               "loss_kernel": float(loss_k), "loss_plain": float(loss_p),
               "loss_abs_err": loss_err, "leaf_rel_err": rel,
               "max_leaf_rel_err": max(rel.values()),
               "leaf_tolerance": tol, "launches": launches}
        route = "wgmma" if dtype == "bfloat16" else "fma"
        assert launches["launches_" + route] == layers, launches
        assert launches["backward_plain_calls"] == layers, launches
        if dtype == "bfloat16":
            row["loss_tolerance"] = 8 * _bf16_ulp(float(loss_p))
            assert loss_err <= row["loss_tolerance"], row
        else:
            # without FlashAttentionFn: the kernel's output carries no
            # gradient, so wq, wk and wv get none — a relative error of 1
            with _attention_route("wrapper"):
                _, grads_w = value_and_grad(model.loss_fn, params, batch)
            lost = {}
            for (path, a), b in zip(tree_util.leaves_with_path(grads_w),
                                    tree_util.leaves(grads_p)):
                if path[-1] in ("wq", "wk", "wv"):
                    assert float(a.abs().max()) == 0.0, path
                    lost["/".join(map(str, path))] = float(
                        (a - b).abs().max() / b.abs().max())
            assert lost and min(lost.values()) > tol, lost
            row["without_fn_wqkv_rel_err"] = lost
            del grads_w
        out[f"llama3.2-1b_{dtype}_{layers}_layers"] = row
        del params, grads_p
        torch.cuda.empty_cache()
    out["llama-3.2-vision-11b_bfloat16_5_layers"] = _vision_grads_vs_plain()
    out["phase_wall_s"] = time.perf_counter() - t_phase
    emit("train_checks", out)
    return out


def _vision_grads_vs_plain():
    """llama-3.2-vision-11b at full width, one period (4 self-attention
    layers and the cross-attention layer), bf16: the loss and every
    gradient leaf with attention in the kernel against the plain route, on
    one 1024-token batch with seeded vision embeddings.  The cross layer
    holds ``FlashAttentionFn`` on the bidirectional ``T 1024, S 1601``
    shape."""
    cfg = get_config("llama-3.2-vision-11b").with_(n_layers=5)
    model = build_model(cfg)
    params = model.init_params(torch.Generator(device=DEV).manual_seed(1),
                               DEV)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=TRAIN_T, seed=1)
    batch = {k: torch.from_numpy(v).to(DEV)
             for k, v in data.batch(1, seed=0).items()}
    g = torch.Generator(device=DEV).manual_seed(1)
    batch["vision_embeds"] = torch.randn(
        (1, cfg.vision_seq, cfg.vision_dim), generator=g,
        device=DEV).to(torch.bfloat16)
    tol = 2.0 ** -4
    loss_k, loss_p, grads_p, rel, launches = _grads_vs_plain(
        model, params, batch, tol)
    assert launches == {"launches_wgmma": cfg.n_layers, "launches_fma": 0,
                        "backward_plain_calls": cfg.n_layers}, launches
    loss_err = abs(float(loss_k) - float(loss_p))
    row = {"arch": cfg.name, "dtype": "bfloat16", "n_layers": cfg.n_layers,
           "cut": "one period of 5 (4 self-attention, 1 cross-attention) "
                  "of 40 layers",
           "n_params": model.n_params(), "batch": [1, TRAIN_T],
           "vision": [1, cfg.vision_seq, cfg.vision_dim],
           "cross_attention_shape": "T 1024, S 1601, H 32, Hkv 8, D 128, "
                                    "bidirectional",
           "loss_kernel": float(loss_k), "loss_plain": float(loss_p),
           "loss_abs_err": loss_err,
           "loss_tolerance": 8 * _bf16_ulp(float(loss_p)),
           "leaf_rel_err": rel, "max_leaf_rel_err": max(rel.values()),
           "leaf_tolerance": tol, "launches": launches}
    assert loss_err <= row["loss_tolerance"], row
    del params, grads_p
    torch.cuda.empty_cache()
    return row


def _train_bound(model, tokens, T, steps_b):
    """The least time of one AdamW step of ``model`` on ``tokens`` tokens
    (``steps_b`` sequences of ``T``): the matmuls, ``6·N·tokens`` at the bf16
    peak; attention forward and backward (``12·D`` a valid pair and head)
    at the same peak; AdamW's 22 bytes a parameter (read p, g in bf16, mu,
    nu in f32; write mu, nu, p) at the memory rate."""
    cfg = model.cfg
    n = model.n_params()
    matmul = 6 * n * tokens
    pairs = steps_b * cfg.n_heads * valid_pairs(T, T, True, 0, 0)
    attn = 12 * cfg.head_dim * pairs * cfg.n_layers
    adam_bytes = 22 * n
    parts = {"matmul_ms": matmul / PEAK_BF16_FLOPS * 1e3,
             "attention_ms": attn / PEAK_BF16_FLOPS * 1e3,
             "adamw_ms": adam_bytes / PEAK_BYTES_PER_S * 1e3}
    return sum(parts.values()), parts, {"matmul_flops": matmul,
                                        "attention_flops": attn,
                                        "adamw_bytes": adam_bytes}


def _run_cli(argv):
    """``launch.train.run`` (what ``main`` runs) with its printed log."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = train_mod.run(argv)
    return res, buf.getvalue().splitlines()


def phase_train():
    """``python -m repro_torch.launch.train`` for llama3.2-1b at full width:
    4 sequences of 1024 tokens a step, AdamW at the reference CLI's lr, 6
    steps, every attention forward in the tensor-core kernel and every
    attention backward a plain recompute; one step more under the profiler;
    then a checkpoint and resume at llama3.2-1b-smoke (the full-width state
    is 12.4 GB a save, so that run writes none)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    argv = ["--arch", "llama3.2-1b", "--batch", str(TRAIN_B),
            "--seq", str(TRAIN_T), "--steps", str(TRAIN_STEPS),
            "--lr", "3e-3", "--log-every", "1"]
    flash_mod.reset_launches()
    attn_mod.reset_counts()
    t0 = time.perf_counter()
    res, log = _run_cli(argv)
    wall = time.perf_counter() - t0
    launches = {"launches_wgmma": flash_mod.launches_wgmma,
                "launches_fma": flash_mod.launches_fma,
                "backward_plain_calls": flash_mod.backward_plain_calls}
    plain_calls = attn_mod.attention_plain_calls
    peak = torch.cuda.max_memory_allocated()
    cfg = get_config("llama3.2-1b")
    model = build_model(cfg)
    assert res["n_params"] == LLAMA_3_2_1B_PARAMS
    losses = res["losses"]
    assert len(losses) == TRAIN_STEPS and all(map(math.isfinite, losses)), \
        losses
    per_step = cfg.n_layers * TRAIN_STEPS
    assert launches == {"launches_wgmma": per_step, "launches_fma": 0,
                        "backward_plain_calls": per_step}, launches
    assert plain_calls == 0, plain_calls
    step_s = res["step_s"]
    step_ms = statistics.median(step_s[1:]) * 1e3
    tokens = TRAIN_B * TRAIN_T
    bound_ms, bound_parts, bound_work = _train_bound(model, tokens, TRAIN_T,
                                                     TRAIN_B)

    # one step more under the profiler, on the trained parameters: the
    # device's busy share and where its time goes
    data = SyntheticLM(vocab=cfg.vocab, seq_len=TRAIN_T, seed=0)
    batch = {k: torch.from_numpy(v).to(DEV)
             for k, v in data.batch(TRAIN_B, seed=TRAIN_STEPS).items()}
    opt = AdamW(lr=3e-3)
    params, state = res["params"], res["opt_state"]
    del res

    def one_step():
        loss, grads = value_and_grad(model.loss_fn, params, batch)
        return loss, opt.update(grads, state, params)
    torch.cuda.synchronize()
    w0 = time.perf_counter()
    one_step()
    torch.cuda.synchronize()
    wall_step = time.perf_counter() - w0
    w0 = time.perf_counter()
    _, prof = _profiled(one_step)
    prof.update(wall_s=wall_step,
                wall_s_under_profiler=time.perf_counter() - w0,
                device_idle_share=1.0 - prof["device_busy_s"] / wall_step)
    for key in ("masked_first_fit", "match_segment", "segmented_rank",
                "segmented_order", "flash_kernel"):
        prof.pop(key + "_device_us_per_launch")
    del params, state
    torch.cuda.empty_cache()

    # checkpoint and resume at smoke size: 4 steps saving every 2, then a
    # second call to 6 steps resumes at step 4 from the saved state
    with tempfile.TemporaryDirectory() as d:
        base = ["--arch", "llama3.2-1b-smoke", "--ckpt-dir", d,
                "--ckpt-every", "2", "--log-every", "1"]
        first, log1 = _run_cli(base + ["--steps", "4"])
        saved_steps = sorted(os.listdir(d))
        like = (first["params"], first["opt_state"])
        restored, manifest = ckpt_mod.restore(d, like)
        bit_equal = all(a.dtype == b.dtype and torch.equal(a, b)
                        for a, b in zip(tree_util.leaves(restored),
                                        tree_util.leaves(like)))
        assert bit_equal and manifest["step"] == 3, manifest["step"]
        assert int(restored[1].step) == 4
        second, log2 = _run_cli(base + ["--steps", "6"])
        assert "resumed from step 3" in log2, log2
        assert second["start"] == 4 and len(second["losses"]) == 2, second
        assert all(map(math.isfinite, first["losses"] + second["losses"]))
        assert ckpt_mod.latest_step(d) == 5
        resume = {"arch": "llama3.2-1b-smoke", "first_call_steps": 4,
                  "saved": saved_steps, "restored_bit_equal": bit_equal,
                  "restored_step": manifest["step"],
                  "second_call_start": second["start"],
                  "losses": first["losses"] + second["losses"],
                  "log": log2}
        del first, second, restored, like

    out = {
        "arch": cfg.name, "n_params": LLAMA_3_2_1B_PARAMS,
        "dtype": "bfloat16", "batch": TRAIN_B, "seq": TRAIN_T,
        "steps": TRAIN_STEPS, "optimizer": "AdamW(lr=3e-3)", "remat": False,
        "losses": losses, "step_s": step_s,
        "step_ms_median_steps_2_6": step_ms,
        "tokens_per_step": tokens, "tokens_per_s": tokens / step_ms * 1e3,
        "bound_ms": bound_ms, "bound_parts": bound_parts,
        "bound_work": bound_work, "share_of_bound": bound_ms / step_ms,
        "max_memory_allocated": peak, "wall_s": wall,
        "launches": launches, "attention_plain_calls": plain_calls,
        "log": log, "profile_one_step": prof, "resume": resume}
    emit("train", out)
    return out


def _first_step(arch, names):
    """The trainer's first step again (its seeded initial parameters and
    batch 0): the largest per-layer gradient norm of each leaf in
    ``names``, and the step's gradient (loss and backward, no update)
    under the profiler."""
    cfg = get_config(arch)
    model = build_model(cfg)
    params = model.init_params(torch.Generator(device=DEV).manual_seed(0),
                               DEV)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=TRAIN_T, seed=0)
    batch = {k: torch.from_numpy(v).to(DEV)
             for k, v in data.batch(TRAIN_B, seed=0).items()}
    _, grads = value_and_grad(model.loss_fn, params, batch)
    norms = {}
    for path, gr in tree_util.leaves_with_path(grads):
        if path[-1] in names:
            assert bool(torch.isfinite(gr.float()).all()), path
            per_layer = gr.float().flatten(1).norm(dim=1)
            norms[path[-1]] = max(norms.get(path[-1], 0.0),
                                  float(per_layer.max()))
    assert sorted(norms) == sorted(names), norms
    del grads
    torch.cuda.synchronize()
    w0 = time.perf_counter()
    value_and_grad(model.loss_fn, params, batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - w0
    _, prof = _profiled(lambda: value_and_grad(model.loss_fn, params, batch))
    prof.update(wall_s=wall,
                device_idle_share=1.0 - prof["device_busy_s"] / wall)
    for key in ("masked_first_fit", "match_segment", "segmented_rank",
                "segmented_order", "flash_kernel", "flash_wgmma_kernel"):
        prof.pop(key + "_device_us_per_launch")
    del params
    torch.cuda.empty_cache()
    return norms, prof


def phase_train_families(smi):
    """``python -m repro_torch.launch.train --arch mamba2-1.3b --batch 4
    --seq 1024``: the whole published model, 6 AdamW steps, every loss
    finite; and the first step's gradient norms of ``a_log``, ``dt_bias``
    and ``w_dt`` — the leaves the reference's chunk-256 scan makes NaN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    arch = "mamba2-1.3b"
    argv = ["--arch", arch, "--batch", str(TRAIN_B), "--seq", str(TRAIN_T),
            "--steps", str(TRAIN_STEPS), "--lr", "3e-3", "--log-every", "1"]
    flash_mod.reset_launches()
    attn_mod.reset_counts()
    t0 = time.perf_counter()
    res, log = _run_cli(argv)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    losses, step_s = res["losses"], res["step_s"]
    n_params = res["n_params"]
    del res
    torch.cuda.empty_cache()
    assert len(losses) == TRAIN_STEPS and all(map(math.isfinite, losses)), \
        losses
    # attention-free: no flash launch, no plain attention
    assert flash_mod.launches == 0 and attn_mod.attention_plain_calls == 0
    step_ms = statistics.median(step_s[1:]) * 1e3
    tokens = TRAIN_B * TRAIN_T
    norms, prof = _first_step(arch, ("a_log", "dt_bias", "w_dt"))
    out = {"arch": arch, "gpu": smi, "n_params": n_params,
           "cut": "none: 48 layers, ssm_chunk 256", "dtype": "bfloat16",
           "batch": TRAIN_B, "seq": TRAIN_T, "steps": TRAIN_STEPS,
           "optimizer": "AdamW(lr=3e-3)", "losses": losses, "step_s": step_s,
           "step_ms_median_steps_2_6": step_ms,
           "tokens_per_s": tokens / step_ms * 1e3,
           "max_memory_allocated": peak, "wall_s": wall,
           "first_step_max_layer_grad_norm": norms,
           "profile_first_step": prof, "log": log}
    emit("train_families", out)
    return out


# --------------------------------------------------------------------------- #
# 11. launch: the dry-run, its predictions against the card, elastic restart
# --------------------------------------------------------------------------- #

def _start_dryrun_sweep(tmpdir):
    """``python -m repro_torch.launch.dryrun --all`` in a child process
    (fake ``cuda:0`` tensors; it launches nothing), after every timed phase
    of the card: every supported arch × shape cell ``ok``."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = os.path.join(tmpdir, "dryrun.jsonl")
    log = open(os.path.join(tmpdir, "dryrun.log"), "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
         "--out", out], cwd=ROOT, env=env, stdout=log,
        stderr=subprocess.STDOUT, text=True)
    return proc, log, out, time.perf_counter()


def _finish_dryrun_sweep(proc, log, out, t0):
    try:
        rc = proc.wait(timeout=600)
    finally:
        proc.kill()
        log.close()
    wall = time.perf_counter() - t0
    with open(log.name) as f:
        stdout = f.read()
    assert rc == 0, stdout[-4000:]
    with open(out) as f:
        recs = [json.loads(line) for line in f]
    want = [(a, s) for a, s, _, ok in dryrun_mod.iter_cells("host") if ok]
    assert [(r["arch"], r["shape"]) for r in recs] == want, recs
    assert all(r["status"] == "ok" for r in recs), recs
    cells = [{"arch": r["arch"], "shape": r["shape"],
              "peak_gb": r["memory"]["peak_bytes_per_dev"] / 1e9,
              "fits_hbm": r["memory"]["fits_hbm"],
              "bottleneck": r["roofline"]["bottleneck"],
              "step_ms": r["roofline"]["step_time_s"] * 1e3,
              "useful_ratio": r["roofline"]["useful_ratio"],
              "flops": r["full_graph"]["flops_per_dev"],
              "bytes": r["full_graph"]["bytes_per_dev"],
              "trace_s": r["trace_s"]} for r in recs]
    return {"cells": cells, "n_cells": len(recs), "failures": 0,
            "wall_s": wall, "trace_s_sum": sum(r["trace_s"] for r in recs),
            "device": recs[0]["device"],
            "tail": stdout.splitlines()[-1]}


# (b): cells the earlier phases run — (arch, kind, batch, seq)
LAUNCH_CELLS = (("llama3.2-1b", "train", TRAIN_B, TRAIN_T),
                ("mamba2-1.3b", "train", TRAIN_B, TRAIN_T),
                ("llama3.2-1b", "prefill", SERVE_B, SERVE_PROMPT))
PEAK_RATIO = (0.8, 1.25)      # predicted / measured peak bytes


def _predicted_vs_measured(arch, kind, B, T):
    """``dryrun.run_shape`` of one cell (as the trainer and the server run
    it: no remat), then the same step once on ``cuda:0``: peak bytes
    (``max_memory_allocated`` above what was allocated before its
    arguments), step time (the second of two calls, the first a warm-up)
    and the counts."""
    shape = ShapeConfig(f"{kind}_B{B}_T{T}", T, B, kind)
    counts = (flash_mod.launches_wgmma, flash_mod.launches_fma)
    pred = dryrun_mod.run_shape(arch, shape, remat=False, verbose=False)
    assert (flash_mod.launches_wgmma, flash_mod.launches_fma) == counts, \
        "the dry-run launched a kernel"
    cfg = get_config(arch)
    model = build_model(cfg)
    gc.collect()           # nothing of an earlier phase is freed mid-step
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    params = model.init_params(torch.Generator(device=DEV).manual_seed(0),
                               DEV)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=T, seed=0)
    batch = {k: torch.from_numpy(v).to(DEV)
             for k, v in data.batch(B, seed=0).items()}
    if kind == "train":
        step, _ = make_train_step(cfg, remat=False)
        args = (params, AdamW().init(params), batch)
    else:
        step, _ = make_prefill_step(cfg)
        args = (params, {"tokens": batch["tokens"]})
    out = step(*args)                                       # warm-up
    del out
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = step(*args)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    measured = torch.cuda.max_memory_allocated() - base
    loss_or_logits = out[0].float()
    assert bool(torch.isfinite(loss_or_logits).all()), (arch, kind)
    del out, args, params, batch
    torch.cuda.empty_cache()
    roof = pred["roofline"]
    row = {"arch": arch, "kind": kind, "batch": B, "seq": T,
           "remat": False, "moe_capacity": pred.get("moe_capacity"),
           "predicted_peak_bytes": pred["memory"]["peak_bytes_per_dev"],
           "predicted_args_bytes": pred["memory"]["args_bytes_per_dev"],
           "measured_peak_bytes": measured,
           "peak_ratio": pred["memory"]["peak_bytes_per_dev"] / measured,
           "roofline_step_ms": roof["step_time_s"] * 1e3,
           "roofline_bottleneck": roof["bottleneck"],
           "roofline_compute_ms": roof["compute_s"] * 1e3,
           "roofline_memory_ms": roof["memory_s"] * 1e3,
           "measured_step_ms": step_ms,
           "counted_flops": roof["flops_per_dev"],
           "counted_bytes": roof["bytes_per_dev"],
           "analytic_model_flops": roof["model_flops"],
           "useful_ratio": roof["useful_ratio"],
           "outside_blocks": pred["outside_blocks"],
           "trace_s": pred["trace_s"]}
    if kind == "train" and arch == "llama3.2-1b":
        row["hand_bound_ms"] = _train_bound(model, B * T, T, B)[0]
    lo, hi = PEAK_RATIO
    assert lo <= row["peak_ratio"] <= hi, row
    return row


def _elastic():
    """``python -m repro_torch.launch.elastic --arch llama3.2-1b --steps
    10`` in a child process on ``cuda:0``: B 4 × T 32, the full-width
    state (12.4 GB) saved, restored bit for bit, trained on."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.elastic", "--arch",
         "llama3.2-1b", "--steps", "10"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    assert res.returncode == 0, (res.stdout[-2000:], res.stderr[-3000:])
    lines = res.stdout.splitlines()
    summary = json.loads(lines[-1].removeprefix("elastic: "))
    losses = summary["phase1_losses"] + summary["phase2_losses"]
    assert summary["restored_bit_equal"] and summary["restored_step"] == 9
    assert len(losses) == 15 and all(map(math.isfinite, losses)), losses
    layers = get_config("llama3.2-1b").n_layers
    # one launch an attention layer a step, in both phases
    assert summary["flash_launches"] == [10 * layers, 5 * layers], summary
    return dict(summary, ckpt_gb=summary["ckpt_bytes"] / 1e9, wall_s=wall,
                log=lines[:-1])


def phase_launch(smi):
    """The launch layer: (b) the dry-run's predictions against the card at
    three shapes the earlier phases run; (c) the elastic restart at
    llama3.2-1b's full width; then, when no timed phase loads the host,
    (a) the whole dry-run over every registered arch × shape cell on the
    host mesh in a child process, beside the two children of the paper
    phase (12), whose walls are therefore taken beside the sweep's."""
    torch.backends.cuda.matmul.allow_tf32 = False
    flash_mod.reset_launches()
    b = [_predicted_vs_measured(*cell) for cell in LAUNCH_CELLS]
    c = _elastic()
    records = _bench_records()
    with tempfile.TemporaryDirectory() as tmpdir:
        sweep = _start_dryrun_sweep(tmpdir)
        procs = start_paper(tmpdir)
        try:
            a = _finish_dryrun_sweep(*sweep)
            paper = finish_paper(procs, timeout=1000)
        finally:
            for proc in [sweep[0]] + [p for p, *_ in procs.values()]:
                proc.kill()
    assert _bench_records() == records, "the hot path wrote into the tree"
    print(json.dumps({"launch_dryrun_cells": [
        [c["arch"], c["shape"], round(c["peak_gb"], 3), c["fits_hbm"],
         c["bottleneck"], round(c["step_ms"], 3), round(c["useful_ratio"], 4)]
        for c in a["cells"]]}), flush=True)
    out = {"gpu": smi, "dryrun": a, "predicted_vs_measured": b,
           "elastic": c}
    emit("launch", out)
    return out, paper


# --------------------------------------------------------------------------- #
# 12. the paper's reproduction suite and the five examples
# --------------------------------------------------------------------------- #

# bench_kernels' rows at the reference's shapes: each kernel against its
# plain version, within the tolerances of the kernel line below
PAPER_TOL = {"fedavg_reduce": 1e-6, "quantize": 0.0,
             "flash_attention_wgmma": 2e-2}


# the reference's CPU records and the port's hot-path outputs at the root:
# a smoke run writes none of them
BENCH_RECORDS = ("BENCH_hotpath.json", "BENCH_history.jsonl",
                 "BENCH_torch_hotpath.json", "BENCH_torch_history.jsonl")


def _bench_records():
    out = {}
    for name in BENCH_RECORDS:
        path = os.path.join(ROOT, name)
        if os.path.exists(path):
            with open(path, "rb") as f:
                out[name] = f.read()
    return out


def _paper_counts():
    return {"match_segment": segment_mod.launches,
            "segmented_order": replan_order.launches_order,
            "quantize": quant_mod.quantize_launches,
            "dequantize": quant_mod.dequantize_launches,
            "fedavg_reduce": fedavg_mod.launches,
            "flash_attention_wgmma": flash_mod.launches_wgmma,
            "flash_attention": flash_mod.launches_fma}


def _since(before):
    return {k: v - before[k] for k, v in _paper_counts().items()}


def _paper_result(obj):
    """The child's last line: its results and its own wall from import."""
    obj["child_s"] = time.perf_counter() - T_START
    print("paper_result: " + json.dumps(obj), flush=True)


def paper_suite():
    """(a), (c), (e), in a child process with ``REPRO_BENCH_FAST=1``:
    ``python -m repro_torch.benchmarks.run``'s ``main`` over every entry on
    ``cuda:0``, each entry's wall and kernel launches; the hot path's rows
    (its report and history in ``REPRO_BENCH_OUT``, the phase's temporary
    directory), its history through the port's ``regress`` gate;
    bench_kernels' kernels against their plain versions at the reference's
    shapes."""
    from repro_torch.benchmarks import common as bench_common
    from repro_torch.benchmarks import regress
    from repro_torch.benchmarks import run as bench_run
    assert bench_common.FAST and bench_common.SEEDS == (1,) \
        and bench_common.N_JOBS == 30
    out_dir = os.environ["REPRO_BENCH_OUT"]
    assert os.path.realpath(out_dir) != os.path.realpath(ROOT), out_dir
    entries, kernels, hotpath = {}, {}, {}

    def counted(name, fn):
        def entry(device):
            before = _paper_counts()
            t0 = time.perf_counter()
            out = fn(device=device)
            torch.cuda.synchronize()
            entries[name] = {"wall_s": time.perf_counter() - t0,
                             "launches": _since(before)}
            if name == "kernels":
                kernels.update(out)
            if name == "hotpath":
                hotpath.update(out)
            return out
        return entry

    bench_run.ALL[:] = [(n, counted(n, f)) for n, f in bench_run.ALL]
    before = _paper_counts()
    t0 = time.perf_counter()
    bench_run.main(["--device", str(DEV)])        # exits 1 on a failure
    wall = time.perf_counter() - t0
    launches = _since(before)
    assert launches["match_segment"] > 0 and launches["segmented_order"] > 0, \
        launches
    assert set(entries) == {n for n, _ in bench_run.ALL}, entries
    for name, tol in PAPER_TOL.items():
        assert kernels[name]["max_abs_err"] <= tol, (name, kernels[name])
    # the hot path on the card: both scheduler kernels launched by it alone;
    # the churn row's three legs and the audit-on run identical (the row
    # functions assert it, and the replay's bit-identity, as they run)
    hot = entries["hotpath"]["launches"]
    assert hot["match_segment"] > 0 and hot["segmented_order"] > 0, hot
    assert hotpath["replan_r500_j2000"]["metrics_identical"] is True
    assert hotpath["audit_overhead"]["metrics_identical"] is True
    assert "tenx_r500_j2000" not in hotpath, "FAST skips tenx and heavy"
    history = os.path.join(out_dir, "BENCH_torch_history.jsonl")
    with open(history) as f:
        rows = [json.loads(ln) for ln in f]
    assert [r["workload"] for r in rows] == [
        "profiled_r1.5_j50", "medium_r15_j100", "replan_r500_j2000",
        "audit_overhead_paired"] and all(r["fast"] for r in rows), rows
    gate = {}
    for verb in ("check", "list"):
        print(f"\n## regress {verb}", flush=True)
        gate[verb] = regress.main([verb, "--history", history])
        assert gate[verb] == 0, (verb, gate[verb])
    _paper_result({"wall_s": wall, "launches": launches, "entries": entries,
                   "kernels": kernels, "hotpath": hotpath,
                   "regress_rc": gate})


def paper_engines_and_examples():
    """(b) and (d), in a child process with ``REPRO_BENCH_FAST=1``: Table
    1's simulations on the array drain (through ``table1_workloads.main``)
    and again on the per-device loop, on ``cuda:0``, identical; then the
    five examples, each as its ``python -m`` entry runs it, with its
    kernel launches."""
    from repro_torch.benchmarks import common as bench_common
    from repro_torch.benchmarks import table1_workloads
    from repro_torch.examples import (elastic_restart, fl_multijob_training,
                                      quickstart, scenario_tour,
                                      serve_batched)
    assert bench_common.FAST
    runs = {}
    run_sched = bench_common.run_sched

    def recorded(name, cfg, seed, pop_kw=None, device=None, engine="array",
                 **kw):
        out = run_sched(name, cfg, seed, pop_kw, device, engine, **kw)
        runs[(name, cfg.workload, seed)] = (cfg, out)
        return out

    bench_common.run_sched = recorded
    try:
        t0 = time.perf_counter()
        table1_workloads.main(device=DEV)
        array_s = time.perf_counter() - t0
    finally:
        bench_common.run_sched = run_sched
    assert len(runs) == 4 * len(table1_workloads.WORKLOADS), sorted(runs)
    python_s = 0.0
    for (name, wl, seed), (cfg, (m_arr, _, _)) in runs.items():
        m_py, wall, _ = run_sched(name, cfg, seed, device=DEV,
                                  engine="python")
        python_s += wall
        _same_run(f"table1 {wl} {name} s{seed}", m_arr, m_py,
                  skip=("degraded_segments",))
        assert len(m_arr.rounds) > 0, (wl, name)
    examples = {}
    for name, mod, argv in (
            ("quickstart", quickstart, []),
            ("scenario_tour", scenario_tour, []),
            ("serve_batched", serve_batched, []),
            ("fl_multijob_training", fl_multijob_training, []),
            ("elastic_restart", elastic_restart, [])):
        print(f"\n## example {name}", flush=True)
        before = _paper_counts()
        t0 = time.perf_counter()
        rc = mod.main(argv)
        torch.cuda.synchronize()
        assert rc in (None, 0), (name, rc)
        examples[name] = {"wall_s": time.perf_counter() - t0,
                          "launches": _since(before)}
    ex = examples
    assert ex["quickstart"]["launches"]["match_segment"] > 0, ex
    assert ex["scenario_tour"]["launches"]["match_segment"] > 0, ex
    assert ex["serve_batched"]["launches"]["flash_attention_wgmma"] > 0, ex
    # one job a requirement class, so no group holds two jobs to resort
    fl = ex["fl_multijob_training"]["launches"]
    assert all(fl[k] > 0 for k in ("quantize", "dequantize", "fedavg_reduce",
                                   "flash_attention_wgmma")), fl
    assert ex["elastic_restart"]["launches"]["flash_attention_wgmma"] > 0, ex
    assert all(e["launches"]["flash_attention"] == 0 for e in ex.values()), ex
    _paper_result({"table1_simulations": len(runs),
                   "table1_identical_across_engines": True,
                   "table1_array_s": array_s, "table1_python_s": python_s,
                   "examples": examples})


def start_paper(tmpdir):
    """The two children of the paper phase, started together: each writes
    its output to a file in ``tmpdir``, and the hot path its report and
    history there too (never into the checkout)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               REPRO_BENCH_FAST="1", REPRO_BENCH_OUT=tmpdir,
               REPRO_BENCH_HOST="chip_smoke")
    procs = {}
    for name in ("paper_suite", "paper_engines_and_examples"):
        out = open(os.path.join(tmpdir, name + ".out"), "w")
        procs[name] = (subprocess.Popen(
            [sys.executable, "-c", f"import chip_smoke; chip_smoke.{name}()"],
            cwd=ROOT, env=env, stdout=out, stderr=subprocess.STDOUT), out,
            time.perf_counter())
    return procs


def finish_paper(procs, timeout):
    """Wait for both children; print their output (the suite's rows and
    its ``*_validates`` flags as found, the examples' output) and one
    ``paper`` line."""
    result = {}
    for name, (proc, out, t0) in procs.items():
        try:
            rc = proc.wait(timeout=max(timeout - (time.perf_counter() - t0),
                                       1))
        finally:
            proc.kill()
            out.close()
        with open(out.name) as f:
            lines = f.read().splitlines()
        for line in lines[:-1]:
            print(line)
        assert rc == 0 and lines and lines[-1].startswith("paper_result: "), \
            (name, rc, lines[-40:])
        result[name] = json.loads(lines[-1].removeprefix("paper_result: "))
        if name == "paper_suite":
            rows = [ln.split(",", 2) for ln in lines]
            result["validates"] = {
                r[0]: r[2] for r in rows
                if len(r) == 3 and r[0].endswith("_validates")}
    # the FAST hot path skips heavy, so prints no hotpath_heavy_validates
    assert len(result["validates"]) == 9, result["validates"]
    emit("paper", result)
    return result


def main() -> None:
    smi = phase_env()
    ff, rk, seg = phase_kernels()
    phase_matcher()

    main_arr, main_prof = run_both(
        "main_path", _tenx_jobs,
        PopulationConfig(seed=1001, base_rate=500.0, cpu_med=1.8, mem_med=1.8),
        0.25 * 24 * 3600.0,
        "tenx_r500_j2000: base_rate 500, 2000 jobs on the high-performance "
        "tier, seed 1, 0.25 simulated days")
    dense_arr, dense_prof = run_both(
        "dense_path",
        lambda: generate_jobs(JobTraceConfig(num_jobs=200, seed=1)),
        PopulationConfig(seed=1001, base_rate=50.0),
        3.0 * 24 * 3600.0,
        "heavy_r50_j200: base_rate 50, 200 jobs, general requirement mix, "
        "seed 1, 3 simulated days (horizon cut from 30)")
    scen_sums = phase_scenarios()
    fa, qz, dq = phase_fl_kernels()
    fl_launches = phase_fl_round()
    flash_rows, flash_serve = phase_flash_kernels()
    serve = phase_serve()
    families = phase_serve_families(smi)
    train_checks = phase_train_checks()
    train = phase_train()
    phase_train_families(smi)
    launch, paper = phase_launch(smi)

    print(smi, flush=True)
    src = "src/repro_torch/accel/kernels/csrc/"

    def on_paths(name):
        """Launches and device µs a launch on both scheduler workloads."""
        return dict(
            launches=main_arr["launches"][name],
            dense_path_launches=dense_arr["launches"][name],
            main_path_device_us_per_launch=main_prof[
                name + "_device_us_per_launch"],
            dense_path_device_us_per_launch=dense_prof[
                name + "_device_us_per_launch"])

    kernels = [
        # the matcher's kernel: the TPU kernel's round loop in one launch
        dict(name="match_segment", route="cuda",
             source=src + "match_segment.cu",
             replaces="src/repro/accel/kernels/schedule_match.py:66",
             max_abs_err=max(r["max_abs_err"] for r in seg),
             ms=seg[0]["ms"], plain_ms=seg[0]["plain_ms"],
             bound_ms=seg[0]["bound_ms"], bound_by=seg[0]["bound_by"],
             library_ms=None, on_path=True, **on_paths("match_segment"),
             scenarios_launches=scen_sums["match_segment"],
             launches_grid=main_arr["launches"]["match_segment_grid"],
             dense_path_launches_grid=dense_arr["launches"][
                 "match_segment_grid"],
             shape=seg[0]["case"],
             other_shapes=[{k: r[k] for k in ("case", "route", "ms",
                                              "plain_ms", "bound_ms")}
                           for r in seg[1:]]),
        # the reference's contract form of the first-fit step, off the path
        dict(name="masked_first_fit", route="cuda",
             source=src + "masked_first_fit.cu",
             replaces="src/repro/accel/kernels/schedule_match.py:66",
             max_abs_err=max(r["max_abs_err"] for r in ff),
             ms=ff[0]["ms"], plain_ms=ff[0]["plain_ms"],
             bound_ms=ff[0]["bound_ms"], bound_by=ff[0]["bound_by"],
             library_ms=None, on_path=False, **on_paths("masked_first_fit"),
             shape="first_fit_choice n=16384 K=32 R=2048",
             other_shapes=[{k: r[k] for k in ("n", "K", "R", "ms", "plain_ms",
                                              "bound_ms")} for r in ff[1:3]]),
        # the replan's resort: ranks and permutation in one launch
        dict(name="segmented_order", route="cuda",
             source=src + "segmented_rank.cu",
             replaces="src/repro/accel/kernels/replan_order.py:68",
             max_abs_err=max(r["order_max_abs_err"] for r in rk),
             ms=rk[0]["order_ms"], plain_ms=rk[0]["order_plain_ms"],
             bound_ms=rk[0]["order_bound_ms"],
             bound_by=rk[0]["order_bound_by"], library_ms=None, on_path=True,
             **on_paths("segmented_order"),
             scenarios_launches=scen_sums["segmented_order"],
             fl_round_launches=fl_launches["segmented_order"],
             shape="n=2000, one segment (no segment ids), f64 keys",
             other_shapes=[{k: rk[1][k] for k in (
                 "n", "segments", "order_ms", "order_plain_ms",
                 "order_bound_ms")}]),
        # the reference's contract form of the rank, off the path
        dict(name="segmented_rank", route="cuda",
             source=src + "segmented_rank.cu",
             replaces="src/repro/accel/kernels/replan_order.py:68",
             max_abs_err=max(r["max_abs_err"] for r in rk),
             ms=rk[0]["ms"], plain_ms=rk[0]["plain_ms"],
             bound_ms=rk[0]["bound_ms"], bound_by=rk[0]["bound_by"],
             library_ms=None, on_path=False, **on_paths("segmented_rank"),
             shape="n=2000, one segment, f64 keys",
             other_shapes=[{k: rk[1][k] for k in ("n", "segments", "ms",
                                                  "plain_ms", "bound_ms")}]),
    ]
    fl_src = "src/repro_torch/kernels/csrc/"
    fl_shape = f"N={FL_BIG_N} (llama3.2-1b's largest leaf)"
    for name, source, replaces, rows, shape in (
            ("fedavg_reduce", "fedavg_reduce.cu",
             "src/repro/kernels/fedavg_reduce.py:61", fa,
             f"K=8 {fl_shape} f32"),
            ("quantize", "quantize.cu", "src/repro/kernels/quantize.py:40", qz,
             f"{fl_shape} block=256"),
            ("dequantize", "quantize.cu", "src/repro/kernels/quantize.py:60",
             dq, f"{fl_shape} block=256 to f32")):
        kernels.append(dict(
            name=name, route="cuda", source=fl_src + source, replaces=replaces,
            launches=fl_launches[name],
            max_abs_err=max(r["max_abs_err"] for r in rows
                            if r.get("dtype", "float32") == "float32"),
            ms=rows[0]["ms"], plain_ms=rows[0]["plain_ms"],
            bound_ms=rows[0]["bound_ms"], bound_by=rows[0]["bound_by"],
            library_ms=rows[0]["library_ms"], shape=shape))
    wgmma_rows = [r for r in flash_rows + [flash_serve]
                  if r["route"] == "wgmma"]
    fma_rows = [r for r in flash_rows if r["route"] == "fma"]
    flash_common = dict(
        replaces="src/repro/kernels/flash_attention.py:90",
        plain_ms=flash_serve["plain_ms"], bound_ms=flash_serve["bound_ms"],
        bound_by=flash_serve["bound_by"],
        library_ms=flash_serve["library_ms"],
        shape=f"B={SERVE_B} T=S={SERVE_PROMPT} H=32 Hkv=8 D=64 causal bf16")
    fn_grad = train_checks["flash_attention_fn"][0]
    kernels.append(dict(
        name="flash_attention_wgmma", route="cuda",
        source=fl_src + "flash_attention_wgmma.cu",
        launches=serve["launches"]["launches_wgmma"],
        families_launches=families["launches_wgmma"],
        train_launches=train["launches"]["launches_wgmma"],
        train_backward_plain_calls=train["launches"]["backward_plain_calls"],
        elastic_launches=sum(launch["elastic"]["flash_launches"]),
        fl_round_launches=fl_launches["flash_attention_wgmma"],
        train_shape_fwd_bwd_ms=fn_grad["fwd_bwd_ms"],
        train_shape_backward_ms=fn_grad["backward_ms"],
        train_shape_plain_fwd_bwd_ms=fn_grad["plain_fwd_bwd_ms"],
        train_shape_library_fwd_bwd_ms=fn_grad["library_fwd_bwd_ms"],
        train_shape_fwd_bwd_bound_ms=fn_grad["bound_ms"],
        max_abs_err=max(r["max_abs_err"] for r in wgmma_rows),
        ms=flash_serve["ms"], **flash_common,
        direct_ms=flash_serve["direct_ms"],
        tflops=flash_serve["tflops"],
        share_of_bound=flash_serve["share_of_bound"],
        main_path_device_us_per_launch=serve[
            "profile_prefill_plus_4_decode"][
            "flash_wgmma_kernel_device_us_per_launch"],
        dtypes="bf16"))
    # the FMA kernel: the f32 route, off the bf16 serve path; its time and
    # error here are on the serve shape's bf16 inputs
    kernels.append(dict(
        name="flash_attention", route="cuda",
        source=fl_src + "flash_attention.cu",
        launches=serve["launches"]["launches_fma"],
        train_launches=train["launches"]["launches_fma"],
        fl_round_launches=fl_launches["flash_attention"],
        max_abs_err=max(r["max_abs_err"] for r in fma_rows),
        ms=flash_serve["fma_ms"], **flash_common,
        tflops=flash_serve["fma_tflops"],
        on_path=False, dtypes="f32",
        bf16_max_abs_err=flash_serve["fma_max_abs_err"]))
    # the paper phase: launches over the FAST suite and over the five
    # examples; bench_kernels' rows at the reference's shapes
    # (``paper_suite_launches`` counts the hot path's too, and
    # ``paper_hotpath_launches`` those alone)
    suite = paper["paper_suite"]
    examples = paper["paper_engines_and_examples"]["examples"].values()
    timing = suite["entries"]["kernels"]["launches"]   # the bench's own
    hotpath = suite["entries"]["hotpath"]["launches"]
    for k in kernels:
        if k["name"] in suite["launches"]:
            k.update(paper_suite_launches=suite["launches"][k["name"]]
                     - timing[k["name"]],
                     paper_hotpath_launches=hotpath[k["name"]],
                     paper_examples_launches=sum(
                         e["launches"][k["name"]] for e in examples))
        bench = suite["kernels"].get(k["name"])
        if bench is not None:
            k.update(paper_kernels_max_abs_err=bench["max_abs_err"],
                     paper_kernels_ms=bench["kernel_us"] / 1e3,
                     paper_kernels_plain_ms=bench["plain_us"] / 1e3)
    # f32 rows; bf16 rows (fedavg_reduce's, flash_attention_wgmma's): 2e-2
    tolerance = {"fedavg_reduce": 1e-6, "flash_attention": 2e-6,
                 "flash_attention_wgmma": 2e-2}
    for k in kernels:
        # a kernel off its path (a contract form kept for parity with the
        # reference, the f32 flash route) is exempt, and for that only
        assert k["launches"] > 0 or k.get("on_path") is False, k
        assert k["max_abs_err"] <= tolerance.get(k["name"], 0), k
    emit("total_seconds", time.perf_counter() - T_START)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
