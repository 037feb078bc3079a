"""The one-launch matcher (``accel/kernels/match_segment.py``) on the CPU.

On the CPU the wrapper runs its plain version (the gather, the f64
eligibility and ``match_fixed_point``), so these tests hold it — through the
same staging buffers the card uses, on rows of a bound chunk picked by
``start`` and a live-row list — against the reference's jitted fixed point
with the Pallas first-fit in interpret mode (``match_chunk_jax(...,
use_kernel=True)``) and its sequential oracle, and hold the round count
against an independent NumPy fixed point that finds each request's fill
position by a per-request scan.  The launch itself is checked with a
stand-in library (no kernel runs on the CPU): one call, one launch, the
right pointers, sizes and layout, the counters, a refused launch raising.
The kernel is held against the plain version on the card by
``chip_smoke.py``.  Outputs are integers and booleans: every comparison is
exact.
"""
import math

import numpy as np
import pytest
import torch

from repro.accel.engine import (match_chunk_jax as ref_match_chunk_jax,
                                match_chunk_seq as ref_match_chunk_seq)
from repro.accel.state import MatchState as RefMatchState
from repro_torch.accel import engine as engine_mod
from repro_torch.accel.engine import DeviceMatchError, match_chunk_torch
from repro_torch.accel.kernels import build
from repro_torch.accel.kernels import match_segment as ms
from repro_torch.accel.kernels.stage import PinnedStage, stage_for
from repro_torch.accel.state import match_state_from_numpy
from torch_parity import (CPU, FakeReq, FakeSched, random_segment,
                          random_slots, state_arrays)


def _rounds_numpy(reqix, elig, rem):
    """The fixed point's round count and choices, each request's fill
    position found by scanning its choosers (no sort, no ranks)."""
    n, R = len(reqix), len(rem)
    safe = np.where(reqix >= 0, reqix, 0)
    pos = np.arange(n)
    fill = np.where(rem > 0, n, -1)
    for it in range(1, R + 3):
        avail = elig & (fill[safe] >= pos[:, None])
        choice = np.where(avail.any(1), reqix[pos, avail.argmax(1)], -1)
        new = np.where(rem > 0, n, -1)
        for r in range(R):
            who = np.flatnonzero(choice == r)
            if 0 < rem[r] <= len(who):
                new[r] = who[rem[r] - 1]
        if np.array_equal(new, fill):
            return it, choice
        fill = new
    raise AssertionError("the NumPy fixed point did not settle")


def _chunk(rng, aids, speeds, covered, every):
    """A chunk holding the segment's rows at ``start + live`` between rows
    that are not live (``every`` = 1: the rows back to back, no list)."""
    n = len(aids)
    start = int(rng.integers(0, 5))
    live = np.arange(n) * every + (every - 1) if every > 1 else None
    m = start + (int(live[-1]) + 1 if live is not None else n) + 3
    ids = rng.choice(covered, size=m).astype(np.int32)
    sp = rng.uniform(0, 3, size=m)
    rows = start + (live if live is not None else np.arange(n))
    ids[rows], sp[rows] = aids, speeds
    return torch.from_numpy(ids), torch.from_numpy(sp), start, live


def _check_against_reference(ref_state, aids, speeds, every, seed):
    state = match_state_from_numpy(state_arrays(ref_state), CPU)
    rng = np.random.default_rng(seed)
    ids_d, sp_d, start, live = _chunk(
        rng, aids, speeds, np.flatnonzero(ref_state.covered), every)
    ms.reset_launches()
    got = ms.match_segment(state.d_cand_req, state.d_cand_lo,
                           state.d_cand_hi, ids_d, sp_d, state.remaining,
                           n=len(aids), start=start, live=live)
    assert ms.launches == 0                   # the CPU never launches
    assert got.settled and got.choice.dtype == np.int32
    want = ref_match_chunk_jax(aids, speeds, ref_state, use_kernel=True)
    assert np.array_equal(got.choice, want.choice)
    assert np.array_equal(got.granted, want.granted)
    seq = ref_match_chunk_seq(aids, speeds, ref_state)
    assert np.array_equal(got.choice, seq.choice)
    assert np.array_equal(got.granted, seq.granted)
    reqix = ref_state.cand_req[aids]
    sp = speeds[:, None]
    elig = (reqix >= 0) & (ref_state.cand_lo[aids] <= sp) \
        & (sp < ref_state.cand_hi[aids])
    rounds, choice = _rounds_numpy(reqix, elig, ref_state.remaining)
    assert got.rounds == rounds
    assert np.array_equal(got.choice, choice)
    return got


@pytest.mark.parametrize("seed", range(24))
def test_match_segment_equals_reference_on_random_states(seed):
    rng = np.random.default_rng(500 + seed)
    while True:             # the first seeded state with a request to match
        ref_state = RefMatchState.from_scheduler(
            FakeSched(random_slots(rng)), token=("t",), kcap=8)
        aids, speeds = random_segment(rng, ref_state, 1 + 5 * seed % 60)
        if aids is not None and len(ref_state.remaining):
            break
    _check_against_reference(ref_state, aids, speeds, 1 + seed % 3, seed)


def _wide_slots(rng, atoms, K, R, demand, band=0.3):
    reqs = [FakeReq(int(d)) for d in demand]
    perm = rng.permutation(R)
    slots = []
    for a in range(atoms):
        row = []
        for j in range(K):
            r = perm[(a * K + j) % R]
            if rng.uniform() < band:
                lo, hi = sorted(rng.uniform(0, 3, 2))
            else:
                lo, hi = -math.inf, math.inf
            row.append((reqs[int(r)], float(lo), float(hi)))
        slots.append(row)
    return slots


@pytest.mark.parametrize("case", ["K130", "R2100", "ineligible",
                                  "rem_zeros", "contended"])
def test_match_segment_equals_reference_on_wide_states(case):
    rng = np.random.default_rng({"K130": 1, "R2100": 2, "ineligible": 3,
                                 "rem_zeros": 4, "contended": 5}[case])
    atoms, K, R, n = {"K130": (3, 130, 200, 64), "R2100": (70, 32, 2100, 48),
                      "ineligible": (4, 16, 40, 30),
                      "rem_zeros": (6, 12, 30, 80),
                      "contended": (5, 40, 60, 120)}[case]
    demand = rng.integers(1, 4, R)
    if case == "rem_zeros":
        demand[::2] = 0                       # filled before the segment
    slots = _wide_slots(rng, atoms, K, R, demand)
    if case == "ineligible":                  # every band excludes [0, 3)
        slots = [[(r, 5.0, 6.0) for r, _, _ in row] for row in slots]
    ref_state = RefMatchState.from_scheduler(FakeSched(slots), token=("w",),
                                             kcap=K)
    assert ref_state.cand_req.shape[1] == K
    assert len(ref_state.remaining) == R
    aids = rng.integers(0, atoms, size=n)
    speeds = rng.uniform(0, 3, size=n)
    got = _check_against_reference(ref_state, aids, speeds, 2, 77)
    if case == "ineligible":
        assert (got.choice == -1).all() and got.rounds == 1
    if case == "rem_zeros":
        zero = np.flatnonzero(ref_state.remaining == 0)
        assert len(zero) == R // 2
        assert not np.isin(got.choice, zero).any() and got.granted.any()
    if case == "contended":
        assert got.rounds > 1 and not got.granted.all()


def test_match_chunk_torch_reads_live_rows_out_of_the_bound_chunk():
    """The engine's entry on a bound chunk with ``start`` and a live-row
    list equals the same entry on the rows themselves."""
    rng = np.random.default_rng(9)
    ref_state = RefMatchState.from_scheduler(
        FakeSched(_wide_slots(rng, 4, 10, 12, rng.integers(1, 3, 12))),
        token=("t",), kcap=10)
    state = match_state_from_numpy(state_arrays(ref_state), CPU)
    aids, speeds = rng.integers(0, 4, 40), rng.uniform(0, 3, 40)
    ids_d, sp_d, start, live = _chunk(rng, aids, speeds, np.arange(4), 3)
    a = match_chunk_torch(aids, speeds, state)
    b = match_chunk_torch(aids, speeds, state, on_device=(ids_d, sp_d),
                          start=start, live=live)
    assert np.array_equal(a.choice, b.choice)
    assert np.array_equal(a.granted, b.granted) and a.rounds == b.rounds


def test_engine_counts_segment_sizes_and_grid_route_calls(monkeypatch):
    """The engine records its largest segment and the calls (and their
    time) above ``GRID_ROWS`` rows — the grid route's share on a card."""
    monkeypatch.setattr(ms, "GRID_ROWS", 12)
    sched = FakeSched([[(FakeReq(50), -math.inf, math.inf)]])
    sched.prepare_match = lambda now: None
    sched.match_token = lambda: ("t",)
    sched.index = type("I", (), {"num_atoms": 1})()
    eng = engine_mod.ArrayMatchEngine(device="cpu")
    eng.prepare(sched, 0.0)
    for n in (5, 20, 12, 13):
        res = eng.match(np.zeros(n, dtype=np.int64), np.ones(n))
        assert int(res.granted.sum()) == n
    assert eng.matcher_calls == 4 and eng.matcher_rows == 50
    assert eng.matcher_max_rows == 20
    assert eng.matcher_grid_calls == 2
    assert 0 < eng.matcher_grid_s <= eng.matcher_s


# ------------------------------------------------------------------ layout

@pytest.mark.parametrize("n,K,R,req_in,row_in", [
    (2, 32, 1273, True, True),          # the workloads' segments
    (1024, 32, 2200, True, True),       # 47 488 B: with the static 4 KB,
    #                                     over the 48 KB that needs no opt-in
    (1536, 32, 1273, True, True),       # the one-CTA route's largest
    (1536, 130, 12000, True, False),    # five mask words a row
    (1536, 32, 16384, False, True),     # 256 KB of request state
    (1536, 1200, 20000, False, False),
    (1537, 32, 1273, None, None),       # the grid route from here on
    (16384, 32, 2048, None, None),      # the dense segment
    (20000, 130, 20000, None, None),
])
def test_plan_layout_places_what_fits_in_shared_memory(n, K, R, req_in,
                                                       row_in):
    lay = ms.plan_layout(n, K, R)
    req, row = 16 * R, 4 * n * ((K + 31) // 32 + 2)
    if req_in is None:                  # the grid: everything in scratch
        assert n > ms.GRID_ROWS and lay.grid
        tiles = -(-n // ms.TILE_ROWS)
        assert (lay.smem_bytes, lay.req_in_smem, lay.row_in_smem) == \
            (0, False, False)
        assert lay.scratch_bytes == req + row + 2 * 4 * tiles * R + 3 * 4
        return
    assert n <= ms.GRID_ROWS and not lay.grid
    assert (lay.req_in_smem, lay.row_in_smem) == (req_in, row_in)
    assert lay.smem_bytes == req * req_in + row * row_in <= ms.SMEM_BYTES
    assert lay.scratch_bytes == req * (not req_in) + row * (not row_in)


def test_shared_memory_budget_matches_the_kernel_source():
    src = (build.CSRC_DIRS[0] / "match_segment.cu").read_text()
    assert "constexpr int kDynSmemMax = 220 * 1024;" in src
    assert ms.SMEM_BYTES == 220 * 1024
    assert "constexpr int kThreads = 1024;" in src
    assert ms.TILE_ROWS == 1024          # the grid route's rows a CTA


# ------------------------------------------------------- launch (stand-in)

class _Entry:
    """Stands in for the kernel's C entry: records its arguments, returns a
    fixed code."""

    def __init__(self, code=0):
        self.argtypes = None
        self.restype = None
        self.code = code
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)
        return self.code


def _stand_in(monkeypatch, code=0):
    entry = _Entry(code)
    lib = type("Lib", (), {"venn_match_segment": entry})()
    monkeypatch.setattr(build, "load_library", lambda name: lib)
    monkeypatch.setattr(ms, "_fn", None)
    ms.reset_launches()
    return entry


def _tables(A=3, K=40, N=50):
    return (torch.zeros((A, K), dtype=torch.int32),
            torch.zeros((A, K), dtype=torch.float64),
            torch.ones((A, K), dtype=torch.float64),
            torch.zeros(N, dtype=torch.int32),
            torch.zeros(N, dtype=torch.float64))


@pytest.mark.parametrize("n,R,has_live", [(2, 7, False), (30, 500, True),
                                          (40, 20000, False),
                                          (5000, 300, True)])
def test_one_call_makes_one_launch_with_the_right_arguments(monkeypatch, n,
                                                            R, has_live):
    entry = _stand_in(monkeypatch)
    req, lo, hi, ids, sp = _tables(N=n + 10)
    stage = PinnedStage(CPU)
    stage.reserve(4 * (R + n), 4 * (2 * n + 2))
    ms._launch(req, lo, hi, ids, sp, 5, n, has_live, R, stage)
    (args,) = entry.calls
    lay = ms.plan_layout(n, 40, R)
    assert args[:4] == (req.data_ptr(), lo.data_ptr(), hi.data_ptr(), 40)
    assert args[4:10] == (ids.data_ptr(), sp.data_ptr(), 5, n, int(has_live),
                          R)
    assert args[10:14] == (stage.host_in_ptr, stage.dev_in_ptr,
                           stage.dev_out_ptr, stage.host_out_ptr)
    if lay.scratch_bytes:
        assert args[14] == stage.scratch(lay.scratch_bytes).data_ptr()
        assert stage.scratch(0).numel() >= lay.scratch_bytes
    else:
        assert args[14] is None
    assert args[15:19] == (lay.smem_bytes, int(lay.req_in_smem),
                           int(lay.row_in_smem), int(lay.grid))
    assert args[19] == stage.stream_handle() == 0 and len(args) == 20
    assert len(entry.argtypes) == 20
    assert ms.launches == 1
    assert ms.launches_grid == int(n > ms.GRID_ROWS) == int(lay.grid)
    assert ms.launches_scratch == (1 if lay.scratch_bytes and not lay.grid
                                   else 0)
    ms._launch(req, lo, hi, ids, sp, 0, n, has_live, R, stage)
    assert ms.launches == len(entry.calls) == 2
    ms.reset_launches()
    assert ms.launches == ms.launches_scratch == ms.launches_grid == 0


def test_a_refused_launch_raises_and_counts(monkeypatch):
    _stand_in(monkeypatch, code=1)
    req, lo, hi, ids, sp = _tables()
    with pytest.raises(build.KernelLaunchError, match="match_segment"):
        ms._launch(req, lo, hi, ids, sp, 0, 4, False, 9, PinnedStage(CPU))
    assert ms.launches == 1


def test_wrapper_refuses_what_the_kernel_does_not_take():
    req, lo, hi, ids, sp = _tables()
    rem = np.ones(4, dtype=np.int64)
    with pytest.raises(ValueError, match="cand_lo"):
        ms.match_segment(req, lo.float(), hi, ids, sp, rem, n=2)
    with pytest.raises(ValueError, match="ids"):
        ms.match_segment(req, lo, hi, ids.long(), sp, rem, n=2)
    with pytest.raises(ValueError, match="outside the chunk"):
        ms.match_segment(req, lo, hi, ids, sp, rem, n=10, start=45)
    with pytest.raises(ValueError, match="outside the chunk"):
        ms.match_segment(req, lo, hi, ids, sp, rem, n=2, start=0,
                         live=np.array([3, 50]))
    empty = ms.match_segment(req, lo, hi, ids, sp, rem[:0], n=3)
    assert empty.choice.tolist() == [-1] * 3 and not empty.granted.any()
    assert empty.rounds == 0 and empty.settled


def test_unsettled_fixed_point_raises_on_a_card(monkeypatch):
    """The kernel's not-settled flag stops the run on a CUDA device; the
    CPU serves the segment from the sequential oracle instead."""
    rng = np.random.default_rng(4)
    ref_state = RefMatchState.from_scheduler(
        FakeSched(_wide_slots(rng, 2, 6, 8, rng.integers(1, 3, 8))),
        token=("t",), kcap=6)
    state = match_state_from_numpy(state_arrays(ref_state), CPU)
    aids, speeds = rng.integers(0, 2, 12), rng.uniform(0, 3, 12)

    def unsettled(*a, n, **kw):
        return ms.SegmentMatch(np.zeros(n, dtype=np.int32),
                               np.ones(n, dtype=bool), 10, False)

    monkeypatch.setattr(engine_mod._match_segment, "match_segment",
                        unsettled)
    res = match_chunk_torch(aids, speeds, state)
    seq = ref_match_chunk_seq(aids, speeds, ref_state)
    assert np.array_equal(res.choice, seq.choice)
    state.device = torch.device("cuda", 0)
    bound = (torch.from_numpy(aids.astype(np.int32)), torch.from_numpy(speeds))
    with pytest.raises(DeviceMatchError, match="did not settle in 10"):
        match_chunk_torch(aids, speeds, state, on_device=bound)


# ------------------------------------------------------------------ staging

def test_stage_round_trips_parts_and_grows():
    """The resort's staged form lays keys (f64) and ties (i32) back to back
    in the device's pinned buffer, reads them through device views of its
    twin and returns the permutation in the pinned output buffer; the
    buffers grow on demand and the stage is one per device."""
    from repro_torch.accel.kernels import replan_order
    stage = stage_for(CPU)
    assert stage_for("cpu") is stage and stage.stream_handle() == 0
    rng = np.random.default_rng(3)
    n = 3000
    keys = rng.choice([0.5, 1.0, 2.0], size=n)
    ties = rng.permutation(n).astype(np.int32)
    perm = replan_order.segmented_order_staged(keys, ties, CPU)
    assert perm.dtype == np.int32
    assert np.array_equal(perm, np.lexsort((ties, keys)))
    assert np.array_equal(stage.host_in_np[:8 * n].view(np.float64), keys)
    assert np.array_equal(stage.dev_in[8 * n:12 * n].view(torch.int32)
                          .numpy(), ties)
    assert stage.host_in.numel() >= 12 * n
    stage.reserve(1 << 16, 1 << 15)
    assert stage.host_in.numel() >= 1 << 16
    assert stage.dev_out.numel() >= 1 << 15
    assert stage.host_in_ptr == stage.host_in.data_ptr()
