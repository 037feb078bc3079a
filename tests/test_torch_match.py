"""The port's matcher vs the reference's three matchers, on the same state.

A reference ``MatchState`` is built from seeded random candidate rows, its
arrays are carried across with ``match_state_from_numpy`` and the same
segment goes through ``repro.accel``'s sequential oracle, NumPy fixed point
and jitted JAX fixed point (Pallas kernel in interpret mode) and through
``repro_torch.accel.engine.match_chunk_torch`` on ``device="cpu"``.  Outputs
are integers and booleans: every comparison is exact.
"""
import math

import numpy as np
import pytest
import torch

from repro.accel.engine import (match_chunk as ref_match_chunk,
                                match_chunk_jax as ref_match_chunk_jax,
                                match_chunk_seq as ref_match_chunk_seq)
from repro.accel.state import MatchState as RefMatchState
from repro_torch.accel.engine import (ArrayMatchEngine, DeviceMatchError,
                                      MatchResult, match_chunk_seq,
                                      match_chunk_torch)
from repro_torch.accel.kernels.build import KernelLaunchError
from repro_torch.accel.match import match_fixed_point
from repro_torch.accel.state import MatchState, match_state_from_numpy
from torch_parity import (CPU, FakeReq, FakeSched, random_segment,
                          random_slots, state_arrays)


def _ref_state(rng, kcap=8):
    return RefMatchState.from_scheduler(FakeSched(random_slots(rng)),
                                        token=("t",), kcap=kcap)


def _same(a, b):
    assert np.array_equal(a.choice, b.choice)
    assert np.array_equal(a.granted, b.granted)


@pytest.mark.parametrize("seed", range(40))
def test_match_chunk_torch_equals_reference_matchers(seed):
    rng = np.random.default_rng(seed)
    ref_state = _ref_state(rng)
    aids, speeds = random_segment(rng, ref_state, 1 + 7 * seed % 80)
    if aids is None:
        aids, speeds = np.zeros(0, dtype=np.int64), np.zeros(0)
    state = match_state_from_numpy(state_arrays(ref_state), CPU)
    got = match_chunk_torch(aids, speeds, state, CPU)
    assert got.choice.dtype == np.int64 and got.granted.dtype == np.bool_
    assert got.choice.shape == (len(aids),)
    _same(got, ref_match_chunk_seq(aids, speeds, ref_state))
    _same(got, ref_match_chunk(aids, speeds, ref_state))
    _same(got, ref_match_chunk_jax(aids, speeds, ref_state, use_kernel=True))
    # the port's own oracle agrees on the carried-across state too
    _same(got, match_chunk_seq(aids, speeds, state))


def test_match_chunk_torch_tensors_already_on_device():
    rng = np.random.default_rng(5)
    ref_state = _ref_state(rng)
    aids, speeds = random_segment(rng, ref_state, 60)
    state = match_state_from_numpy(state_arrays(ref_state), CPU)
    got = match_chunk_torch(
        aids, speeds, state,
        on_device=(torch.from_numpy(aids.astype(np.int32)),
                   torch.from_numpy(speeds)))
    _same(got, ref_match_chunk_seq(aids, speeds, ref_state))
    assert got.rounds >= 1


def test_empty_segment_and_empty_request_table():
    rng = np.random.default_rng(0)
    state = match_state_from_numpy(state_arrays(_ref_state(rng)), CPU)
    res = match_chunk_torch(np.zeros(0, dtype=np.int64), np.zeros(0), state)
    assert res.choice.shape == (0,) and res.choice.dtype == np.int64
    assert res.granted.shape == (0,) and res.granted.dtype == np.bool_
    # R == 0: an atom with no candidates and no requests at all
    empty = RefMatchState.from_scheduler(FakeSched([[]]), token=("t",))
    state0 = match_state_from_numpy(state_arrays(empty), CPU)
    assert len(state0.remaining) == 0
    res = match_chunk_torch(np.zeros(4, dtype=np.int64), np.ones(4), state0)
    assert res.choice.tolist() == [-1] * 4 and not res.granted.any()


def test_capacity_depletes_in_priority_order_and_bands_hold():
    r0, r1 = FakeReq(2), FakeReq(3)
    state = MatchState.from_scheduler(
        FakeSched([[(r0, -math.inf, math.inf), (r1, 1.0, 2.0)]]),
        token=("t",), device=CPU)
    assert torch.isinf(state.d_cand_lo[0, 0]) and state.d_cand_lo[0, 0] < 0
    assert torch.isinf(state.d_cand_hi[0, 0])
    speeds = np.array([1.0, 1.0, 0.5, 1.0, 1.99, 2.0, 1.5, 1.5])
    res = match_chunk_torch(np.zeros(8, dtype=np.int64), speeds, state)
    assert res.choice.tolist() == [0, 0, -1, 1, 1, -1, 1, -1]
    assert res.granted.tolist() == [True, True, False, True, True, False,
                                    True, False]


def test_fixed_point_gives_up_after_its_bound(monkeypatch):
    """A first-fit that never settles makes the fixed point return None
    after R + 2 rounds (the caller then raises on a CUDA device and serves
    the sequential oracle on the CPU)."""
    from repro_torch.accel import match as match_mod
    calls = {"n": 0}

    def flapping(elig, reqix, fill, pos):
        calls["n"] += 1
        ch = torch.zeros(reqix.shape[0], dtype=torch.int32)
        if calls["n"] % 2:
            ch[0] = -1
        return ch, ch

    monkeypatch.setattr(match_mod, "first_fit_choice_ref", flapping)
    reqix = torch.zeros((3, 1), dtype=torch.int32)
    choice, granted, rounds = match_fixed_point(
        reqix, reqix >= 0, torch.tensor([2, 0], dtype=torch.int32))
    assert choice is None and granted is None
    assert calls["n"] == 3 and rounds == 3          # R + 2


def _fake_engine_sched(rows):
    sched = FakeSched(rows)
    sched.prepare_match = lambda now: None
    sched.match_token = lambda: ("t",)
    sched.index = type("I", (), {"num_atoms": len(rows)})()
    return sched


def test_engine_counts_nonfinite_degradation_by_reason():
    row = [(FakeReq(50), 0.5, 2.0)]
    engine = ArrayMatchEngine(device="cpu")
    engine.prepare(_fake_engine_sched([row]), 0.0)
    n = 40
    speeds = np.ones(n)
    speeds[3], speeds[7] = np.nan, np.inf
    res = engine.match(np.zeros(n, dtype=np.int64), speeds)
    assert engine.degraded == {"nonfinite": 1, "exception": 0,
                               "implausible": 0}
    assert engine.degraded_segments == 1
    assert not res.granted[3] and not res.granted[7]
    assert int(res.granted.sum()) == n - 2
    res = engine.match(np.zeros(n, dtype=np.int64), np.ones(n))
    assert engine.degraded_segments == 1 and engine.fixedpoint_rounds >= 1
    assert int(res.granted.sum()) == n     # match() consumes nothing


def test_engine_lets_kernel_errors_through_but_degrades_on_others(monkeypatch):
    from repro_torch.accel import engine as engine_mod
    row = [(FakeReq(5), -math.inf, math.inf)]
    eng = ArrayMatchEngine(device="cpu")
    eng.prepare(_fake_engine_sched([row]), 0.0)
    aids, speeds = np.zeros(30, dtype=np.int64), np.ones(30)

    def launch_fails(*a, **k):
        raise KernelLaunchError("refused")

    monkeypatch.setattr(engine_mod, "match_chunk_torch", launch_fails)
    with pytest.raises(KernelLaunchError):
        eng.match(aids, speeds)
    assert eng.degraded_segments == 0

    def data_fails(*a, **k):
        raise IndexError("bad row")

    monkeypatch.setattr(engine_mod, "match_chunk_torch", data_fails)
    res = eng.match(aids, speeds)
    assert eng.degraded["exception"] == 1
    assert int(res.granted.sum()) == 5


@pytest.mark.parametrize("fault", ["exception", "implausible"])
def test_engine_on_a_cuda_device_raises_where_the_cpu_degrades(monkeypatch,
                                                               fault):
    """With the mirror on a card, a backend exception (an in-kernel fault
    surfaces as a plain RuntimeError at the next sync) or a wrong result
    stops the run; only ``device="cpu"`` serves the oracle instead."""
    from repro_torch.accel import engine as engine_mod
    row = [(FakeReq(5), -math.inf, math.inf)]
    aids, speeds = np.zeros(30, dtype=np.int64), np.ones(30)

    def faulty(ids, sp, st, **kw):
        if fault == "exception":
            raise RuntimeError("CUDA error: an illegal memory access")
        return MatchResult(np.zeros(len(ids), dtype=np.int64),
                           np.ones(len(ids), dtype=bool))   # 30 grants of 5

    monkeypatch.setattr(engine_mod, "match_chunk_torch", faulty)
    eng = ArrayMatchEngine(device="cpu")
    eng.prepare(_fake_engine_sched([row]), 0.0)
    assert int(eng.match(aids, speeds).granted.sum()) == 5
    assert eng.degraded[fault] == 1
    # the same engine, told its mirror lives on a card
    eng.device = torch.device("cuda", 0)
    with pytest.raises(DeviceMatchError if fault == "implausible"
                       else RuntimeError):
        eng.match(aids, speeds)
    assert eng.degraded[fault] == 1 and eng.degraded_segments == 1
    # non-finite speeds are an input problem: served by the oracle anywhere
    speeds[3] = np.nan
    assert int(eng.match(aids, speeds).granted.sum()) == 5
    assert eng.degraded["nonfinite"] == 1


def test_engine_expands_truncated_rows_exactly():
    reqs = [FakeReq(1, granted=1) for _ in range(39)] + [FakeReq(1)]
    row = [(r, -math.inf, math.inf) for r in reqs]
    engine = ArrayMatchEngine(kcap=4, device="cpu")
    engine.prepare(_fake_engine_sched([row]), 0.0)
    res = engine.match(np.zeros(30, dtype=np.int64), np.ones(30))
    assert res.choice.tolist() == [39] + [-1] * 29
    assert engine.expansions >= 1
    assert engine.state.d_cand_req.shape[1] == engine.state.cand_req.shape[1]


def test_engine_uses_bound_chunk_slices():
    """``match(..., start=)`` on a bound chunk equals matching the arrays."""
    rng = np.random.default_rng(3)
    rows = [[(FakeReq(7), -math.inf, math.inf)], [],
            [(FakeReq(9), 0.5, 2.5)]]
    aids = rng.integers(0, 3, 200)
    speeds = rng.uniform(0, 3, 200)
    a = ArrayMatchEngine(device="cpu")
    a.prepare(_fake_engine_sched(rows), 0.0)
    want = a.match(aids[50:150], speeds[50:150])
    b = ArrayMatchEngine(device="cpu")
    b.prepare(_fake_engine_sched(rows), 0.0)
    b.bind_chunk(aids, speeds)
    got = b.match(aids[50:150], speeds[50:150], start=50)
    _same(got, want)
    # every row live -> the plain-slice branch
    live = np.where(aids == 1, 0, aids)
    b.bind_chunk(live, speeds)
    _same(b.match(live[:64], speeds[:64], start=0),
          a.match(live[:64], speeds[:64]))


def test_engine_on_the_cpu_runs_the_kernels_plain_version(monkeypatch):
    """One matcher per device: on ``device="cpu"`` a segment goes through
    ``match_segment_ref`` and never reaches the kernel's launch; without a
    device the engine resolves ``cuda:0``, or raises where there is none."""
    from repro_torch.accel.kernels import match_segment as ms
    calls = []
    ref = ms.match_segment_ref

    def counted(*a, **k):
        calls.append(1)
        return ref(*a, **k)

    monkeypatch.setattr(ms, "match_segment_ref", counted)
    ms.reset_launches()
    eng = ArrayMatchEngine(device="cpu")
    assert eng.device == CPU
    eng.prepare(_fake_engine_sched([[(FakeReq(5), -math.inf, math.inf)]]),
                0.0)
    res = eng.match(np.zeros(30, dtype=np.int64), np.ones(30))
    assert res.granted.tolist() == [True] * 5 + [False] * 25
    assert len(calls) == 1 and eng.matcher_calls == 1
    assert ms.launches == 0
    if torch.cuda.is_available():
        assert ArrayMatchEngine().device == torch.device("cuda", 0)
    else:
        with pytest.raises(RuntimeError, match="CUDA device"):
            ArrayMatchEngine()
