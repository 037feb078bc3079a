"""The port's ``MatchState`` device mirror vs the reference's arrays.

Two universes — the reference scheduler + engine, and the port's on
``device="cpu"`` — are driven through one seeded script of arrivals, grants,
completions and replans; after every step the port's device mirror, read
back, must equal the reference's NumPy arrays exactly (int indices, f64
bands, bools), whether the step was served by a full rebuild, a dirty-row
patch, a cap expansion or a ``consume``.
"""
import math
import pickle

import numpy as np
import pytest
import torch

from repro.accel.engine import ArrayMatchEngine as RefEngine
from repro.accel.state import MatchState as RefMatchState
from repro.core import VennScheduler as RefVenn
from repro.core.types import Job as RefJob, JobRequest as RefJobRequest
from repro.sim.devices import REQUIREMENT_CLASSES as REF_CLASSES
from repro_torch.accel.engine import ArrayMatchEngine
from repro_torch.accel.state import MatchState, match_state_from_numpy
from repro_torch.core import VennScheduler
from repro_torch.core.types import Job, JobRequest
from repro_torch.sim.devices import REQUIREMENT_CLASSES
from torch_parity import (CPU, FakeReq, FakeSched, assert_mirror_equals,
                          random_slots, state_arrays)


class _Universe:
    def __init__(self, sched, engine, job_cls, req_cls, classes):
        self.sched, self.engine = sched, engine
        self.Job, self.JobRequest, self.classes = job_cls, req_cls, classes
        self.jobs = {}

    def arrive(self, jid, cls_i, demand, rounds, prio, t):
        j = self.Job(job_id=jid, requirement=self.classes[cls_i],
                     demand_per_round=demand, total_rounds=rounds,
                     arrival_time=t, priority=prio)
        r = self.JobRequest(job=j, round_index=0, demand=demand,
                            submit_time=t)
        j.current = r
        self.jobs[jid] = j
        self.sched.on_request(r, t)

    def grant(self, jid):
        r = self.jobs[jid].current
        r.granted += 1
        self.sched.on_grant(r)
        ix = self.engine.state.request_index(r)
        if ix is not None:
            self.engine.state.consume(ix)
        else:
            self.engine.invalidate()

    def finish(self, jid, t, resubmit):
        j = self.jobs[jid]
        r = j.current
        self.sched.on_complete(r, t)
        j.rounds_done += 1
        if resubmit and j.rounds_done < j.total_rounds:
            nxt = self.JobRequest(job=j, round_index=r.round_index + 1,
                                  demand=j.demand_per_round, submit_time=t)
            j.current = nxt
            self.sched.on_request(nxt, t)
        else:
            j.current = None

    def feed(self, caps, sel, times):
        self.sched.supply.record_batch(
            self.sched.classify_caps(caps)[sel].astype(np.int64), times)


def _universes(mode):
    return (_Universe(RefVenn(seed=0, replan=mode), RefEngine(),
                      RefJob, RefJobRequest, REF_CLASSES),
            _Universe(VennScheduler(seed=0, replan=mode, device="cpu"),
                      ArrayMatchEngine(device="cpu"),
                      Job, JobRequest, REQUIREMENT_CLASSES))


@pytest.mark.parametrize("mode", ["scalar", "array"])
@pytest.mark.parametrize("seed", [0, 3, 8])
def test_device_mirror_equals_reference_stepwise(mode, seed, monkeypatch):
    monkeypatch.setenv("REPRO_MATCH_CHECK", "1")
    rng = np.random.default_rng(seed)
    ref, port = unis = _universes(mode)
    caps = {"cpu": 4.0 * np.exp(0.6 * rng.standard_normal(60)),
            "mem": 4.0 * np.exp(0.6 * rng.standard_normal(60))}
    t, next_id = 0.0, 0
    for _ in range(30):
        t += float(rng.uniform(1.0, 50.0))
        open_ids = [jid for jid, j in ref.jobs.items()
                    if j.current is not None
                    and j.current.demand > j.current.granted]
        op = rng.uniform()
        if op < 0.35 or not open_ids:
            args = (next_id, int(rng.integers(0, len(REF_CLASSES))),
                    int(rng.integers(1, 8)), int(rng.integers(1, 4)),
                    float(rng.choice([0.5, 1.0, 2.0])), t)
            for u in unis:
                u.arrive(*args)
            next_id += 1
        elif op < 0.70:
            jid = int(rng.choice(open_ids))
            for u in unis:
                u.grant(jid)
        else:
            jid = int(rng.choice(open_ids))
            resub = bool(rng.uniform() < 0.7)
            for u in unis:
                u.finish(jid, t, resub)
        times = np.sort(rng.uniform(t - 40.0, t, size=10))
        sel = rng.integers(0, 60, size=10)
        for u in unis:
            u.feed(caps, sel, times)
            u.engine.prepare(u.sched, t)
        assert_mirror_equals(port.engine.state, ref.engine.state)
    assert port.engine.patches == ref.engine.patches > 0
    assert port.engine.rebuilds == ref.engine.rebuilds


@pytest.mark.parametrize("seed", range(6))
def test_from_scheduler_expand_and_consume_keep_the_mirror(seed):
    rng = np.random.default_rng(seed)
    slots = random_slots(rng)
    # one long row so the cap truncates and expand() has something to widen
    long_row = [(FakeReq(int(rng.integers(1, 4))), -math.inf, math.inf)
                for _ in range(int(rng.integers(20, 40)))]
    slots.append(long_row)
    ref = RefMatchState.from_scheduler(FakeSched(slots), ("t",), kcap=4)
    port = MatchState.from_scheduler(FakeSched(slots), ("t",), kcap=4,
                                     device=CPU)
    assert_mirror_equals(port, ref)
    assert port.truncated.any() and port.to_numpy()["truncated"].any()
    while ref.expand():
        assert port.expand()
        assert_mirror_equals(port, ref)
    assert not port.expand()
    for rix in rng.integers(0, len(ref.remaining), size=5).tolist():
        ref.consume(rix)
        port.consume(rix)
    assert_mirror_equals(port, ref)


@pytest.mark.parametrize("seed", range(6))
def test_carry_across_round_trip(seed):
    rng = np.random.default_rng(50 + seed)
    ref = RefMatchState.from_scheduler(FakeSched(random_slots(rng)), ("t",),
                                       kcap=int(rng.integers(1, 9)))
    arrays = state_arrays(ref)
    port = match_state_from_numpy(arrays, CPU)
    assert_mirror_equals(port, ref)
    assert port.num_atoms == ref.num_atoms
    assert port.num_requests == ref.num_requests
    back = port.to_numpy()
    again = match_state_from_numpy(back, CPU)
    for k, v in back.items():
        np.testing.assert_array_equal(again.to_numpy()[k], v, err_msg=k)
    # the carried state owns its arrays: consuming it leaves the source alone
    if len(port.remaining):
        before = ref.remaining.copy()
        port.consume(0)
        np.testing.assert_array_equal(ref.remaining, before)


@pytest.mark.parametrize("uncovered,ids,num_atoms,want", [
    (False, [0, 2, 1, 2], 3, -1),       # every atom covered: no scan
    (False, [0, 2, 3, 1], 4, 2),        # atom 3 interned after the build
    (False, [3, 0], 4, 0),
    (True, [0, 2, 1, 0], 3, 2),         # atom 1 not covered by the plan
    (True, [0, 2, 0], 3, -1),
])
def test_first_miss_takes_atoms_the_state_does_not_cover(uncovered, ids,
                                                         num_atoms, want):
    """``first_miss`` skips its scan only while every atom is covered and
    the id space has not grown since the build; otherwise it returns the
    reference's answer."""
    req = FakeReq(2)
    slots = [[(req, -math.inf, math.inf)], [], [(req, 0.5, 2.0)]]
    if uncovered:
        slots[1] = None
    ref = RefMatchState.from_scheduler(FakeSched(slots), ("t",))
    port = MatchState.from_scheduler(FakeSched(slots), ("t",), device=CPU)
    assert port.all_covered is not uncovered
    ids = np.array(ids, dtype=np.int64)
    assert port.first_miss(ids, num_atoms) == ref.first_miss(ids) == want


def test_host_only_state_has_no_mirror():
    st = MatchState.from_scheduler(
        FakeSched([[(FakeReq(2), -math.inf, math.inf)]]), ("t",))
    assert st.device is None and st.d_cand_req is None
    assert st.to_numpy()["cand_req"].tolist() == [[0]]


def test_pickle_drops_state_and_device_tensors():
    sched = FakeSched([[(FakeReq(3), -math.inf, math.inf)]])
    sched.prepare_match = lambda now: None
    sched.match_token = lambda: ("t",)
    sched.index = type("I", (), {"num_atoms": 1})()
    eng = ArrayMatchEngine(device="cpu")
    eng.prepare(sched, 0.0)
    eng.bind_chunk(np.zeros(8, dtype=np.int64), np.ones(8))
    assert eng.state is not None and eng._chunk_dev is not None
    restored = pickle.loads(pickle.dumps(eng))
    assert restored.state is None and restored._chunk_dev is None
    assert restored.device == CPU
    assert not any(isinstance(v, torch.Tensor)
                   for v in restored.__dict__.values())
    # unbound after restore: start= is ignored and rows are uploaded
    sched2 = FakeSched([[(FakeReq(3), -math.inf, math.inf)]])
    sched2.prepare_match, sched2.match_token = (lambda now: None,
                                                lambda: ("t",))
    sched2.index = sched.index
    restored.prepare(sched2, 0.0)
    res = restored.match(np.zeros(40, dtype=np.int64), np.ones(40), start=5)
    assert int(res.granted.sum()) == 3
