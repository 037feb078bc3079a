"""The port's array replan vs NumPy, vs its own scalar path, vs the reference.

* ``_kernel_order`` (the resort through ``segmented_order``, f64 keys) equals
  ``np.lexsort`` and the reference's guarded ``_kernel_order``;
* job ids outside int32 take ``np.lexsort``; non-finite keys trip the
  strict-order guard and are counted; a wrong order of finite keys raises
  when the kernel ran on a CUDA device;
* step-level dual universe: the port's scalar and array replans publish the
  same plan, and the port's ``DispatchTable.snapshot()`` equals the
  reference's after every step — with the resort pinned to the kernel
  wrapper (its plain version on the CPU) and with NumPy.

Everything compared is integers or f64 values computed by the same host
code: every comparison is exact.
"""
import numpy as np
import pytest
import torch

from repro.accel.replan import _kernel_order as ref_kernel_order
from repro.core import VennScheduler as RefVenn
from repro.core.types import Job as RefJob, JobRequest as RefJobRequest
from repro.sim.devices import REQUIREMENT_CLASSES as REF_CLASSES
from repro_torch.accel import replan as replan_mod
from repro_torch.accel.kernels import replan_order
from repro_torch.accel.replan import (KernelOrderError, ReplanEngine,
                                      _guard_order, _kernel_order)
from repro_torch.core import VennScheduler
from repro_torch.core.types import Job, JobRequest
from repro_torch.sim.devices import REQUIREMENT_CLASSES
from torch_parity import CPU


@pytest.fixture(autouse=True)
def _paranoid(monkeypatch):
    monkeypatch.setenv("REPRO_REPLAN_CHECK", "1")


# ------------------------------------------------------------- _kernel_order

@pytest.mark.parametrize("n", [0, 1, 2, 7, 64, 257, 700])
def test_kernel_order_equals_lexsort_and_reference(n):
    rng = np.random.default_rng(n)
    # heavy duplication forces the id tie-break; near-equal f64 keys collide
    # in f32 (the reference then leans on its guard, the port does not)
    keys = rng.choice([0.5, 1.25, 1.25 + 1e-12, 2.0], size=n)
    ids = rng.permutation(n).astype(np.int64)
    before = replan_mod.order_fallbacks
    got = _kernel_order(ids, keys, CPU)
    assert got.dtype == np.int64
    assert np.array_equal(got, np.lexsort((ids, keys)))
    assert np.array_equal(got, ref_kernel_order(ids, keys))
    assert replan_mod.order_fallbacks == before     # f64 compares: no trip


@pytest.mark.parametrize("n", [2, 33, 512, 1500])
def test_kernel_order_goes_through_one_stage_and_one_order_call(monkeypatch,
                                                                n):
    """One resort: keys and ids staged together in the device's stage, one
    ``segmented_order`` call with no segment ids (one group is one
    segment), counted in ``kernel_resorts``; the stage is reused call after
    call."""
    from repro_torch.accel.kernels.stage import stage_for
    seen = []
    real = replan_order.segmented_order

    def spy(seg_ids, keys, ties):
        seen.append((seg_ids, keys.dtype, ties.dtype, keys.shape[0]))
        return real(seg_ids, keys, ties)

    monkeypatch.setattr(replan_order, "segmented_order", spy)
    rng = np.random.default_rng(n)
    stage = stage_for(CPU)
    before = replan_mod.kernel_resorts
    for rep in range(2):
        keys = rng.choice([0.25, 1.0, 1.0 + 2.0 ** -40, 9.5], size=n)
        ids = rng.permutation(n).astype(np.int64) + 7
        got = _kernel_order(ids, keys, CPU)
        assert np.array_equal(got, np.lexsort((ids, keys)))
        ptrs = (stage.host_in_ptr, stage.host_out_ptr)
        if rep:
            assert ptrs == first           # same size: no new buffers
        first = ptrs
        assert np.array_equal(stage.host_in_np[:8 * n].view(np.float64), keys)
    assert stage_for(CPU) is stage
    assert seen == [(None, torch.float64, torch.int32, n)] * 2
    assert replan_mod.kernel_resorts == before + 2


def test_kernel_order_id_overflow_takes_lexsort(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("the kernel wrapper must not be reached")

    monkeypatch.setattr(replan_order, "segmented_order", boom)
    ids = np.array([5, 2 ** 31, 7, -2 ** 31 - 1], dtype=np.int64)
    keys = np.array([1.0, 0.5, 1.0, 3.0])
    assert np.array_equal(_kernel_order(ids, keys, CPU),
                          np.lexsort((ids, keys)))


def test_kernel_order_guard_counts_nonfinite_keys():
    ids = np.arange(6, dtype=np.int64)
    keys = np.array([2.0, np.nan, 1.0, 1.0, np.nan, 0.5])
    before = replan_mod.order_fallbacks
    got = _kernel_order(ids, keys, CPU)
    assert np.array_equal(got, np.lexsort((ids, keys)))
    assert replan_mod.order_fallbacks == before + 1


def test_order_guard_raises_on_a_cuda_device_for_finite_keys():
    """A wrong permutation of finite keys means a wrong kernel: on a card
    that stops the run; the CPU (plain version) and NaN keys fall back."""
    ids = np.arange(5, dtype=np.int64)
    keys = np.array([3.0, 1.0, 2.0, 1.0, 0.5])
    right = np.lexsort((ids, keys))
    wrong = right[::-1].copy()
    card = torch.device("cuda", 0)
    before = replan_mod.order_fallbacks
    assert _guard_order(right, ids, keys, card) is right
    with pytest.raises(KernelOrderError):
        _guard_order(wrong, ids, keys, card)
    assert replan_mod.order_fallbacks == before
    assert np.array_equal(_guard_order(wrong, ids, keys, CPU), right)
    assert replan_mod.order_fallbacks == before + 1
    keys[2] = np.nan
    assert np.array_equal(_guard_order(wrong, ids, keys, card),
                          np.lexsort((ids, keys)))
    assert replan_mod.order_fallbacks == before + 2


def test_order_backend_follows_device_and_env(monkeypatch):
    monkeypatch.delenv("REPRO_REPLAN_ORDER", raising=False)
    assert ReplanEngine(device="cpu").order_backend == "numpy"
    assert ReplanEngine(device="cpu", order_backend="kernel"
                        ).order_backend == "kernel"
    monkeypatch.setenv("REPRO_REPLAN_ORDER", "kernel")
    eng = ReplanEngine(device="cpu")
    assert eng.order_backend == "kernel" and eng.device == CPU
    with pytest.raises(ValueError, match="order backend"):
        ReplanEngine(device="cpu", order_backend="warp")
    monkeypatch.delenv("REPRO_REPLAN_ORDER")
    with pytest.raises(RuntimeError, match="CUDA"):
        ReplanEngine()                      # no device asked for, none here


# ------------------------------------------------------- step-level harness

class _Universe:
    def __init__(self, sched, job_cls, req_cls, classes):
        self.sched = sched
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


def _plan_sig(sched):
    plan = sched.plan
    return {
        "groups": [g.requirement.name for g in plan.groups],
        "order": {k: [j.job_id for j in v] for k, v in plan.job_order.items()},
        "keys": {k: list(v) for k, v in plan.job_keys.items()},
        "prio": [(tuple(sorted(a)), [g.requirement.name for g in order])
                 for a, order in plan.atom_priority.items()],
        "alloc": {g.requirement.name:
                  [(tuple(sorted(a)), r) for a, r in g.allocation.items()]
                  for g in plan.groups},
    }


def _table_sig(sched):
    return [row if row is None else
            [(r.job.job_id, r.round_index, lo, hi) for r, lo, hi in row]
            for row in sched.dispatch.snapshot()]


def _drive(seed, steps, epsilon=0.0):
    rng = np.random.default_rng(seed)
    unis = [
        _Universe(RefVenn(seed=0, epsilon=epsilon, replan="array"),
                  RefJob, RefJobRequest, REF_CLASSES),
        _Universe(VennScheduler(seed=0, epsilon=epsilon, replan="scalar",
                                device="cpu"),
                  Job, JobRequest, REQUIREMENT_CLASSES),
        _Universe(VennScheduler(seed=0, epsilon=epsilon, replan="array",
                                device="cpu"),
                  Job, JobRequest, REQUIREMENT_CLASSES),
    ]
    caps = {"cpu": 4.0 * np.exp(0.6 * rng.standard_normal(80)),
            "mem": 4.0 * np.exp(0.6 * rng.standard_normal(80))}
    t, next_id = 0.0, 0
    for _ in range(steps):
        t += float(rng.uniform(1.0, 50.0))
        open_ids = [jid for jid, j in unis[0].jobs.items()
                    if j.current is not None
                    and j.current.demand > j.current.granted]
        op = rng.uniform()
        if op < 0.35 or not open_ids:
            args = (next_id, int(rng.integers(0, len(REF_CLASSES))),
                    int(rng.integers(1, 8)), int(rng.integers(1, 4)),
                    float(rng.choice([0.5, 1.0, 1.0, 2.0])), t)
            for u in unis:
                u.arrive(*args)
            next_id += 1
        elif op < 0.70:
            jid = int(rng.choice(open_ids))
            cur = unis[0].jobs[jid].current
            for _g in range(int(rng.integers(1, cur.demand - cur.granted + 1))):
                for u in unis:
                    u.grant(jid)
        else:
            jid = int(rng.choice(open_ids))
            resub = bool(rng.uniform() < 0.7)
            for u in unis:
                u.finish(jid, t, resub)
        times = np.sort(rng.uniform(t - 40.0, t, size=12))
        sel = rng.integers(0, 80, size=12)
        for u in unis:
            u.sched.supply.record_batch(
                u.sched.classify_caps(caps)[sel].astype(np.int64), times)
            u.sched._reschedule(t)
        want_plan, want_table = _plan_sig(unis[0].sched), \
            _table_sig(unis[0].sched)
        for u in unis[1:]:
            assert _plan_sig(u.sched) == want_plan, f"plan, t={t:.1f}"
            assert _table_sig(u.sched) == want_table, f"table, t={t:.1f}"
    return unis


@pytest.mark.parametrize("order", ["numpy", "kernel"])
@pytest.mark.parametrize("seed", range(5))
def test_port_replan_equals_reference_stepwise(seed, order, monkeypatch):
    monkeypatch.setenv("REPRO_REPLAN_ORDER", order)
    # the reference would route "kernel" through its own Pallas resort; that
    # is its business — both publish the lexsort order
    unis = _drive(seed, steps=35)
    eng = unis[2].sched._replan
    assert eng is not None and eng.order_backend == order
    assert eng.device == CPU


def test_port_replan_equals_reference_with_fairness(monkeypatch):
    monkeypatch.setenv("REPRO_REPLAN_ORDER", "kernel")
    _drive(3, steps=25, epsilon=2.0)


def test_scheduler_pickle_drops_replan_engine():
    import pickle
    unis = _drive(1, steps=10)
    sched = unis[2].sched
    assert sched._replan is not None
    restored = pickle.loads(pickle.dumps(sched))
    assert restored._replan is None and restored.device == "cpu"
    restored._reschedule(1e6)
    assert restored._replan is not None
    assert not any(isinstance(v, torch.Tensor)
                   for v in restored.__dict__.values())
