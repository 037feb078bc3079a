"""Responses delivered as data, and the array drain's routing around them.

A granted device's response waits in its request's buffer and is delivered
where something reads it: before a replan, at a deadline, at the response
that completes the round (the round's one RESPONSE entry), at a blackout
and at every pause.  The array drain (``engine="array"``, ``device="cpu"``)
passes a response that comes due between two rows and goes on.  Each case
runs the same workload through it and through the per-device drain
(``engine="python"``): grant logs, round records, JCTs and ``summary()``
must be equal, and so must the check-ins decided and the clock at each pause
and at the end.  A spy on the array run records the edge each case is there
for, and the case fails if the edge never happened.  The responses in bulk
are held against the reference simulator, which handles one event a
response.
"""
import math

import numpy as np
import pytest

from repro_torch import obs
from repro_torch.core import SCHEDULERS
from repro_torch.faults.plan import Blackout, FaultPlan
from repro_torch.sim import (GeneratorStream, JobTraceConfig,
                             PopulationConfig, SimConfig, generate_jobs)
from repro_torch.sim import simulator as simmod
from repro_torch.sim.devices import DeviceGenerator
from repro_torch.sim.simulator import RESPONSE, Simulator
import torch_parity  # noqa: F401  (pins torch to one thread)


class _FlooredStream:
    """A generator stream with check-in times floored to whole seconds, so
    that check-ins share times with each other and with events (the
    generator's classes may be the reference's)."""

    def __init__(self, pop, horizon: float, gen=DeviceGenerator,
                 stream=GeneratorStream):
        self.inner = stream(gen(pop), horizon)
        self.fail_base = self.inner.fail_base
        self.fail_slow_boost = self.inner.fail_slow_boost

    def next_chunk(self):
        ck = self.inner.next_chunk()
        if ck is not None:
            ck.times = np.floor(ck.times)
        return ck


class _Spy:
    """Wraps the array simulator's RESPONSE entries, its pauses, the end of
    each round's buffer, its blackouts, its scalar route and its
    scheduler's ``checkin`` and ``on_response`` on the instance, and counts the edges they meet.  For VENN a check-in
    whose atom its dispatch table does not cover is a MISS (``miss``); a
    route that takes one after rows of its own counts as
    ``mid_route_miss``, and the clock right after each route that took a
    MISS goes to ``miss_clocks`` beside the MISS row's time."""

    def __init__(self, sim: Simulator):
        self.sim = sim
        self.seen: dict = {}
        self.last_entry = None          # time of the last round completed
        self.last_ok = None             # at an entry; the last response's ok
        self.last_passed = None         # the last clock a response set
        self.miss_clocks: list = []
        sched = sim.sched
        entry = sim._on_response_entry
        pause, pass_ = sim._pause, sim._pass
        close, blackout = sim._close, sim._on_blackout
        route, checkin = sim._drain_array_scalar, sched.checkin
        on_response = sched.on_response

        def spy_on_response(req, dev, rt, ok, now):
            self.note("applied")
            self.last_ok = ok
            return on_response(req, dev, rt, ok, now)

        def spy_entry(req):
            if req.resp_t != sim.now:
                self.note("stale_entry")
                return entry(req)
            entry(req)
            self.note("completing")
            if not self.last_ok:
                # quorum came before the fill: a failed response completes
                # the round
                self.note("failed_after_fill")
            self.last_entry = sim.now

        def spy_pass(t):
            now = sim.now
            out = pass_(t)
            if sim.now > now:
                self.last_passed = sim.now
            return out

        def spy_pause(bound):
            out = pause(bound)
            if sim.now == self.last_passed:
                self.note("pause_after_response")   # the clock from a
            return out                              # response, not a row

        def spy_close(req):
            if req.resp_buf:
                # responses left unread: their entries go stale
                self.note("stale")
            return close(req)

        def spy_blackout(b):
            self.note("fault")
            return blackout(b)

        def spy_route(state, cursor, top, bound):
            missed = route(state, cursor, top, bound)
            i, times = sim._cursor, sim._times
            if missed:
                if i - 1 > cursor:
                    self.note("mid_route_miss")
                self.miss_clocks.append((sim.now, times[i - 1]))
            return missed

        def spy_checkin(aid, cpu, mem, speed, now):
            heap, due = sim._heap, sim._due
            if heap and heap[0][0] == now or due and due[0] == now:
                self.note("tie")
            dispatch = getattr(sched, "dispatch", None)
            if dispatch is not None and not dispatch.covers(aid):
                self.note("miss")
            return checkin(aid, cpu, mem, speed, now)

        sched.on_response = spy_on_response
        sim._on_response_entry = spy_entry
        sim._pass = spy_pass
        sim._pause = spy_pause
        sim._close = spy_close
        sim._on_blackout = spy_blackout
        sim._drain_array_scalar = spy_route
        sched.checkin = spy_checkin

    def note(self, what: str) -> None:
        self.seen[what] = self.seen.get(what, 0) + 1


def _sched(name, seed):
    kw = {"device": "cpu"} if name == "venn" else {}
    return SCHEDULERS[name](seed=seed, **kw)


def _build(case, engine):
    jobs = generate_jobs(JobTraceConfig(**case["jobs"]))
    for j in jobs:
        j.overcommit = case.get("overcommit", 1.0)
    horizon = case["days"] * 86400.0
    pop = PopulationConfig(**case["pop"])
    kw = {}
    if case.get("floored"):
        kw["stream"] = _FlooredStream(pop, horizon)
    else:
        kw["population"] = pop
    if case.get("blackouts"):
        kw["faults"] = FaultPlan(blackouts=tuple(
            Blackout(a, b, drop_prob=p) for a, b, p in case["blackouts"]))
    sched = _sched(case["sched"], case.get("sched_seed", 1))
    if case.get("dirty_on_response"):
        # a scheduler whose response feedback dirties its plan
        on_response = sched.on_response

        def dirtying(*a):
            on_response(*a)
            sched._plan_dirty = True
        sched.on_response = dirtying
    if case.get("refuse_miss"):
        # a scheduler that turns away the device of each MISS (its check-in
        # still replans), so that a MISS row grants nothing and only the
        # drain sets the clock to its time
        checkin = sched.checkin

        def refusing(aid, cpu, mem, speed, now):
            due = sched.sched_invocations + sched.plan_dirty
            req = checkin(aid, cpu, mem, speed, now)
            return None if sched.sched_invocations > due else req
        sched.checkin = refusing
    return Simulator(jobs, sched, cfg=SimConfig(max_time=horizon),
                     engine=engine, record_grants=True, device="cpu", **kw)


def _drive(sim, slices):
    """Run to the end, in one call or in pauses drawn from ``slices``; the
    clock at each pause."""
    if slices is None:
        return sim.run(), []
    rng = np.random.default_rng(slices)
    t, done, clocks = 0.0, False, []
    while not done:
        t += float(rng.uniform(1.0, 900.0))
        done = sim.step_until(t)
        clocks.append(sim.now)
    return sim.finish(), clocks


def _rounds(m):
    return [(r.job_id, r.round_index, r.submit, r.alloc_complete, r.complete,
             r.demand, r.responses, r.failures, r.retries) for r in m.rounds]


def _small(seed, **over):
    jobs = dict(num_jobs=5, seed=seed, demand_lo=10, demand_hi=120,
                rounds_lo=2, rounds_hi=6)
    jobs.update(over)
    return jobs


CASES = {
    # randomized workloads, VENN and the baselines
    "venn-a": dict(sched="venn", jobs=_small(0), days=2.0,
                   pop=dict(seed=7, base_rate=1.5)),
    "venn-b": dict(sched="venn", jobs=_small(3, num_jobs=8), days=2.0,
                   pop=dict(seed=8, base_rate=4.0), sched_seed=5),
    "random": dict(sched="random", jobs=_small(1), days=2.0,
                   pop=dict(seed=9, base_rate=2.0)),
    "srsf": dict(sched="srsf", jobs=_small(2), days=2.0,
                 pop=dict(seed=10, base_rate=3.0)),
    "fifo": dict(sched="fifo", jobs=_small(4), days=2.0,
                 pop=dict(seed=11, base_rate=1.0)),
    # the edges, each on a workload where it happens
    "failed-after-fill": dict(sched="venn", jobs=_small(5), days=2.0,
                              overcommit=1.6, edge="failed_after_fill",
                              pop=dict(seed=12, base_rate=1.0,
                                       fail_base=0.3)),
    "stale-entry": dict(sched="venn", jobs=_small(6), days=2.0,
                        edge="stale", pop=dict(seed=13, base_rate=2.0)),
    "last-job": dict(sched="venn", jobs=_small(7, num_jobs=3), days=6.0,
                     edge="last_job", pop=dict(seed=14, base_rate=2.0)),
    "pause-bound": dict(sched="venn", jobs=_small(8), days=2.0, slices=21,
                        edge="pause_after_response",
                        pop=dict(seed=15, base_rate=2.0)),
    "same-time": dict(sched="venn", jobs=_small(9), days=2.0, floored=True,
                      edge="tie", pop=dict(seed=16, base_rate=2.0)),
    "blackout": dict(sched="venn", jobs=_small(10), days=0.25,
                     edge="fault", blackouts=[(k / 32, k / 32 + 0.0125, 0.5)
                                              for k in range(1, 32)],
                     pop=dict(seed=17, base_rate=2.0)),
    "replan-on-response": dict(sched="venn", jobs=_small(12), days=2.0,
                               dirty_on_response=True, edge="refused",
                               pop=dict(seed=19, base_rate=2.0)),
    # a MISS met by the scalar route after rows of the same call, its
    # device turned away
    "miss-mid-route": dict(sched="venn", jobs=_small(13, num_jobs=6),
                           days=2.0, edge="mid_route_miss", refuse_miss=True,
                           pop=dict(seed=33, base_rate=3.0)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_array_drain_with_inline_events_equals_python_drain(
        name, monkeypatch):
    case = CASES[name]
    if case.get("dirty_on_response"):
        # feedback that marks the plan dirty would replan where a delivery
        # falls, which moves with the pauses: it is refused, on either
        # engine, in one call or in pauses
        for engine in ("python", "array"):
            for slices in (None, 21):
                sim = _build(case, engine)
                with pytest.raises(RuntimeError,
                                   match="marked the plan dirty"):
                    _drive(sim, slices)
        return
    if case.get("floored"):
        # whole-second response times on whole-second check-ins: responses
        # land on check-in times
        rt = simmod.response_time_from
        monkeypatch.setattr(simmod, "response_time_from",
                            lambda *a: float(math.ceil(rt(*a))))
    ref = _build(case, "python")
    m_ref, clocks_ref = _drive(ref, case.get("slices"))
    sim = _build(case, "array")
    spy = _Spy(sim)
    with obs.session(tracing=False, metrics=True):
        m, clocks = _drive(sim, case.get("slices"))
    assert sim.grant_log == ref.grant_log and len(sim.grant_log) > 0
    assert clocks == clocks_ref
    assert _rounds(m) == _rounds(m_ref)
    assert m.jcts == m_ref.jcts
    assert m.summary() == m_ref.summary()
    assert sim.checkins_seen + sim.checkins_skipped \
        == ref.checkins_seen + ref.checkins_skipped
    assert sim.now == ref.now
    # one RESPONSE entry a round at most; every other response is data
    completing = spy.seen.get("completing", 0)
    assert 0 < completing <= len(m.rounds)
    assert sim.event_counts[RESPONSE] \
        == completing + spy.seen.get("stale_entry", 0)
    assert 0 < sim.responses_delivered \
        == spy.seen.get("applied", 0) - completing
    if case["sched"] == "venn":
        # the route takes every MISS, one a call, and ends on it with the
        # clock at its row
        assert sim.head_misses == spy.seen.get("miss", 0) \
            == len(spy.miss_clocks) > 0
        assert all(now == t for now, t in spy.miss_clocks), spy.miss_clocks
    edge = case.get("edge")
    if edge == "last_job":
        # the last round completes at its RESPONSE entry; the run ends
        # there, and no check-in after it is examined
        last = max(j.completion_time for j in sim.jobs)
        assert all(j.completion_time is not None for j in sim.jobs)
        assert sim.now == last == max(r.complete for r in m.rounds)
        assert spy.last_entry == last
        assert sim._times[sim._cursor - 1] <= last
    elif edge is not None:
        assert spy.seen.get(edge, 0) > 0, spy.seen
    if edge == "fault":
        assert m.revoked_responses > 0


def _ref_build(jobs_kw, pop_kw, horizon, blackouts, floored=False):
    """The reference simulator (one event a response), per-device drain."""
    from repro.core import SCHEDULERS as REF_SCHEDULERS
    from repro.faults.plan import Blackout as RefBlackout
    from repro.faults.plan import FaultPlan as RefFaultPlan
    from repro.sim import JobTraceConfig as RefJobTraceConfig
    from repro.sim import PopulationConfig as RefPopulationConfig
    from repro.sim import SimConfig as RefSimConfig
    from repro.sim import generate_jobs as ref_generate_jobs
    from repro.sim.devices import DeviceGenerator as RefDeviceGenerator
    from repro.sim.devices import GeneratorStream as RefGeneratorStream
    from repro.sim.simulator import Simulator as RefSimulator
    faults = RefFaultPlan(blackouts=tuple(
        RefBlackout(a, b, drop_prob=p) for a, b, p in blackouts)) \
        if blackouts else None
    pop = RefPopulationConfig(**pop_kw)
    kw = dict(stream=_FlooredStream(pop, horizon, RefDeviceGenerator,
                                    RefGeneratorStream)) if floored \
        else dict(population=pop)
    return RefSimulator(ref_generate_jobs(RefJobTraceConfig(**jobs_kw)),
                        REF_SCHEDULERS["venn"](seed=1),
                        cfg=RefSimConfig(max_time=horizon), faults=faults,
                        **kw)


def _state(sim, full=False):
    """Each job's current round and its counts, and each profile's
    samples in order (``full``), or their count and the last."""
    cur = [(j.job_id, j.rounds_done) + (
        () if j.current is None else
        (j.current.round_index, j.current.responses, j.current.failures))
        for j in sim.jobs]
    return cur, {k: p.samples if full else (len(p._rts_l), p._rts_l[-1:],
                                            p._speeds_l[-1:])
                 for k, p in sim.sched.profiles.items()}


BULK = {
    # pauses of up to 5 minutes, the run to its end
    "plain": dict(jobs=_small(21, num_jobs=8, rounds_lo=4, rounds_hi=10),
                  pop=dict(seed=22, base_rate=2.0), days=2.0, slice=300.0),
    "blackouts": dict(jobs=_small(21, num_jobs=8, rounds_lo=4, rounds_hi=10),
                      pop=dict(seed=22, base_rate=2.0), days=2.0,
                      slice=300.0, blackouts=[(k / 16, k / 16 + 0.02, 0.5)
                                              for k in range(1, 16)]),
    # one-minute pauses over a day of 16 jobs with long rounds, cut by the
    # horizon: bounds fall between a response and the next check-in while
    # no control event is queued
    "minutes": dict(jobs=dict(num_jobs=16, seed=4, rounds_lo=4,
                              rounds_hi=20),
                    pop=dict(seed=5, base_rate=1.5), days=1.0, slice=60.0),
    # whole-second check-ins, response times and deadlines, the deadlines
    # short: responses land together, on check-ins and on deadlines
    "floored": dict(jobs=_small(9, num_jobs=8, rounds_lo=4, rounds_hi=10,
                                task_time_lo=150.0, task_time_hi=250.0,
                                task_sigma=0.5, deadline_lo=200.0,
                                deadline_hi=300.0),
                    pop=dict(seed=16, base_rate=2.0), days=2.0, slice=300.0,
                    floored=True),
}


@pytest.mark.parametrize("case", list(BULK))
@pytest.mark.parametrize("engine", ["python", "array"])
def test_responses_in_bulk_equal_one_event_each(engine, case, monkeypatch):
    """Delivered in bulk, the responses leave what one event a response
    left (the reference simulator): at every pause, whether the run ended,
    each job's counts, each VENN profile's samples in order, and the
    clock."""
    c = BULK[case]
    blackouts = c.get("blackouts", [])
    horizon = c["days"] * 86400.0
    floored = c.get("floored", False)
    if floored:
        from repro.sim import simulator as refmod
        for mod in (simmod, refmod):
            rt = mod.response_time_from
            monkeypatch.setattr(mod, "response_time_from",
                                lambda *a, rt=rt: float(math.ceil(rt(*a))))
    ref = _ref_build(c["jobs"], c["pop"], horizon, blackouts, floored)
    jobs = generate_jobs(JobTraceConfig(**c["jobs"]))
    if floored:
        for j in jobs + ref.jobs:
            j.deadline = float(round(j.deadline))
    faults = FaultPlan(blackouts=tuple(
        Blackout(a, b, drop_prob=p) for a, b, p in blackouts)) \
        if blackouts else None
    pop = PopulationConfig(**c["pop"])
    kw = dict(stream=_FlooredStream(pop, horizon)) if floored \
        else dict(population=pop)
    sim = Simulator(jobs, _sched("venn", 1), cfg=SimConfig(max_time=horizon),
                    engine=engine, faults=faults, device="cpu", **kw)
    ties = []                           # deadlines with a response at their
    on_deadline = sim._on_deadline      # time

    def deadline(req):
        buf = req.resp_buf
        if buf and any(e[0] == sim.now for e in buf):
            ties.append(req.resp_ties)
        return on_deadline(req)
    sim._on_deadline = deadline
    rng = np.random.default_rng(23)
    t, done, pauses = 0.0, False, 0
    with obs.session(tracing=False, metrics=True):
        while not done:
            t += float(rng.uniform(1.0, c["slice"]))
            done = sim.step_until(t)
            assert ref.step_until(t) == done, t
            assert sim.now == ref.now
            assert _state(sim) == _state(ref)
            if pauses % 16 == 0:
                assert _state(sim, True) == _state(ref, True)
            pauses += 1
    assert _state(sim, True) == _state(ref, True)
    samples = sum(len(v) for v in _state(sim, True)[1].values())
    assert pauses > 50 and samples > 100
    assert sim.responses_delivered > 0
    assert sim.event_counts[RESPONSE] <= len(sim.metrics.rounds) \
        + sim.metrics.revoked_responses
    if blackouts:
        assert sim.metrics.revoked_responses > 0
    if floored:
        assert len(ties) > 0 and sim.metrics.aborts > 0
    assert sim.finish().summary() == ref.finish().summary()
