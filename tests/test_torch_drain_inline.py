"""Control events handled inside the array drain's scalar route.

The array drain (``engine="array"``, ``device="cpu"``) handles a RESPONSE
that cannot complete its round in place, between two rows, and goes on.
Each case runs the same workload through it and through the per-device
drain (``engine="python"``), which handles every event in the loop: grant
logs, round records, JCTs and ``summary()`` must be equal, and so must the
check-ins decided and the clock at the end.  A spy on the array run records
the edge each case is there for, and the case fails if the edge never
happened.
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
    that check-ins share times with each other and with events."""

    def __init__(self, pop: PopulationConfig, horizon: float):
        self.inner = GeneratorStream(DeviceGenerator(pop), horizon)
        self.fail_base = self.inner.fail_base
        self.fail_slow_boost = self.inner.fail_slow_boost

    def next_chunk(self):
        ck = self.inner.next_chunk()
        if ck is not None:
            ck.times = np.floor(ck.times)
        return ck


class _Spy:
    """Wraps the array simulator's inert test, its inline handler, its
    scalar route and its scheduler's ``checkin`` on the instance, and counts
    the edges they meet.  For VENN a check-in whose atom its dispatch table
    does not cover is a MISS (``miss``); a route that takes one after rows
    of its own counts as ``mid_route_miss``, and the clock right after each
    route that took a MISS goes to ``miss_clocks`` beside the MISS row's
    time."""

    def __init__(self, sim: Simulator):
        self.sim = sim
        self.seen: dict = {}
        self.last_inline_t = None
        self.last_inert = None
        self.miss_clocks: list = []
        inert, inline = sim._inert, sim._inline_events
        route, checkin = sim._drain_array_scalar, sim.sched.checkin

        def spy_inert(t, kind, payload):
            out = inert(t, kind, payload)
            self.last_inert = (t, kind, out)
            if kind != RESPONSE:
                self.note("fault" if kind == simmod.FAULT else "other_kind")
                return out
            buf = payload.resp_buf
            if payload.resp_t != t or not buf:
                self.note("stale")
            elif not buf[0][4] and not out \
                    and payload.responses >= payload.quorum:
                # quorum came before the fill: this failed response
                # completes the round
                self.note("failed_after_fill")
            self.note("inert" if out else "completing")
            return out

        def spy_inline(t_i, token=None):
            out = inline(t_i, token)
            heap = sim._heap
            if out:
                self.last_inline_t = sim.now
            elif not heap or heap[0][0] >= t_i:
                self.note("guard")      # the plan moved under the route
            return out

        def spy_route(state, cursor, heap_t, bound):
            self.last_inline_t = None
            missed = route(state, cursor, heap_t, bound)
            i, times = sim._cursor, sim._times
            if (self.last_inline_t is not None and i < len(times)
                    and self.last_inline_t <= bound < times[i]):
                self.note("pause_after_inline")
            if missed:
                if i - 1 > cursor:
                    self.note("mid_route_miss")
                self.miss_clocks.append((sim.now, times[i - 1]))
            return missed

        def spy_checkin(aid, cpu, mem, speed, now):
            heap = sim._heap
            if heap and heap[0][0] == now:
                self.note("tie")
            dispatch = getattr(sim.sched, "dispatch", None)
            if dispatch is not None and not dispatch.covers(aid):
                self.note("miss")
            return checkin(aid, cpu, mem, speed, now)

        sim._inert = spy_inert
        sim._inline_events = spy_inline
        sim._drain_array_scalar = spy_route
        sim.sched.checkin = spy_checkin

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
                        edge="pause_after_inline",
                        pop=dict(seed=15, base_rate=2.0)),
    "same-time": dict(sched="venn", jobs=_small(9), days=2.0, floored=True,
                      edge="tie", pop=dict(seed=16, base_rate=2.0)),
    "blackout": dict(sched="venn", jobs=_small(10), days=0.25,
                     edge="fault", blackouts=[(k / 32, k / 32 + 0.0125, 0.5)
                                              for k in range(1, 32)],
                     pop=dict(seed=17, base_rate=2.0)),
    "replan-on-response": dict(sched="venn", jobs=_small(12), days=2.0,
                               dirty_on_response=True, edge="guard",
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
    assert 0 < sim.inline_events <= sim.event_counts[RESPONSE]
    assert spy.seen.get("inert", 0) >= sim.inline_events
    if case["sched"] == "venn":
        # the route takes every MISS, one a call, and ends on it with the
        # clock at its row
        assert sim.head_misses == spy.seen.get("miss", 0) \
            == len(spy.miss_clocks) > 0
        assert all(now == t for now, t in spy.miss_clocks), spy.miss_clocks
    edge = case.get("edge")
    if edge == "last_job":
        # the drain meets the response that completes the last round, finds
        # it not inert and leaves it to the loop; the run ends there, and no
        # check-in after it is examined
        last = max(j.completion_time for j in sim.jobs)
        assert all(j.completion_time is not None for j in sim.jobs)
        assert sim.now == last == max(r.complete for r in m.rounds)
        assert spy.last_inert == (last, RESPONSE, False)
        assert sim._times[sim._cursor - 1] <= last
    elif edge is not None:
        assert spy.seen.get(edge, 0) > 0, spy.seen
    if edge == "fault":
        assert m.revoked_responses > 0


def test_routing_to_the_matcher_is_unchanged(monkeypatch):
    """On a workload with long quiet gaps between events, the matcher's
    calls and rows equal those of a drain that never handles an event
    inline (its inert test patched to False)."""
    case = dict(sched="venn", days=3.0,
                jobs=_small(11, num_jobs=4, demand_lo=200, demand_hi=600),
                pop=dict(seed=18, base_rate=12.0))

    def run():
        sim = _build(case, "array")
        with obs.session(tracing=False, metrics=True):
            sim.run()
        return sim

    inline = run()
    monkeypatch.setattr(Simulator, "_inert",
                        lambda self, t, kind, payload: False)
    plain = run()
    assert inline.inline_events > 0 and plain.inline_events == 0
    assert plain.vector_segments > 0
    assert (inline.vector_segments, inline.vector_rows) \
        == (plain.vector_segments, plain.vector_rows)
    assert inline.engine.matcher_calls == plain.engine.matcher_calls
    assert inline.engine.segments == plain.engine.segments
    assert inline.grant_log == plain.grant_log
    assert inline.drain_segments < plain.drain_segments
