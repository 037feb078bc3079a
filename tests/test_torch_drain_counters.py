"""The drain's parts: counters and self times inside ``Simulator.step_until``.

A small VENN simulation on the array drain (``device="cpu"``) runs with
observability on and off.  With it on (the registry, or a tracer that
records ``sim``), the counts must add up: grants to the grant log, the
routes' rows to the check-ins examined, the control events by kind to the
events handled, each mirrored into the registry and, for events, into the
``sim.event.*`` spans.  The self times must not overlap: the drain's
seconds less every named part leave a positive remainder (its segment
bookkeeping), and the step's own stopwatch agrees with the caller's clock.
With it off, or with a tracer that records other categories only, every
part reads 0, and the grant log and ``summary()`` are bit-identical either
way.
"""
import time

import pytest

from repro_torch import obs
from repro_torch.core import SCHEDULERS
from repro_torch.obs.trace import Tracer
from repro_torch.sim import (JobTraceConfig, PopulationConfig, SimConfig,
                             generate_jobs)
from repro_torch.sim.simulator import EVENT_KINDS, Simulator
import torch_parity  # noqa: F401  (pins torch to one thread)

HANDLERS = ("_on_job_arrival", "_on_response_entry", "_on_deadline",
            "_on_blackout")


def _sim():
    jobs = generate_jobs(JobTraceConfig(num_jobs=6, seed=3, demand_lo=20,
                                        demand_hi=200, rounds_lo=2,
                                        rounds_hi=5))
    return Simulator(jobs, SCHEDULERS["venn"](seed=1, device="cpu"),
                     PopulationConfig(seed=9, base_rate=3.0),
                     SimConfig(max_time=4 * 86400.0), engine="array",
                     record_grants=True, device="cpu")


def _drive(sim, handled=None):
    """Run to the end in 10-minute slices; the caller's wall time.
    ``handled`` counts the events handled by kind, and the responses
    applied (``applied``)."""
    if handled is not None:
        for kind, name in zip(EVENT_KINDS, HANDLERS):
            inner = getattr(sim, name)

            def counted(payload, inner=inner, kind=kind):
                handled[kind] += 1
                return inner(payload)
            setattr(sim, name, counted)
        on_response = sim.sched.on_response

        def applied(*a):
            handled["applied"] += 1
            return on_response(*a)
        sim.sched.on_response = applied
    wall, t, done = 0.0, 0.0, False
    while not done:
        t += 600.0
        w = time.perf_counter()
        done = sim.step_until(t)
        wall += time.perf_counter() - w
    sim.finish()
    return wall


@pytest.fixture(scope="module")
def traced():
    sim = _sim()
    handled = dict.fromkeys(EVENT_KINDS + ("applied",), 0)
    with obs.session(tracing=True, metrics=True) as (tr, reg):
        wall = _drive(sim, handled)
        spans = [e for e in tr.events if e["name"].startswith("sim.event.")]
        counters = {k: reg.counter(k).value for k in
                    ["sim." + k for k in sim.drain_parts()]}
    return sim, handled, wall, spans, counters


def test_counts_add_up(traced):
    sim, handled, _, spans, counters = traced
    p = sim.drain_parts()
    assert p["grants"] == len(sim.grant_log) > 0
    assert p["vector_rows"] + p["scalar_rows"] + p["head_misses"] \
        == sim.checkins_seen
    assert p["vector_segments"] > 0 and p["scalar_segments"] > 0
    # every segment is prepared once (a re-match after a wider export is
    # prepared again), and the scalar route takes at most one MISS a call
    assert p["drain_segments"] >= p["vector_segments"] \
        + p["scalar_segments"]
    assert 0 < p["head_misses"] <= p["scalar_segments"]
    assert p["idle_rows"] <= sim.checkins_skipped
    assert p["idle_skips"] > 0
    for kind in EVENT_KINDS:
        n = sum(1 for e in spans if e["name"] == "sim.event." + kind)
        assert p["events." + kind] == handled[kind] == n, kind
        dur = sum(e["dur"] for e in spans if e["name"] == "sim.event." + kind)
        assert dur / 1e6 == pytest.approx(p["event_seconds." + kind],
                                          rel=1e-9, abs=1e-9)
    assert handled["arrival"] == len(sim.jobs)
    assert {"sim." + k: v for k, v in p.items()} == pytest.approx(counters)


def test_self_times_do_not_overlap(traced):
    sim, _, wall, _, _ = traced
    p, eng = sim.drain_parts(), sim.engine
    named = {"stream": sim.stream_seconds, "matcher": eng.matcher_s,
             "mirror": eng.rebuild_s + eng.patch_s,
             "replan": sim.sched.replan_seconds,
             "scalar": p["scalar_seconds"], "grants": p["grant_seconds"],
             "idle": p["idle_seconds"]}
    assert all(v > 0 for v in named.values()), named
    bookkeeping = sim.drain_seconds - sum(named.values())
    assert bookkeeping > 0
    events = sum(p["event_seconds." + k] for k in EVENT_KINDS)
    loop_own = p["step_seconds"] - sim.drain_seconds - events
    assert loop_own > 0
    parts = sum(named.values()) + bookkeeping + events + loop_own
    assert parts == pytest.approx(wall, rel=0.02)


@pytest.mark.parametrize("categories", [None, {"sched", "accel"}])
def test_without_a_reader_no_parts_are_kept_and_no_outcome_changes(
        traced, categories):
    """Observability off, or a tracer that records other categories than
    ``sim`` (the benchmark's traced capture) and no registry."""
    on = traced[0]
    off = _sim()
    if categories is None:
        _drive(off)
        assert off.sched.replan_seconds == 0
    else:
        with obs.session(tracing=True, metrics=False, categories=categories):
            _drive(off)
    assert all(v == 0 for v in off.drain_parts().values())
    assert off.grant_log == on.grant_log
    assert repr(off.metrics.summary()) == repr(on.metrics.summary())
    assert off.metrics.jcts == on.metrics.jcts


def test_delivered_responses_are_counted_beside_the_completing_ones(traced):
    """Each response is applied once: delivered as data (counted in
    ``responses_delivered``) or as the one RESPONSE entry of its round,
    which completes it; nearly all are data."""
    sim, handled, _, _, counters = traced
    p = sim.drain_parts()
    assert 0 < p["events.response"] == handled["response"] \
        <= len(sim.metrics.rounds)
    assert p["responses_delivered"] + p["events.response"] \
        == handled["applied"]
    assert p["responses_delivered"] >= 0.9 * handled["applied"]
    assert counters["sim.responses_delivered"] == p["responses_delivered"]
    assert sim.delivery_seconds > 0


@pytest.mark.parametrize("with_obs", [False, True])
def test_delivery_time_is_not_drain_time(with_obs):
    """Response feedback made slow (2 ms a response) leaves the drain's
    stopwatch and the scalar route's self time as they were: the
    deliveries before replans and at fills are timed apart, whether or not
    the parts are kept, and the completing responses are their events'
    time."""
    sim = _sim()
    inner = sim.sched.on_response

    def slow(*a):
        t = time.perf_counter()
        while time.perf_counter() - t < 2e-3:
            pass
        return inner(*a)
    sim.sched.on_response = slow
    if with_obs:
        with obs.session(tracing=True, metrics=True):
            _drive(sim)
    else:
        _drive(sim)
    assert sim.delivery_seconds >= 2e-3 * 100
    assert sim.drain_seconds < 0.5 * sim.delivery_seconds
    if with_obs:
        p = sim.drain_parts()
        assert p["responses_delivered"] >= 100
        assert p["event_seconds.response"] >= 2e-3 * p["events.response"]
        assert p["scalar_seconds"] < 0.5 * sim.delivery_seconds
    else:
        assert sim.responses_delivered == 0


def test_trace_export_gives_its_clock_and_origin():
    tr = Tracer()
    t = time.perf_counter()
    assert tr.t0 <= t and tr._t0 == tr.t0
    assert tr.us(t) == pytest.approx((t - tr.t0) * 1e6)
    other = tr.export()["otherData"]
    assert other["clock"] == "perf_counter" and other["t0_s"] == tr.t0
