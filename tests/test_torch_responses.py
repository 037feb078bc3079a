"""The response that completes a round, known when the request fills.

When a request fills, every one of its responses is in its buffer, so the
simulator arms the round's one RESPONSE entry then, at the response where
the responses reach quorum (or none, and the deadline decides the round).
Each case here is one job under FIFO on a stream made by hand (one row a
granted device: its check-in time, its response time and whether it fails)
and is held against the reference simulator, which handles one event a
response, on both drain engines: each round's completion time and counts,
the aborts and the responses revoked, and one event ending each attempt.
Last, VENN's profiles at every replan are held against the reference too.
"""
import numpy as np
import pytest

from repro_torch import obs
from repro_torch.core import SCHEDULERS
from repro_torch.core.types import Job
from repro_torch.faults.plan import Blackout, FaultPlan
from repro_torch.sim import (DeviceChunk, JobTraceConfig, PopulationConfig,
                             SimConfig, generate_jobs)
from repro_torch.sim import simulator as simmod
from repro_torch.sim.devices import REQ_GENERAL
from repro_torch.sim.simulator import Simulator
import torch_parity  # noqa: F401  (pins torch to one thread)

DEMAND, DEADLINE = 5, 100.5                  # quorum: ceil(0.8 * 5) = 4


class _Rows:
    """One chunk of rows ``(check-in time, response time, ok)``; the
    response time rides in ``resp_z`` and the failure in ``fail_u``."""

    fail_base = 0.5
    fail_slow_boost = 0.0

    def __init__(self, rows, chunk=DeviceChunk):
        self.rows, self.chunk = rows, chunk

    def next_chunk(self):
        if self.rows is None:
            return None
        t, rt, ok = (np.array(c, dtype=float) for c in zip(*self.rows))
        n = len(t)
        self.rows = None
        return self.chunk(times=t, cpu=np.full(n, 2.0), mem=np.full(n, 2.0),
                          speed=np.ones(n), resp_z=rt,
                          fail_u=np.where(ok > 0, 0.9, 0.1))


def _outcome(sim, m):
    (r,) = m.rounds
    return (r.complete, r.responses, r.failures), m.aborts, \
        m.revoked_responses


def _reference(rows, blackouts, monkeypatch):
    """The reference simulator on the same rows: one event a response."""
    from repro.core import SCHEDULERS as REF_SCHEDULERS
    from repro.core.types import Job as RefJob
    from repro.faults.plan import Blackout as RefBlackout
    from repro.faults.plan import FaultPlan as RefFaultPlan
    from repro.sim import DeviceChunk as RefDeviceChunk
    from repro.sim import SimConfig as RefSimConfig
    from repro.sim import simulator as refmod
    from repro.sim.devices import REQ_GENERAL as REF_GENERAL
    from repro.sim.simulator import Simulator as RefSimulator
    monkeypatch.setattr(refmod, "response_time_from",
                        lambda speed, z, mean, sigma: z)
    job = RefJob(job_id=0, requirement=REF_GENERAL, demand_per_round=DEMAND,
                 total_rounds=1, arrival_time=0.0, deadline=DEADLINE,
                 quorum_fraction=0.8)
    faults = RefFaultPlan(blackouts=tuple(RefBlackout(a, b)
                                          for a, b in blackouts),
                          fractional=False) if blackouts else None
    sim = RefSimulator([job], REF_SCHEDULERS["fifo"](seed=0),
                       cfg=RefSimConfig(max_time=5000.0),
                       stream=_Rows(rows, RefDeviceChunk), faults=faults)
    return _outcome(sim, sim.run())


def _run(rows, engine, blackouts=()):
    job = Job(job_id=0, requirement=REQ_GENERAL, demand_per_round=DEMAND,
              total_rounds=1, arrival_time=0.0, deadline=DEADLINE,
              quorum_fraction=0.8)
    faults = FaultPlan(blackouts=tuple(Blackout(a, b) for a, b in blackouts),
                       fractional=False) if blackouts else None
    sim = Simulator([job], SCHEDULERS["fifo"](seed=0),
                    cfg=SimConfig(max_time=5000.0), stream=_Rows(rows),
                    engine=engine, faults=faults, device="cpu")
    with obs.session(tracing=False, metrics=True):
        m = sim.run()
    assert job.completion_time is not None
    return _outcome(sim, m), sim


def _ok(*rts):
    """Rows at check-in times 1, 2, ... with these response times, ok."""
    return [(float(k + 1), rt, 1) for k, rt in enumerate(rts)]


CASES = {
    # four responses before the fill at 5; the first at or after it
    # completes the round
    "quorum-before-fill": _ok(0.5, 0.5, 0.5, 0.5, 10.0),
    # the same, and the response that completes it failed
    "failed-after-fill": _ok(0.5, 0.5, 0.5, 0.5) + [(5.0, 10.0, 0)],
    # quorum before the fill and no response between it and the deadline:
    # the deadline completes the round
    "none-before-deadline": _ok(0.5, 0.5, 0.5, 0.5, 500.0),
    # a failed response lands at the deadline's very time, armed when the
    # fill granted it, before the deadline's entry: it comes first, counted
    # and completing the round
    "at-deadline": _ok(0.5, 0.5, 0.5, 0.5) + [(5.0, DEADLINE, 0)],
    # the quorum-th response lands after the deadline: abort, and the
    # retry (rows after the deadline) completes
    "quorum-never": _ok(0.5, 0.5, 0.5, 200.0, 200.0)
    + [(200.0 + k, 1.0, 1) for k in range(5)],
    # failures keep the round short of quorum: abort and retry
    "failures": [(1.0, 0.5, 1), (2.0, 0.5, 0), (3.0, 0.5, 0), (4.0, 0.5, 1),
                 (5.0, 0.5, 1)] + [(110.0 + k, 1.0, 1) for k in range(5)],
    # responses after the fill, at 21, 23, 25, 27 and 29; a blackout
    # (below) revokes the one at 23, and the round completes at 29
    "blackout-later": _ok(20.0, 21.0, 22.0, 23.0, 24.0),
    # two revoke those at 23 and 25: short of quorum, abort and retry
    "blackout-abort": _ok(20.0, 21.0, 22.0, 23.0, 24.0)
    + [(300.0 + k, 1.0, 1) for k in range(5)],
    # whole-second times: responses land on a check-in and together at the
    # fill, a failed one among them
    "floored": [(1.0, 2.0, 1), (1.0, 4.0, 0), (2.0, 3.0, 1), (3.0, 2.0, 1),
                (5.0, 0.0, 1), (5.0, 2.0, 1), (7.0, 1.0, 1)],
    # the quorum-th response lands at the deadline's time, armed at the
    # fill before the deadline's entry: it completes the round
    "quorum-at-deadline": _ok(0.5, 0.5, 0.5) + [(4.0, 0.5, 0),
                                                (5.0, DEADLINE, 1)],
    # the same response, but armed after the fill (a failure at 64 was the
    # head then): the deadline comes first, short of quorum, and aborts
    "tie-after-fill": _ok(0.5, 0.5, 0.5) + [(4.0, 60.0, 0),
                                            (5.0, DEADLINE, 1)]
    + [(106.0 + k, 1.0, 1) for k in range(5)],
    # two responses at the deadline's time, a failure first, and two
    # entries armed there before the fill (the head left it and came
    # back): both come before the deadline, and the second completes
    "two-at-deadline": [(1.0, 104.5, 0), (2.0, 1.0, 1), (3.0, 102.5, 1),
                        (4.0, 0.5, 1), (5.0, 0.5, 1)],
}
BLACKOUTS = {"blackout-later": [(22.5, 23.5)],
             "blackout-abort": [(22.5, 23.5), (24.5, 25.5)]}


@pytest.mark.parametrize("engine", ["python", "array"])
@pytest.mark.parametrize("name", list(CASES))
def test_completion_at_fill_equals_the_reference(name, engine, monkeypatch):
    monkeypatch.setattr(simmod, "response_time_from",
                        lambda speed, z, mean, sigma: z)
    rows, blackouts = CASES[name], BLACKOUTS.get(name, ())
    want = _reference(rows, blackouts, monkeypatch)
    got, sim = _run(rows, engine, blackouts)
    assert got == want
    # each attempt ends at one event: its deadline, or the one RESPONSE
    # entry of the round, the completing response; each blackout here
    # re-arms that entry or drops it, and the old one comes due stale
    p = sim.drain_parts()
    stale = len(blackouts)
    assert p["events.response"] <= 1 + stale
    assert p["events.response"] - stale + p["events.deadline"] == got[1] + 1
    assert got[2] == len(blackouts)


def test_the_cases_reach_each_edge(monkeypatch):
    """What each case is there for happens in the reference: the round's
    completion time and counts, and the aborts."""
    want = {name: _reference(rows, BLACKOUTS.get(name, ()), monkeypatch)[:2]
            for name, rows in CASES.items()}
    end = 5.0 + DEADLINE
    assert want["quorum-before-fill"] == ((15.0, 5, 0), 0)
    assert want["failed-after-fill"] == ((15.0, 4, 1), 0)
    assert want["none-before-deadline"] == ((end, 4, 0), 0)
    assert want["at-deadline"] == ((end, 4, 1), 0)
    assert want["quorum-never"] == ((204.0, 4, 0), 1)
    assert want["failures"] == ((114.0, 4, 0), 1)
    assert want["blackout-later"] == ((29.0, 4, 0), 0)
    assert want["blackout-abort"] == ((304.0, 4, 0), 1)
    # four of the five responses land at 5, the fill: the last of them in
    # grant order completes the round, a failure among those before it
    assert want["floored"] == ((5.0, 4, 1), 0)
    assert want["quorum-at-deadline"] == ((end, 4, 1), 0)
    assert want["tie-after-fill"] == ((110.0, 4, 0), 1)
    assert want["two-at-deadline"] == ((end, 4, 1), 0)


def test_profiles_at_every_replan_equal_one_event_each():
    """VENN reads response feedback only in its replan: the samples of
    each ``JobProfile`` at every replan equal those of the reference
    simulator, which handles one event a response."""
    from repro.core import SCHEDULERS as REF_SCHEDULERS
    from repro.sim import JobTraceConfig as RefJobTraceConfig
    from repro.sim import PopulationConfig as RefPopulationConfig
    from repro.sim import SimConfig as RefSimConfig
    from repro.sim import generate_jobs as ref_generate_jobs
    from repro.sim.simulator import Simulator as RefSimulator
    jobs_kw = dict(num_jobs=8, seed=31, demand_lo=10, demand_hi=120,
                   rounds_lo=4, rounds_hi=10)
    pop_kw = dict(seed=32, base_rate=3.0)
    horizon = 2.0 * 86400.0

    def watch(sched):
        seen = []
        inner = sched._reschedule

        def replan(now):
            inner(now)
            seen.append((now, {k: p.samples
                               for k, p in sched.profiles.items()}))
        sched._reschedule = replan
        return seen

    ref_sched = REF_SCHEDULERS["venn"](seed=1)
    want = watch(ref_sched)
    RefSimulator(ref_generate_jobs(RefJobTraceConfig(**jobs_kw)), ref_sched,
                 RefPopulationConfig(**pop_kw),
                 RefSimConfig(max_time=horizon)).run()
    for engine in ("python", "array"):
        sched = SCHEDULERS["venn"](seed=1, device="cpu")
        got = watch(sched)
        Simulator(generate_jobs(JobTraceConfig(**jobs_kw)), sched,
                  PopulationConfig(**pop_kw), SimConfig(max_time=horizon),
                  engine=engine, device="cpu").run()
        assert len(got) == len(want) > 40
        assert got == want
        assert sum(len(v) for v in got[-1][1].values()) > 500
