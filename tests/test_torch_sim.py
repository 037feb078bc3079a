"""The slice as a whole: the port's simulator vs the reference's.

The same seeds go through ``repro.sim.Simulator(engine="array")`` and through
``repro_torch.sim.Simulator`` with ``engine="array", device="cpu"`` and with
``engine="python"``, for Venn and the baselines, with ``record_grants=True``.
Grant logs, JCTs, round records and ``summary()`` must be equal: they are
integers and f64 values produced by the same host arithmetic, so the
comparison is exact.
"""
import numpy as np
import pytest

from repro.core import SCHEDULERS as REF_SCHEDULERS
from repro.sim import (JobTraceConfig as RefJobTraceConfig,
                       PopulationConfig as RefPopulationConfig,
                       SimConfig as RefSimConfig,
                       generate_jobs as ref_generate_jobs)
from repro.sim.simulator import Simulator as RefSimulator
from repro_torch.core import SCHEDULERS
from repro_torch.sim import (JobTraceConfig, PopulationConfig, SimConfig,
                             generate_jobs, run_workload)
from repro_torch.sim.simulator import Simulator
import torch_parity  # noqa: F401  (pins torch to one thread)


def _sched(name, seed):
    kw = {"device": "cpu"} if name == "venn" else {}
    return SCHEDULERS[name](seed=seed, **kw)


def _run_ref(jobs_kw, pop_kw, days, sched_name, engine):
    sim = RefSimulator(ref_generate_jobs(RefJobTraceConfig(**jobs_kw)),
                       REF_SCHEDULERS[sched_name](seed=1),
                       RefPopulationConfig(**pop_kw),
                       RefSimConfig(max_time=days * 24 * 3600.0),
                       engine=engine, record_grants=True)
    return sim.run(), sim


def _run_port(jobs_kw, pop_kw, days, sched_name, engine):
    sim = Simulator(generate_jobs(JobTraceConfig(**jobs_kw)),
                    _sched(sched_name, 1), PopulationConfig(**pop_kw),
                    SimConfig(max_time=days * 24 * 3600.0),
                    engine=engine, record_grants=True, device="cpu")
    return sim.run(), sim


def _rounds_sig(m):
    return [(r.job_id, r.round_index, r.submit, r.alloc_complete, r.complete,
             r.demand, r.responses, r.failures, r.retries) for r in m.rounds]


def _assert_same(ref, got):
    (m_ref, s_ref), (m, s) = ref, got
    assert s.grant_log == s_ref.grant_log
    assert m.jcts == m_ref.jcts
    assert _rounds_sig(m) == _rounds_sig(m_ref)
    assert m.summary() == m_ref.summary()
    assert s.checkins_seen + s.checkins_skipped \
        == s_ref.checkins_seen + s_ref.checkins_skipped


@pytest.mark.parametrize("seed,sched_name,rate", [
    (0, "venn", 1.5), (1, "random", 0.7), (2, "srsf", 3.0),
    (3, "venn", 4.0), (4, "fifo", 2.0), (5, "venn", 0.5),
])
def test_port_equals_reference_on_random_workloads(seed, sched_name, rate):
    jobs_kw = dict(num_jobs=4, seed=seed, demand_lo=5, demand_hi=60,
                   rounds_lo=2, rounds_hi=6)
    pop_kw = dict(seed=seed + 7, base_rate=rate)
    ref = _run_ref(jobs_kw, pop_kw, 1.0, sched_name, "array")
    _assert_same(ref, _run_port(jobs_kw, pop_kw, 1.0, sched_name, "array"))
    _assert_same(ref, _run_port(jobs_kw, pop_kw, 1.0, sched_name, "python"))


def test_port_equals_reference_with_tiering_and_contention():
    """Longer run that exercises tier bands, fills, aborts and replans."""
    jobs_kw = dict(num_jobs=8, seed=5, demand_lo=20, demand_hi=150,
                   rounds_lo=3, rounds_hi=10)
    pop_kw = dict(seed=11, base_rate=3.0)
    ref = _run_ref(jobs_kw, pop_kw, 4.0, "venn", "array")
    got = _run_port(jobs_kw, pop_kw, 4.0, "venn", "array")
    _assert_same(ref, got)
    _assert_same(ref, _run_port(jobs_kw, pop_kw, 4.0, "venn", "python"))
    eng, ref_eng = got[1].engine, ref[1].engine
    assert eng.backend == "torch" and str(eng.device) == "cpu"
    assert eng.segments == ref_eng.segments > 0
    assert (eng.rebuilds, eng.patches) == (ref_eng.rebuilds, ref_eng.patches)
    assert eng.fixedpoint_rounds > 0
    assert eng.degraded == {"nonfinite": 0, "exception": 0, "implausible": 0}


@pytest.mark.parametrize("order", ["numpy", "kernel"])
def test_port_array_drain_with_kernel_resort_and_checks(order, monkeypatch):
    """Paranoid modes on (mirror and replan self-checks), resort through the
    kernel wrapper: still the reference's grants."""
    monkeypatch.setenv("REPRO_MATCH_CHECK", "1")
    monkeypatch.setenv("REPRO_REPLAN_CHECK", "1")
    jobs_kw = dict(num_jobs=6, seed=9, demand_lo=10, demand_hi=80,
                   rounds_lo=2, rounds_hi=5)
    pop_kw = dict(seed=21, base_rate=2.0)
    ref = _run_ref(jobs_kw, pop_kw, 2.0, "venn", None)
    monkeypatch.setenv("REPRO_REPLAN_ORDER", order)
    got = _run_port(jobs_kw, pop_kw, 2.0, "venn", "array")
    _assert_same(ref, got)
    assert got[1].sched._replan.order_backend == order


def test_full_rebuild_pin_equals_delta_mirror(monkeypatch):
    jobs_kw = dict(num_jobs=5, seed=2, demand_lo=10, demand_hi=60,
                   rounds_lo=2, rounds_hi=5)
    pop_kw = dict(seed=3, base_rate=2.5)
    delta = _run_port(jobs_kw, pop_kw, 1.5, "venn", "array")
    monkeypatch.setenv("REPRO_MATCH_DELTA", "0")
    full = _run_port(jobs_kw, pop_kw, 1.5, "venn", "array")
    _assert_same(delta, full)
    assert full[1].engine.patches == 0 and delta[1].engine.patches > 0


def test_run_workload_takes_device_and_array_needs_one():
    jobs = generate_jobs(JobTraceConfig(num_jobs=2, seed=1, demand_lo=5,
                                        demand_hi=10, rounds_lo=1,
                                        rounds_hi=2))
    m = run_workload(jobs, _sched("venn", 1),
                     PopulationConfig(seed=4, base_rate=1.0),
                     SimConfig(max_time=6 * 3600.0), engine="array",
                     device="cpu")
    assert len(m.rounds) >= 1
    with pytest.raises(RuntimeError, match="CUDA"):
        Simulator(jobs, _sched("fifo", 1), engine="array")
    with pytest.raises(ValueError, match="unknown engine"):
        Simulator(jobs, _sched("fifo", 1), engine="warp", device="cpu")


def test_nonfinite_speeds_degrade_in_the_port_as_in_the_reference():
    """A stream with NaN speed readings: both packages degrade the same
    segments to the sequential oracle and grant identically."""
    from repro.core.types import Job as RefJob
    from repro.sim.devices import (DeviceChunk as RefChunk,
                                   REQ_GENERAL as REF_GENERAL)
    from repro_torch.core.types import Job
    from repro_torch.sim.devices import DeviceChunk, REQ_GENERAL

    def stream(chunk_cls):
        class S:
            fail_base = 0.0
            fail_slow_boost = 0.0

            def __init__(self):
                self.i = 0

            def next_chunk(self):
                self.i += 1
                if self.i > 3:
                    return None
                rng = np.random.default_rng(self.i)
                n = 400
                t = np.sort(rng.uniform(0, 300, n)) + 300 * (self.i - 1) + 1
                speed = rng.uniform(0.5, 2.0, n)
                speed[rng.integers(0, n, 12)] = np.nan
                return chunk_cls(times=t, cpu=np.full(n, 4.0),
                                 mem=np.full(n, 4.0), speed=speed,
                                 resp_z=np.zeros(n), fail_u=np.full(n, 0.9))
        return S()

    def jobs(job_cls, req):
        return [job_cls(job_id=i, requirement=req, demand_per_round=150,
                        total_rounds=2, arrival_time=0.0) for i in range(3)]

    ref = RefSimulator(jobs(RefJob, REF_GENERAL), REF_SCHEDULERS["fifo"](seed=0),
                       cfg=RefSimConfig(max_time=2000.0),
                       stream=stream(RefChunk), engine="array",
                       record_grants=True)
    m_ref = ref.run()
    got = Simulator(jobs(Job, REQ_GENERAL), SCHEDULERS["fifo"](seed=0),
                    cfg=SimConfig(max_time=2000.0), stream=stream(DeviceChunk),
                    engine="array", record_grants=True, device="cpu")
    m = got.run()
    assert got.grant_log == ref.grant_log and len(got.grant_log) > 100
    assert m.jcts == m_ref.jcts
    assert got.engine.degraded["nonfinite"] == ref.engine.degraded_segments > 0
    assert m.degraded_segments == m_ref.degraded_segments
