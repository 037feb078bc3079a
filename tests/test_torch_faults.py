"""Fault injection and crash recovery of the port against the reference's.

* ``FaultPlan`` validation and resolution behave as the reference's;
* the ``FaultInjector`` delivers the reference's chunks array for array and
  counts the same faults, for each fault kind and for seeded random plans
  (its draws come from NumPy generators in the same order);
* the simulator-side counters (revocations, dropped check-ins, degraded
  segments) equal the reference's;
* ``run_with_crashes`` on both drain engines of the port gives the crash-free
  run's metrics and the reference's ``run_with_crashes`` at the same crash
  times and lag, bit for bit, with the same recovery count; snapshots are
  atomic, foreign ones are refused, replay streams pickle mid-read.

All of it on ``device="cpu"`` (the kernels' plain versions), at the reference
tests' size: ``fast_scaled``, then 5 jobs over 1.5 simulated days.
"""
import math
import pickle
from dataclasses import replace

import numpy as np
import pytest

import repro.faults as RF
import repro.scenarios as R
from repro.accel.engine import ArrayMatchEngine as RefArrayMatchEngine
from repro.core import SCHEDULERS as REF_SCHEDULERS
from repro.sim.simulator import Simulator as RefSimulator
import repro_torch.faults as PF
import repro_torch.scenarios as P
from repro_torch.core import SCHEDULERS, VennScheduler
from repro_torch.scenarios.trace_io import RecordingStream
from repro_torch.sim.simulator import Simulator
from torch_parity import assert_same_metrics, tiny_pair

_COLS = ("times", "cpu", "mem", "speed", "resp_z", "fail_u")


def _drain(stream):
    out = []
    while True:
        ck = stream.next_chunk()
        if ck is None:
            return out
        out.append(ck)


def _same_plan(mod, plan_kw):
    """The same plan built from each package's dataclasses."""
    kw = {}
    for key, val in plan_kw.items():
        if key == "blackouts":
            val = tuple(mod.Blackout(**b) for b in val)
        elif key == "chunk_chaos":
            val = mod.ChunkChaos(**val)
        elif key == "clock_skew":
            val = mod.ClockSkew(**val)
        elif key == "flaky_ingest":
            val = mod.FlakyIngest(**val)
        kw[key] = val
    return mod.FaultPlan(**kw)


def _random_plan_kw(rng):
    """The reference tests' random plan, as keyword data."""
    blackouts = []
    for _ in range(int(rng.integers(0, 3))):
        start = float(rng.uniform(0.0, 0.4))
        blackouts.append(dict(
            start=start, stop=min(1.0, start + float(rng.uniform(0.01, 0.5))),
            drop_prob=float(rng.uniform(0.1, 1.0))))
    return dict(
        blackouts=blackouts,
        chunk_chaos=dict(drop_prob=float(rng.uniform(0, 0.5)),
                         dup_prob=float(rng.uniform(0, 0.5)),
                         reorder_prob=float(rng.uniform(0, 0.5)),
                         corrupt_speed_prob=float(rng.uniform(0, 0.5))),
        clock_skew=dict(fraction=float(rng.uniform(0, 0.3)), max_skew=3600.0),
        flaky_ingest=dict(fail_prob=float(rng.uniform(0, 0.5)),
                          max_retries=3, backoff=1.0),
        seed=int(rng.integers(0, 2 ** 16)))


PLANS = {
    "empty": {},
    "dup_reorder": dict(chunk_chaos=dict(dup_prob=0.6, reorder_prob=0.6),
                        seed=3),
    "skew": dict(clock_skew=dict(fraction=0.2, max_skew=7200.0), seed=5),
    "flaky": dict(flaky_ingest=dict(fail_prob=0.6, max_retries=1,
                                    backoff=2.0), seed=1),
    "blackout_partial": dict(blackouts=[dict(start=0.02, stop=0.3,
                                             drop_prob=0.4)], seed=1),
    "drop_corrupt": dict(chunk_chaos=dict(drop_prob=0.3,
                                          corrupt_speed_prob=0.1), seed=9),
    **{f"random{i}": _random_plan_kw(np.random.default_rng(2026 + i))
       for i in range(3)},
}


# ---------------------------------------------------------------- the plan

def test_fault_plan_validation_rejects_bad_values():
    with pytest.raises(ValueError, match="start < stop"):
        PF.FaultPlan(blackouts=(PF.Blackout(start=0.5, stop=0.5),)).validate()
    with pytest.raises(ValueError, match="before 1.0"):
        PF.FaultPlan(blackouts=(PF.Blackout(start=0.5, stop=1.5),)).validate()
    with pytest.raises(ValueError, match="drop_prob"):
        PF.FaultPlan(blackouts=(PF.Blackout(0.1, 0.2, drop_prob=1.5),)
                     ).validate()
    with pytest.raises(ValueError, match="dup_prob"):
        PF.FaultPlan(chunk_chaos=PF.ChunkChaos(dup_prob=-0.1)).validate()
    with pytest.raises(ValueError, match="fail_prob"):
        PF.FaultPlan(flaky_ingest=PF.FlakyIngest(fail_prob=1.0)).validate()
    with pytest.raises(ValueError, match="max_skew"):
        PF.FaultPlan(clock_skew=PF.ClockSkew(fraction=0.1, max_skew=-1.0)
                     ).validate()


def test_resolve_scales_windows_and_is_idempotent():
    plan = PF.FaultPlan(blackouts=(PF.Blackout(0.25, 0.5),))
    r = plan.resolve(1000.0)
    assert not r.fractional
    assert r.blackouts[0].start == 250.0 and r.blackouts[0].stop == 500.0
    assert r.resolve(77.0) is r
    assert PF.FaultPlan().is_empty and not plan.is_empty


def test_injector_requires_resolved_plan():
    _, spec = tiny_pair("baseline_even")
    with pytest.raises(ValueError, match="resolve"):
        PF.FaultInjector(P.build_stream(spec, 0),
                         PF.FaultPlan(blackouts=(PF.Blackout(0.1, 0.2),)))
    with pytest.raises(ValueError, match="horizon"):
        PF.inject(P.build_stream(spec, 0),
                  PF.FaultPlan(blackouts=(PF.Blackout(0.1, 0.2),)))


# ------------------------------------------------------- the injector

@pytest.mark.parametrize("plan_name", sorted(PLANS))
def test_injector_equals_the_reference(plan_name):
    ref_spec, port_spec = tiny_pair("baseline_even")
    horizon = port_spec.sim.max_time
    a = RF.inject(R.build_stream(ref_spec, 0),
                  _same_plan(RF, PLANS[plan_name]), horizon)
    b = PF.inject(P.build_stream(port_spec, 0),
                  _same_plan(PF, PLANS[plan_name]), horizon)
    ca, cb = _drain(a), _drain(b)
    assert len(ca) == len(cb)
    last = -math.inf
    for x, y in zip(ca, cb):
        for col in _COLS:
            np.testing.assert_array_equal(getattr(x, col), getattr(y, col))
        assert np.all(np.diff(y.times) >= 0) and y.times[0] >= last
        last = float(y.times[-1])
    assert b.fault_counters() == a.fault_counters()
    assert b.dropped_checkins == a.dropped_checkins


def test_injector_pickles_mid_stream():
    _, spec = tiny_pair("baseline_even")
    plan = _same_plan(PF, PLANS["random1"])
    a = PF.inject(P.build_stream(spec, 0), plan, spec.sim.max_time)
    b = PF.inject(P.build_stream(spec, 0), plan, spec.sim.max_time)
    a.next_chunk(), b.next_chunk()
    b = pickle.loads(pickle.dumps(b))
    for x, y in zip(_drain(a), _drain(b)):
        np.testing.assert_array_equal(x.times, y.times)
        np.testing.assert_array_equal(x.speed, y.speed)
    assert a.fault_counters() == b.fault_counters()


# ------------------------------------------------ simulator-side counters

def test_fault_free_run_has_zero_resilience_counters():
    _, spec = tiny_pair("baseline_even")
    for engine in ("python", "array"):
        res = P.run_one(spec, "venn", seed=0, engine=engine,
                        device="cpu").metrics.resilience()
        assert res.pop("submitted_rounds") > 0
        assert all(v == 0 for v in res.values()), res


@pytest.mark.parametrize("engine", ["python", "array"])
def test_blackout_storm_counters_equal_the_reference(engine):
    ref_spec, port_spec = tiny_pair("blackout_storm")
    ref = R.run_one(ref_spec, "venn", seed=0, engine=engine).metrics
    port = P.run_one(port_spec, "venn", seed=0, engine=engine,
                     device="cpu").metrics
    assert_same_metrics(ref, port)
    res = port.resilience()
    assert res["dropped_checkins"] > 0 and res["revoked_responses"] > 0


def test_corrupt_speeds_degrade_like_the_reference_kernel_backend():
    """NaN speeds: every segment that holds one is served by the sequential
    oracle and counted, as in the reference's kernel-backed (``jax``) array
    engine — its NumPy engine serves live subsets of 24 rows or fewer by the
    same oracle without counting them.  At ``fast_scaled`` size the two
    reference backends count differently, and the port counts as ``jax``."""
    spec = R.fast_scaled(R.get_scenario("flaky_ingest"))
    plan = spec.fault_plan.resolve(spec.sim.max_time)
    engine = RefArrayMatchEngine(backend="jax")
    ref = RefSimulator(R.build_jobs(spec, 0), REF_SCHEDULERS["venn"](seed=0),
                       cfg=spec.sim,
                       stream=RF.FaultInjector(R.build_stream(spec, 0), plan),
                       engine=engine, faults=plan).run()
    ref_np = R.run_one(spec, "venn", seed=0, engine="array").metrics
    port_spec = P.fast_scaled(P.get_scenario("flaky_ingest"))
    port = P.run_one(port_spec, "venn", seed=0, engine="array",
                     device="cpu")
    py = P.run_one(port_spec, "venn", seed=0, engine="python", device="cpu")
    assert_same_metrics(ref, port.metrics)
    assert_same_metrics(ref_np, port.metrics, skip=("degraded_segments",))
    assert_same_metrics(py.metrics, port.metrics,
                         skip=("degraded_segments",))
    eng = port.sim.engine
    assert port.metrics.degraded_segments == eng.degraded["nonfinite"] > 0
    assert eng.degraded["exception"] == eng.degraded["implausible"] == 0
    assert py.metrics.degraded_segments == 0


def test_replan_budget_serves_stale_plans_and_completes():
    from repro_torch.accel.engine import ArrayMatchEngine
    _, spec = tiny_pair("baseline_even")
    engine = ArrayMatchEngine(device="cpu", replan_budget_s=600.0)
    m = _make_sim(P, spec, engine=engine).run()
    assert math.isfinite(m.avg_jct) and len(m.jcts) == spec.jobs.num_jobs
    assert engine.stale_plans_served > 0
    assert m.resilience()["stale_plans_served"] == engine.stale_plans_served


def test_comparison_table_renders_resilience_block():
    ref_spec, port_spec = tiny_pair("blackout_storm")
    table = P.comparison_table([P.run_one(port_spec, "venn", seed=0,
                                          device="cpu")])
    assert "revoked_responses" in table
    ref = R.comparison_table([R.run_one(ref_spec, "venn", seed=0)])
    assert table.splitlines()[-3:] == ref.splitlines()[-3:]


# ---------------------------------------------------------- crash recovery

def _make_sim(mod, spec, engine=None):
    """``run_one``'s simulator, on the host for the port."""
    plan = spec.fault_plan.resolve(spec.sim.max_time) \
        if spec.fault_plan is not None else None
    stream = mod.build_stream(spec, 0)
    if plan is not None and not plan.is_empty:
        stream = (RF if mod is R else PF).FaultInjector(stream, plan)
    jobs = mod.build_jobs(spec, 0)
    if mod is R:
        return RefSimulator(jobs, REF_SCHEDULERS["venn"](seed=0),
                            cfg=spec.sim, stream=stream, engine=engine,
                            faults=plan)
    return Simulator(jobs, VennScheduler(seed=0, device="cpu"), cfg=spec.sim,
                     stream=stream, engine=engine, faults=plan, device="cpu")


@pytest.mark.parametrize("engine", ["python", "array"])
@pytest.mark.parametrize("scenario", ["baseline_even", "blackout_storm"])
def test_crash_recovery_bit_identical(engine, scenario, tmp_path):
    ref_spec, port_spec = tiny_pair(scenario)
    crash_free = _make_sim(P, port_spec, engine).run()
    kw = dict(crash_times=[2000.0, 3500.0, 5000.0], snapshot_lag=300.0)
    crashed = PF.run_with_crashes(lambda: _make_sim(P, port_spec, engine),
                                  ckpt_dir=str(tmp_path / "port"), **kw)
    ref = RF.run_with_crashes(lambda: _make_sim(R, ref_spec, engine),
                              ckpt_dir=str(tmp_path / "ref"), **kw)
    assert_same_metrics(crash_free, crashed, skip=("recovery_events",))
    assert crashed.rounds == crash_free.rounds
    assert_same_metrics(ref, crashed)
    assert crashed.resilience()["recovery_events"] == 3
    assert crash_free.resilience()["recovery_events"] == 0
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) \
        == sorted(p.name for p in (tmp_path / "ref").iterdir())


def test_crash_recovery_in_a_temporary_directory():
    _, spec = tiny_pair("flaky_ingest")
    crash_free = _make_sim(P, spec, "array").run()
    crashed = PF.run_with_crashes(lambda: _make_sim(P, spec, "array"),
                                  crash_times=[4000.0, 8000.0],
                                  snapshot_lag=1000.0)
    assert_same_metrics(crash_free, crashed, skip=("recovery_events",))
    assert crashed.recovery_events == 2


def test_snapshot_is_atomic_and_sweeps_stale_tmp(tmp_path):
    _, spec = tiny_pair("baseline_even")
    sim = _make_sim(P, spec, "array")
    sim.start()
    sim.step_until(1000.0)
    junk = tmp_path / ".tmp-step_00000007"
    junk.mkdir(parents=True)
    (junk / "state.pkl").write_bytes(b"partial")
    assert PF.latest_snapshot_step(str(tmp_path)) is None
    final = PF.snapshot_simulator(sim, str(tmp_path), 0)
    assert not junk.exists()
    assert PF.latest_snapshot_step(str(tmp_path)) == 0
    manifest = (tmp_path / "step_00000000" / "manifest.json").read_text()
    assert '"engine": "ArrayMatchEngine"' in manifest
    assert final.endswith("step_00000000")
    restored = PF.restore_simulator(str(tmp_path))
    assert restored.now == sim.now
    assert restored.engine.state is None and restored.engine._chunk_dev is None
    assert restored.finish().summary() == sim.finish().summary()


def test_snapshot_holds_no_tensor_and_no_replan_engine(tmp_path):
    """What the snapshot drops is what only the process that made it could
    use: the mirror and the uploaded chunk of the array engine, and the
    scheduler's replan engine (both rebuilt from restored state)."""
    import torch
    _, spec = tiny_pair("blackout_storm")
    sim = _make_sim(P, spec, "array")
    sim.start()
    sim.step_until(6000.0)
    assert sim.engine.state is not None and sim.sched._replan is not None
    seen = []

    class Probe(pickle.Pickler):
        def reducer_override(self, obj):
            if isinstance(obj, torch.Tensor):
                seen.append(tuple(obj.shape))
            return NotImplemented

    import io
    Probe(io.BytesIO(), protocol=pickle.HIGHEST_PROTOCOL).dump(sim)
    assert seen == []
    PF.snapshot_simulator(sim, str(tmp_path), 0)
    restored = PF.restore_simulator(str(tmp_path), 0)
    assert restored.sched._replan is None and restored.engine.state is None
    assert restored.metrics.recovery_events == 1
    assert_same_metrics(sim.finish(), restored.finish(),
                         skip=("recovery_events",))


def test_restore_rejects_foreign_or_missing_snapshots(tmp_path):
    with pytest.raises(ValueError, match="no snapshot"):
        PF.restore_simulator(str(tmp_path))
    bad = tmp_path / "step_00000003"
    bad.mkdir()
    with pytest.raises(ValueError, match="manifest"):
        PF.restore_simulator(str(tmp_path), 3)
    (bad / "manifest.json").write_text("{not json")
    with pytest.raises(ValueError, match="corrupt"):
        PF.restore_simulator(str(tmp_path), 3)
    (bad / "manifest.json").write_text('{"format": "something-else"}')
    with pytest.raises(ValueError, match="venn-sim-snapshot"):
        PF.restore_simulator(str(tmp_path), 3)
    assert PF.latest_snapshot_step(str(tmp_path / "missing")) is None


def test_recording_stream_refuses_snapshot(tmp_path):
    _, spec = tiny_pair("baseline_even")
    rec = RecordingStream(P.build_stream(spec, 0), str(tmp_path / "t.csv"))
    try:
        with pytest.raises(TypeError, match="RecordingStream"):
            pickle.dumps(rec)
    finally:
        rec.close()


def test_replay_stream_pickles_mid_stream(tmp_path):
    _, spec = tiny_pair("baseline_even")
    path = str(tmp_path / "trace.csv")
    P.run_one(spec, "venn", seed=0, record=path, device="cpu")
    ref = P.TraceReplayStream(path, chunk_rows=1024, seed=0)
    cut = P.TraceReplayStream(path, chunk_rows=1024, seed=0)
    np.testing.assert_array_equal(ref.next_chunk().times,
                                  cut.next_chunk().times)
    cut2 = pickle.loads(pickle.dumps(cut))
    cut.close()
    while True:
        a, b = ref.next_chunk(), cut2.next_chunk()
        if a is None or b is None:
            assert a is None and b is None
            break
        np.testing.assert_array_equal(a.times, b.times)
        np.testing.assert_array_equal(a.fail_u, b.fail_u)


@pytest.mark.parametrize("suffix", ["csv", "jsonl"])
def test_corrupted_trace_replay_skips_and_counts(tmp_path, suffix):
    ref_spec, port_spec = tiny_pair("churn_storm")
    path = str(tmp_path / f"trace.{suffix}")
    R.run_one(ref_spec, "venn", seed=0, record=path)
    with open(path) as f:
        lines = f.read().splitlines()
    k = 50
    lines[k] = "total garbage {{{"
    lines[k + 1] = lines[k + 1].rsplit(",", 2)[0] if suffix == "csv" \
        else lines[k + 1][: len(lines[k + 1]) // 2]
    lines[k + 2] = lines[k + 2].replace(".", "x", 1)
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    ref = R.run_one(ref_spec, "venn", seed=0, replay=path).metrics
    port = P.run_one(port_spec, "venn", seed=0, replay=path, engine="array",
                     device="cpu").metrics
    assert_same_metrics(ref, port)
    assert port.resilience()["skipped_rows"] == 3


def test_random_plans_over_the_registry_equal_the_reference():
    """The reference's fuzz sweep, each run held against the reference."""
    rng = np.random.default_rng(2026)
    for i, name in enumerate(["baseline_even", "churn_storm", "flash_crowd",
                              "blackout_storm", "flaky_ingest", "hot_atom"]):
        plan_kw = _random_plan_kw(rng)
        ref_spec, port_spec = tiny_pair(name)
        engine = "python" if i % 2 else "array"
        ref = R.run_one(replace(ref_spec,
                                fault_plan=_same_plan(RF, plan_kw)),
                        "venn", seed=0, engine=engine).metrics
        port = P.run_one(replace(port_spec,
                                 fault_plan=_same_plan(PF, plan_kw)),
                         "venn", seed=0, engine=engine, device="cpu").metrics
        res = port.resilience()
        assert len(port.rounds) + port.failed_rounds <= res["submitted_rounds"]
        assert port.makespan <= port_spec.sim.max_time
        assert_same_metrics(ref, port, skip=("degraded_segments",))


def test_the_port_schedulers_take_no_device_but_venn():
    assert "device" in VennScheduler.__init__.__code__.co_varnames
    for name, cls in SCHEDULERS.items():
        if cls is not VennScheduler:
            with pytest.raises(TypeError):
                cls(seed=0, device="cpu")
