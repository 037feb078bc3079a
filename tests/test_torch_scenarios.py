"""The scenario registry of the port against the reference's.

The same names, specs and device streams; every registered scenario driven
through ``run_one`` on both drain engines of the port (``device="cpu"``, the
kernels' plain versions) gives the same ``summary()``, ``resilience()``,
JCTs and round records as the same engine of the reference, bit for bit
(host state is int64/float64 in both); trace recordings are byte-identical
and replay across the two packages; the CLI runs list, run and replay.
Sizes are the reference tests' own: ``fast_scaled`` and then 5 jobs over 1.5
simulated days.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.scenarios as R
from repro.faults import FaultInjector as RefInjector
from repro.scenarios.__main__ import main as ref_cli
import repro_torch.scenarios as P
from repro_torch.faults import FaultInjector as PortInjector
from repro_torch.scenarios.__main__ import main as port_cli
from torch_parity import assert_same_metrics, tiny_pair

NAMES = R.scenario_names()
_COLS = ("times", "cpu", "mem", "speed", "resp_z", "fail_u")


# ------------------------------------------------------------------ registry

def test_registry_has_the_reference_names_in_its_order():
    assert P.scenario_names() == NAMES
    assert len(NAMES) == 11
    assert [s.name for s in P.all_scenarios()] == NAMES


@pytest.mark.parametrize("name", NAMES)
def test_spec_equals_the_reference_spec(name):
    ref, port = R.get_scenario(name), P.get_scenario(name)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert dataclasses.asdict(P.fast_scaled(port)) \
        == dataclasses.asdict(R.fast_scaled(ref))
    port.validate()


def test_register_rejects_duplicates_and_non_specs():
    with pytest.raises(ValueError, match="duplicate"):
        P.register(P.get_scenario("baseline_even"))
    with pytest.raises(TypeError, match="ScenarioSpec"):
        P.register(object())
    with pytest.raises(KeyError, match="unknown scenario"):
        P.get_scenario("no_such_scenario")


# ------------------------------------------------------------------- streams

def _stream(mod, spec):
    """``run_one``'s device stream: the scenario's generator, wrapped in the
    fault injector where the spec has a plan."""
    stream = mod.build_stream(spec, 0)
    if spec.fault_plan is not None:
        plan = spec.fault_plan.resolve(spec.sim.max_time)
        if not plan.is_empty:
            injector = RefInjector if mod is R else PortInjector
            stream = injector(stream, plan)
    return stream


@pytest.mark.parametrize("name", NAMES)
def test_stream_chunks_equal_the_reference(name):
    ref_spec, port_spec = tiny_pair(name)
    a, b = _stream(R, ref_spec), _stream(P, port_spec)
    for _ in range(4):
        ca, cb = a.next_chunk(), b.next_chunk()
        if ca is None:
            assert cb is None
            break
        for col in _COLS:
            x, y = getattr(ca, col), getattr(cb, col)
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    assert (a.fail_base, a.fail_slow_boost) \
        == (b.fail_base, b.fail_slow_boost)


def test_flaky_ingest_retry_counts_equal_the_reference():
    ref_spec, port_spec = tiny_pair("flaky_ingest")
    a, b = _stream(R, ref_spec), _stream(P, port_spec)
    while True:
        ca, cb = a.next_chunk(), b.next_chunk()
        if ca is None or cb is None:
            assert ca is None and cb is None
            break
        np.testing.assert_array_equal(ca.speed, cb.speed)
    ca, cb = a.fault_counters(), b.fault_counters()
    assert ca == cb
    assert cb["flaky_retries"] > 0 and cb["corrupt_rows"] > 0
    assert b.dropped_checkins == a.dropped_checkins


@pytest.mark.parametrize("name", NAMES)
def test_build_jobs_equal_the_reference(name):
    ref_spec, port_spec = tiny_pair(name)
    fields = ("job_id", "arrival_time", "demand_per_round", "total_rounds",
              "task_time_mean", "task_time_sigma", "quorum_fraction",
              "deadline", "overcommit", "tenant", "priority")
    ra = [tuple(getattr(j, f) for f in fields) + (j.requirement.name,)
          for j in R.build_jobs(ref_spec, 0)]
    pa = [tuple(getattr(j, f) for f in fields) + (j.requirement.name,)
          for j in P.build_jobs(port_spec, 0)]
    assert pa == ra


# ----------------------------------------------------- registry-wide parity

@pytest.mark.parametrize("engine", ["python", "array"])
@pytest.mark.parametrize("name", NAMES)
def test_registry_wide_parity_with_the_reference(name, engine):
    ref_spec, port_spec = tiny_pair(name)
    ref = R.run_one(ref_spec, "venn", seed=0, engine=engine)
    port = P.run_one(port_spec, "venn", seed=0, engine=engine, device="cpu")
    assert_same_metrics(ref.metrics, port.metrics)
    assert len(port.metrics.jcts) == port_spec.jobs.num_jobs
    assert port.sim.checkins_seen + port.sim.checkins_skipped > 0


@pytest.mark.parametrize("name", NAMES)
def test_port_engines_agree_registry_wide(name):
    _, port_spec = tiny_pair(name)
    py = P.run_one(port_spec, "venn", seed=0, engine="python", device="cpu")
    ar = P.run_one(port_spec, "venn", seed=0, engine="array", device="cpu")
    assert_same_metrics(py.metrics, ar.metrics, skip=("degraded_segments",))
    assert py.metrics.degraded_segments == 0
    assert ar.sim.engine.matcher_calls > 0


def test_random_baseline_parity_at_fast_size():
    """``fast_scaled`` alone (8 jobs, 2.5 days), a baseline scheduler."""
    ref = R.run_one(R.fast_scaled(R.get_scenario("churn_storm")), "random",
                    seed=1, engine="array")
    port = P.run_one(P.fast_scaled(P.get_scenario("churn_storm")), "random",
                     seed=1, engine="array", device="cpu")
    assert_same_metrics(ref.metrics, port.metrics)


def test_run_one_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    _, port_spec = tiny_pair("baseline_even")
    with pytest.raises(RuntimeError, match="CUDA"):
        P.run_one(port_spec, "venn", seed=0, engine="python")
    with pytest.raises(RuntimeError, match="CUDA"):
        port_cli(["run", "baseline_even", "--fast", "--sched", "venn"])


def test_run_scenario_multi_seed_and_tenant_table():
    _, port_spec = tiny_pair("priority_tenants")
    ref_spec, _ = tiny_pair("priority_tenants")
    port = P.run_scenario(port_spec, scheds=["venn", "random"], seeds=[0, 1],
                          engine="array", device="cpu")
    ref = R.run_scenario(ref_spec, scheds=["venn", "random"], seeds=[0, 1],
                         engine="array")
    assert [(r.scheduler, r.seed) for r in port] \
        == [(r.scheduler, r.seed) for r in ref]
    for a, b in zip(ref, port):
        assert_same_metrics(a.metrics, b.metrics)
    assert _strip_wall(P.comparison_table(port)) \
        == _strip_wall(R.comparison_table(ref))
    assert "gold_jct_s" in P.comparison_table(port)
    with pytest.raises(ValueError, match="record"):
        P.run_scenario(port_spec, seeds=[0, 1], record="x.csv", device="cpu")


def _strip_wall(table):
    """A comparison table without its wall-clock column (the only field two
    runs of the same simulation do not share)."""
    out = []
    for ln in table.splitlines():
        parts = ln.split()
        if len(parts) == 10 and parts[0] != "scheduler":
            parts = parts[:-1]
        elif parts[:1] == ["scheduler"] and "wall_s" in parts:
            parts.remove("wall_s")
        out.append(" ".join(parts))
    return "\n".join(out)


# -------------------------------------------------------- record and replay

@pytest.mark.parametrize("suffix", ["csv", "jsonl"])
def test_reference_recording_replays_in_the_port(tmp_path, suffix):
    ref_spec, port_spec = tiny_pair("churn_storm")
    path = str(tmp_path / f"ref.{suffix}")
    rec = R.run_one(ref_spec, "venn", seed=0, record=path, engine="array")
    for engine in ("python", "array"):
        rep = P.run_one(port_spec, "venn", seed=0, replay=path,
                        engine=engine, device="cpu")
        assert_same_metrics(rec.metrics, rep.metrics,
                             skip=("degraded_segments",))
    # a different scheduler over the same trace equals its own synthetic run
    other = P.run_one(port_spec, "random", seed=0, replay=path, device="cpu")
    direct = R.run_one(ref_spec, "random", seed=0)
    assert_same_metrics(direct.metrics, other.metrics)


@pytest.mark.parametrize("name", ["churn_storm", "flaky_ingest"])
@pytest.mark.parametrize("suffix", ["csv", "jsonl"])
def test_port_recording_is_byte_identical(tmp_path, suffix, name):
    ref_spec, port_spec = tiny_pair(name)
    ref_path = tmp_path / f"ref.{suffix}"
    port_path = tmp_path / f"port.{suffix}"
    R.run_one(ref_spec, "venn", seed=0, record=str(ref_path))
    P.run_one(port_spec, "venn", seed=0, record=str(port_path),
              engine="array", device="cpu")
    assert port_path.read_bytes() == ref_path.read_bytes()
    rep = P.run_one(port_spec, "venn", seed=0, replay=str(port_path),
                    device="cpu")
    ref_rep = R.run_one(ref_spec, "venn", seed=0, replay=str(ref_path))
    assert_same_metrics(ref_rep.metrics, rep.metrics)


def test_replay_stream_bounded_and_timestamps_only(tmp_path):
    n, cap = 5_000, 512
    times = np.sort(np.random.default_rng(0).uniform(0, 1e6, size=n))
    path = tmp_path / "ts.csv"
    path.write_text("timestamp\n"
                    + "".join(f"{t!r}\n" for t in times.tolist()))
    a = P.TraceReplayStream(str(path), chunk_rows=cap, seed=3)
    b = R.TraceReplayStream(str(path), chunk_rows=cap, seed=3)
    chunks = 0
    while True:
        ca, cb = a.next_chunk(), b.next_chunk()
        if ca is None:
            assert cb is None
            break
        assert ca.n <= cap
        chunks += 1
        for col in _COLS:
            np.testing.assert_array_equal(getattr(ca, col), getattr(cb, col))
    assert chunks == -(-n // cap) and a.rows_read == n


def test_replay_rejects_unsorted_traces(tmp_path):
    path = tmp_path / "bad.csv"
    path.write_text("time\n5.0\n3.0\n")
    with pytest.raises(ValueError, match="not sorted"):
        P.TraceReplayStream(str(path)).next_chunk()


# ------------------------------------------------------------------------ CLI

def test_cli_list_prints_the_reference_text(capsys):
    assert ref_cli(["list"]) == 0
    ref = capsys.readouterr().out
    assert port_cli(["list"]) == 0
    assert capsys.readouterr().out == ref
    assert len(ref.splitlines()) == 11


def test_cli_run_and_replay_on_the_host(tmp_path, capsys):
    trace = str(tmp_path / "t.csv")
    assert port_cli(["run", "baseline_even", "--fast", "--engine", "array",
                     "--device", "cpu", "--record", trace]) == 0
    out = capsys.readouterr().out
    assert "== baseline_even ==" in out
    assert "speedup venn vs random" in out
    assert f"(device stream recorded to {trace})" in out
    assert ref_cli(["run", "baseline_even", "--fast", "--engine", "array"]) \
        == 0
    ref = capsys.readouterr().out
    assert _strip_wall(out).replace(
        f"(device stream recorded to {trace})\n", "") == _strip_wall(ref)

    assert port_cli(["replay", "baseline_even", trace, "--fast",
                     "--device", "cpu", "--sched", "venn"]) == 0
    out = capsys.readouterr().out
    assert f"== baseline_even (replay: {trace}) ==" in out
    assert ref_cli(["replay", "baseline_even", trace, "--fast",
                    "--sched", "venn"]) == 0
    assert _strip_wall(out) == _strip_wall(capsys.readouterr().out)


def test_cli_errors_match_the_reference(capsys):
    assert port_cli(["run"]) == 2
    assert "give a scenario name or --all" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        port_cli(["run", "baseline_even", "--engine", "gpu"])
