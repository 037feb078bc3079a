"""What decides ``correct`` has to fail: the control (the reference itself
in float32, in the program's place) and a run of the harness with the timed
path broken underneath (the look for a card skipped, ``device="cpu"``, a
few simulated hours)."""
import json
import sys
import time
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent / "src")]

import check  # noqa: E402
import harness  # noqa: E402
from gen import checkins as gen_checkins  # noqa: E402
from gen import jobs as gen_jobs  # noqa: E402
from reference import sim as reference  # noqa: E402

SMALL = {"even.drain": {"config": {"horizon_s": 14400.0},
                        "params": {"warm_s": 1800.0}},
         "resheavy.drain": {"config": {"horizon_s": 14400.0},
                            "params": {"warm_s": 1800.0}}}
CELLS = list(SMALL)


def _run(workload, seconds=1.0, overrides=None):
    return harness.run_cell(workload, 2718281828, seconds, False,
                            time.perf_counter(), device="cpu",
                            overrides=overrides or SMALL[workload])


def _scheduler(**change):
    return dict(json.loads((BENCH / "configs" / "venn-paper-even-j50.json")
                           .read_text())["scheduler"], **change)


@pytest.mark.parametrize("seed,horizon", [(4000000001, 21600.0),
                                          (5, 43200.0)])
@pytest.mark.parametrize("config", ["venn-paper-even-j50",
                                    "venn-paper-resource-heavy-j50"])
def test_the_float32_control_is_not_correct(seed, horizon, config):
    cfg = json.loads((BENCH / "configs" / f"{config}.json").read_text())
    jobs = gen_jobs.generate(cfg["jobs"], cfg["jobs"]["trace_seed"], 4)
    stream = gen_checkins.generate(cfg["population"], seed, horizon)
    ref = reference.run(cfg, jobs, stream, seed, horizon, horizon)
    low = reference.run(cfg, jobs, stream, seed, horizon, horizon,
                        precision="float32")
    got = check.compare(check.as_program(low, stream.arrays["times"],
                                         horizon), ref,
                        stream.arrays["times"],
                        [r["name"] for r in cfg["requirements"]])
    assert got["grant_mismatch"] + got["round_mismatch"] > 0
    assert not check.verdict(got)


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    res = _run(cell)
    assert res["correct"] and res["failed"] == 0
    assert list(res)[-2:] == ["checks", "_log"]


@pytest.mark.parametrize("cell", CELLS)
def test_a_step_that_leaves_its_state_unchanged_fails(monkeypatch, cell):
    from repro_torch.sim.simulator import Simulator
    monkeypatch.setattr(Simulator, "step_until", lambda self, until=None:
                        False)
    assert not _run(cell)["correct"]


@pytest.mark.parametrize("cell", CELLS)
def test_half_of_each_segment_left_out_fails(monkeypatch, cell):
    from repro_torch.accel.engine import ArrayMatchEngine
    match = ArrayMatchEngine.match

    def half(self, atom_ids, speeds, start=None):
        res = match(self, atom_ids, speeds, start)
        n = len(atom_ids)
        res.choice[n // 2:] = -1
        res.granted[n // 2:] = False
        return res

    monkeypatch.setattr(ArrayMatchEngine, "match", half)
    assert not _run(cell)["correct"]


@pytest.mark.parametrize("cell", CELLS)
def test_an_answer_altered_where_it_is_produced_fails(monkeypatch, cell):
    from repro_torch.sim.simulator import Simulator
    grant = Simulator._grant

    def altered(self, req, i, dev_t, speed):
        filled = grant(self, req, i, dev_t, speed)
        if len(self.grant_log) == 7:
            t, job, rnd = self.grant_log[-1]
            self.grant_log[-1] = (t, job + 1, rnd)
        return filled

    monkeypatch.setattr(Simulator, "_grant", altered)
    assert not _run(cell)["correct"]


@pytest.mark.parametrize("cell", CELLS)
def test_an_atom_altered_where_it_is_produced_fails(monkeypatch, cell):
    from repro_torch.core.eligibility import EligibilityIndex
    classify = EligibilityIndex.classify

    def altered(self, caps):
        ids = classify(self, caps)
        if len(ids) > 10 and len(self.requirements):
            ids = ids.copy()
            ids[10] = self.intern(frozenset({"no such requirement"}))
        return ids

    monkeypatch.setattr(EligibilityIndex, "classify", altered)
    assert not _run(cell)["correct"]


def test_a_reference_that_ignores_the_fairness_knob_fails(monkeypatch):
    """The program at ε = 2 against a reference held at ε = 0.  On this
    seed the two first decide a grant apart between the second and the
    fourth simulated hour, so the window (4 s on the CPU) has to cover the
    whole 4-hour episode."""
    over = {"config": dict(SMALL["even.drain"]["config"],
                           scheduler=_scheduler(epsilon=2.0)),
            "params": SMALL["even.drain"]["params"]}
    assert _run("even.drain", 4.0, over)["correct"]
    build = reference.build

    def plain(cfg, *args, **kw):
        return build(dict(cfg, scheduler=dict(cfg["scheduler"],
                                              epsilon=0.0)), *args, **kw)

    monkeypatch.setattr(reference, "build", plain)
    res = _run("even.drain", 4.0, over)
    assert not res["correct"] and res["checks"]["grant_mismatch"]["value"]


@pytest.mark.parametrize("scheduler", [
    _scheduler(priority=2.0), _scheduler(enable_irs=False),
    {k: v for k, v in _scheduler().items() if k != "epsilon"},
    _scheduler(name="random")],
    ids=["unknown_key", "ablation_key", "epsilon_left_out", "other_name"])
def test_a_scheduler_setting_one_side_ignores_is_refused(monkeypatch,
                                                        scheduler):
    loaded = []
    monkeypatch.setattr(harness, "load_module",
                        lambda kind, name: loaded.append(kind))
    with pytest.raises(ValueError, match="scheduler"):
        harness.run_cell("even.drain", 2718281828, 1.0, False,
                         time.perf_counter(), device="cpu",
                         overrides={"config": {"scheduler": scheduler}})
    assert loaded == []


def test_a_traced_window_without_device_activity_is_traced_again(
        monkeypatch):
    import tracing
    monkeypatch.setattr(tracing, "TRACE_WINDOW_S", 0.3)
    stop, starts = tracing.Capture.stop, []
    start = tracing.Capture.start

    def counted_start(self):
        starts.append(1)
        start(self)

    def first_fails(self):
        stop(self)
        self.ok = len(starts) > 1

    monkeypatch.setattr(tracing.Capture, "start", counted_start)
    monkeypatch.setattr(tracing.Capture, "stop", first_fails)
    res = harness.run_cell("even.drain", 2718281828, 2.0, True,
                           time.perf_counter(), device="cpu",
                           overrides=SMALL["even.drain"])
    assert len(starts) == 2 and res["correct"]
    assert "stream_ns_per_checkin" in res["metrics"]
    monkeypatch.setattr(tracing.Capture, "stop", lambda self: (
        stop(self), setattr(self, "ok", False)))
    with pytest.raises(RuntimeError, match="no device activity"):
        harness.run_cell("even.drain", 2718281828, 1.0, True,
                         time.perf_counter(), device="cpu",
                         overrides=SMALL["even.drain"])


def test_launch_shapes_are_worked_out_after_the_window():
    """The traced run keeps each matcher call's arguments as they are (the
    engine's stopwatch times the call) and works out the launch's shapes
    only when read: rows, slots, requests, distinct atoms, live rows."""
    import numpy as np
    import tracing
    cap = tracing.Capture("unused", dict, None)
    cap.calls = {"match_segment": [(np.array([3, 1, 3]), 5, 32, True),
                                   (np.array([], dtype=np.int64), 5, 32,
                                    False),
                                   (np.array([2]), 0, 32, False)],
                 "segmented_order": [2000, 0]}
    assert cap._shapes() == {"match_segment": [(3, 32, 5, 2, True)],
                             "segmented_order": [2000]}
