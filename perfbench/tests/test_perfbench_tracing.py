"""The drain's parts (``perfbench/tools/drain_parts.py``): idle gaps split by
the innermost span on synthetic nested spans, and a traced run of the cell
at a test size (``device="cpu"``, a few simulated hours) whose five
quantities are finite and whose counts add up to the check-ins decided."""
import math
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH / "tools"), str(BENCH), str(BENCH.parent / "src")]

import drain_parts  # noqa: E402
from drain_parts import OUTSIDE, innermost, name_gaps  # noqa: E402

# a slice holding a drain, which holds a replan and a match; an event after
# the drain, inside the slice; a span of the harness after the slice
SPANS = [(0.0, 10.0, "sim.step_until"), (1.0, 6.0, "sim.drain"),
         (2.0, 3.0, "venn.replan"), (4.0, 5.0, "accel.match"),
         (7.0, 8.0, "sim.event.response"), (11.0, 12.0, "harness.x")]


def test_the_innermost_span_wins_at_each_instant():
    assert innermost(SPANS) == [
        (0.0, 1.0, "sim.step_until"), (1.0, 2.0, "sim.drain"),
        (2.0, 3.0, "venn.replan"), (3.0, 4.0, "sim.drain"),
        (4.0, 5.0, "accel.match"), (5.0, 6.0, "sim.drain"),
        (6.0, 7.0, "sim.step_until"), (7.0, 8.0, "sim.event.response"),
        (8.0, 10.0, "sim.step_until"), (11.0, 12.0, "harness.x")]


def test_a_gap_is_split_by_overlap_and_the_names_sum_to_the_idle_total():
    # one gap across the drain's replan and match, one across the event and
    # the slice's end into the harness, one in no span; a device clock
    # twice the spans' (each piece scaled to the gap's own length)
    gaps = [(1.5, 4.5, 6.0), (7.5, 11.5, 8.0), (12.5, 13.0, 1.0)]
    got = name_gaps(gaps, SPANS)
    assert got == pytest.approx({
        "sim.drain": 3.0, "venn.replan": 2.0, "accel.match": 1.0,
        "sim.event.response": 1.0, "sim.step_until": 4.0,
        OUTSIDE: 2.0 + 1.0, "harness.x": 1.0})
    assert sum(got.values()) == pytest.approx(sum(g[2] for g in gaps))


def test_spans_that_do_not_nest_go_to_the_one_begun_last():
    spans = [(0.0, 4.0, "a"), (2.0, 6.0, "b"), (3.0, 5.0, "c")]
    assert innermost(spans) == [(0.0, 2.0, "a"), (2.0, 3.0, "b"),
                                (3.0, 5.0, "c"), (5.0, 6.0, "b")]


@pytest.mark.parametrize("with_sim", [True, False])
def test_a_traced_run_reports_the_five_parts(with_sim):
    small = {"config": {"horizon_s": 14400.0}, "params": {"warm_s": 1800.0}}
    res = drain_parts.run("even.drain", 3141592653, 2.0, with_sim=with_sim,
                          device="cpu", overrides=small)
    assert res["correct"]
    p = res["parts"]
    c = p["counts"]
    assert p["idle_named_s"] == pytest.approx(p["idle_s"], rel=1e-9)
    assert p["decided_per_s"] > 0 and c["decided"] > 0
    named = set(p["idle_gaps"])
    if not with_sim:
        # the harness's capture: no sim spans, so the program keeps no
        # parts, and chunk loads are the capture's own spans
        assert all(p[name] is None for name in drain_parts.READERS)
        assert c["grants"] == c["drain_segments"] == 0
        assert "stream.chunk_load" in named and "sim.drain" not in named
        return
    for name in drain_parts.READERS:
        assert p[name] is not None and math.isfinite(p[name]), name
    assert c["vector_rows"] + c["scalar_rows"] + c["head_misses"] \
        + c["idle_rows"] == c["decided"]
    assert 0 < p["vector_row_share"] < 100
    assert c["grants"] > 0 and sum(
        v for k, v in c.items() if k.startswith("events.")) > 0
    assert p["self_sum_s"] == pytest.approx(p["step_until_s"], rel=0.05)
    assert "sim.drain" in named and "stream.chunk_load" not in named


def _traced_share(name, seed, t0, t1, tmp_path, monkeypatch):
    """A capture over simulated seconds ``t0``-``t1`` of one episode of
    ``name``, on the CPU: its readings and the rows a spy on
    ``engine.match`` saw handed to the matcher in that span."""
    import json
    import torch
    import program
    import tracing
    from gen import checkins as gen_checkins
    from gen import jobs as gen_jobs
    from repro_torch.accel.engine import ArrayMatchEngine
    cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    jobs = gen_jobs.generate(cfg["jobs"], cfg["jobs"]["trace_seed"], 4)
    stream = gen_checkins.generate(cfg["population"], seed, t1)
    ep = program.Episode(program.port(), cfg, jobs, stream, seed, t1, "cpu")
    t = 0.0
    while t < t0:
        t += 60.0
        ep.step_until(t)
    seen = []
    match = ArrayMatchEngine.match

    def spy(self, atom_ids, speeds, start=None):
        res = match(self, atom_ids, speeds, start)
        seen.append(len(atom_ids))
        return res

    monkeypatch.setattr(ArrayMatchEngine, "match", spy)
    cap = tracing.Capture(str(tmp_path / "trace.json"),
                          lambda: program.counters([ep]),
                          torch.device("cpu"))
    decided0 = ep.decided
    cap.start()
    while t < t1:
        t += 60.0
        ep.step_until(t)
    cap.stop()
    monkeypatch.setattr(ArrayMatchEngine, "match", match)
    r = cap.readings()
    assert r["decided"] == ep.decided - decided0 > 0
    return r, sum(seen)


def test_matcher_row_share_reads_the_rows_handed_to_the_matcher(
        tmp_path, monkeypatch):
    """The reading is the rows ``engine.match`` was handed over the check-ins
    decided, and over the second half of an episode's second day the
    resource-heavy mix routes several times the even mix's share to the
    matcher."""
    import harness
    read = harness.load_module("metrics", "matcher_row_share").read
    shares = {}
    for name in ("venn-paper-even-j50", "venn-paper-resource-heavy-j50"):
        r, rows = _traced_share(name, 2500000104, 129600.0, 172800.0,
                                tmp_path, monkeypatch)
        assert r["matcher_route_rows"] == rows
        shares[name] = read(r)
        assert shares[name] == pytest.approx(rows / r["decided"] * 100,
                                             rel=1e-12)
    assert shares["venn-paper-resource-heavy-j50"] > \
        5 * shares["venn-paper-even-j50"] > 0
