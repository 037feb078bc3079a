"""The port's observability tools against the reference's.

* ``run_scenario(..., fast=True, audit_out=...)`` on both drain engines of
  the port (``device="cpu"``) writes the reference's audit JSONL byte for
  byte, its ``kind="timeline"`` metrics records equal the reference's, and
  its trace passes ``validate_trace`` with the span taxonomy the reference's
  tests require;
* the JCT timelines (build, records, round trip, rendering) equal the
  reference's;
* ``python -m repro_torch.obs``: each of the six verbs, run on files the
  reference wrote, prints the reference's text (and the port's files render
  as the reference's do).
"""
import json

import pytest

from repro import obs as ref_obs
from repro.obs.__main__ import main as ref_obs_main
import repro.scenarios as R
from repro_torch import obs as port_obs
from repro_torch.obs.__main__ import main as port_obs_main
import repro_torch.scenarios as P
from torch_parity import tiny, tiny_pair


@pytest.fixture(autouse=True)
def _obs_disabled():
    """Every test starts and ends with both packages' null singletons."""
    ref_obs.disable()
    port_obs.disable()
    yield
    ref_obs.disable()
    port_obs.disable()


def _timeline_records(path):
    return [r for r in port_obs.read_jsonl(str(path))
            if r["kind"] == "timeline"]


# ------------------------------------------------------- audit bytes

@pytest.mark.parametrize("engine", ["python", "array"])
@pytest.mark.parametrize("scenario",
                         ["baseline_even", "blackout_storm", "flaky_ingest"])
def test_audit_metrics_and_trace_equal_the_reference(scenario, engine,
                                                     tmp_path):
    ref_spec, port_spec = tiny_pair(scenario)
    out = {}
    for tag, mod, spec, kw in (("ref", R, ref_spec, {}),
                               ("port", P, port_spec, {"device": "cpu"})):
        paths = {k: tmp_path / f"{tag}.{k}" for k in
                 ("audit.jsonl", "metrics.jsonl", "trace.json")}
        res = mod.run_scenario(spec, scheds=["venn"], seeds=[0], fast=True,
                               engine=engine,
                               audit_out=str(paths["audit.jsonl"]),
                               metrics_out=str(paths["metrics.jsonl"]),
                               trace_out=str(paths["trace.json"]), **kw)
        out[tag] = (res, paths)
    (ref_res, ref_p), (port_res, port_p) = out["ref"], out["port"]
    audit = port_p["audit.jsonl"].read_bytes()
    assert audit == ref_p["audit.jsonl"].read_bytes()
    assert len(port_obs.read_audit(str(port_p["audit.jsonl"]))) > 1
    assert _timeline_records(port_p["metrics.jsonl"]) \
        == _timeline_records(ref_p["metrics.jsonl"])
    doc = port_obs.load_trace(str(port_p["trace.json"]))
    port_obs.validate_trace(doc)
    names = {e["name"] for e in doc["traceEvents"]}
    assert f"run:{port_spec.name}:venn:s0" in names
    assert "venn.replan" in names and "sim.drain" in names
    if engine == "array":
        assert "accel.match" in names
    if scenario != "baseline_even":
        assert any(n.startswith("fault.") for n in names)
    assert ref_res[0].metrics.summary() == port_res[0].metrics.summary()


def test_audit_is_engine_invariant_with_grant_sampling(tmp_path):
    _, spec = tiny_pair("baseline_even")
    blobs = []
    for engine in ("python", "array"):
        p = tmp_path / f"{engine}.jsonl"
        P.run_scenario(spec, scheds=["venn"], seeds=[1], engine=engine,
                       audit_out=str(p), grant_sample=3, device="cpu")
        blobs.append(p.read_bytes())
    assert blobs[0] == blobs[1]
    ref_p = tmp_path / "ref.jsonl"
    R.run_scenario(tiny_pair("baseline_even")[0], scheds=["venn"], seeds=[1],
                   engine="array", audit_out=str(ref_p), grant_sample=3)
    assert blobs[0] == ref_p.read_bytes()


def _recorded(audit, core, sim, kw, dev):
    """Two VENN runs under one ``AuditRecorder(**kw)``: the first opened by
    ``begin_run`` and exported mid-session, the second with no run mark."""
    rec = audit.AuditRecorder(**kw)
    audit.AUDIT = rec
    try:
        out = []
        for seed, n, rate, days, mark in ((3, 12, 3.0, 4, True),
                                          (4, 8, 2.0, 2, False)):
            s = sim.simulator.Simulator(
                sim.generate_jobs(sim.JobTraceConfig(num_jobs=n, seed=seed)),
                core.SCHEDULERS["venn"](seed=seed, **dev),
                sim.PopulationConfig(seed=1000 + seed, base_rate=rate),
                sim.SimConfig(max_time=days * 24 * 3600.0), **dev)
            if mark:
                rec.begin_run(scenario="tiny", seed=seed)
            s.run()
            out.append(rec.records)
        return out, rec.summary()
    finally:
        audit.AUDIT = audit.NULL_AUDIT


@pytest.mark.parametrize("kw", [
    {}, {"replan_sample": 3}, {"queue_positions": False},
    {"max_records": 60}, {"grant_sample": 2, "replan_sample": 2}],
    ids=["default", "replan_sample", "no_queue_positions", "max_records",
         "both_samples"])
def test_recorder_options_equal_the_reference(kw):
    """The port's recorder stashes each replan as one flat tuple (not the
    reference's refs to the plan): every option still gives the
    reference's records, a mid-session export and a second unmarked run
    included."""
    import repro.core
    import repro.obs.audit
    import repro.sim.simulator
    import repro_torch.core
    import repro_torch.obs.audit
    import repro_torch.sim.simulator

    ref = _recorded(repro.obs.audit, repro.core, repro.sim, kw, {})
    port = _recorded(repro_torch.obs.audit, repro_torch.core, repro_torch.sim,
                     kw, {"device": "cpu"})
    assert port == ref
    assert {r["kind"] for r in ref[0][0]} >= {"run", "replan", "grant"}


def test_observability_never_perturbs_the_port():
    _, spec = tiny_pair("blackout_storm")
    for engine in ("python", "array"):
        plain = P.run_one(spec, "venn", seed=0, engine=engine, device="cpu")
        with port_obs.session(tracing=True, metrics=True, audit=True):
            traced = P.run_one(spec, "venn", seed=0, engine=engine,
                               device="cpu")
        assert plain.metrics.summary() == traced.metrics.summary()
        assert plain.metrics.jcts == traced.metrics.jcts
    assert not port_obs.get_tracer().enabled


# ----------------------------------------------------------- timelines

def test_timelines_equal_the_reference():
    ref_spec, port_spec = tiny_pair("churn_storm")
    rm = R.run_one(ref_spec, "venn", seed=0).metrics
    pm = P.run_one(port_spec, "venn", seed=0, device="cpu").metrics
    rt, pt = ref_obs.build_timelines(rm), port_obs.build_timelines(pm)
    assert set(pt) == set(pm.jcts)
    for jid in rt:
        a, b = rt[jid], pt[jid]
        assert (b.jct, b.scheduling_delay_s, b.response_collection_s,
                b.other_s) == (a.jct, a.scheduling_delay_s,
                               a.response_collection_s, a.other_s)
    recs = port_obs.timeline_records(pm, scenario="churn_storm")
    assert recs == ref_obs.timeline_records(rm, scenario="churn_storm")
    from repro_torch.obs.timeline import timelines_from_records
    back = timelines_from_records(recs)
    assert port_obs.render_timelines(back) == ref_obs.render_timelines(rt)
    assert port_obs.render_timelines(pt, width=20) \
        == ref_obs.render_timelines(rt, width=20)
    assert port_obs.render_timelines([]) == "(no jobs)"


# --------------------------------------------------------------- the CLI

@pytest.fixture(scope="module")
def ref_files(tmp_path_factory):
    """Trace, metrics (two seeds) and audit files the reference wrote."""
    d = tmp_path_factory.mktemp("refobs")
    ref_obs.disable()
    spec = tiny(R, R.get_scenario("blackout_storm"))
    files = {"trace": d / "t.json", "metrics": d / "m.jsonl",
             "metrics2": d / "m2.jsonl", "audit": d / "a.jsonl"}
    R.run_scenario(spec, scheds=["venn"], seeds=[0], engine="array",
                   trace_out=str(files["trace"]),
                   metrics_out=str(files["metrics"]),
                   audit_out=str(files["audit"]))
    R.run_scenario(spec, scheds=["venn"], seeds=[1], engine="python",
                   metrics_out=str(files["metrics2"]))
    ref_obs.disable()
    return {k: str(v) for k, v in files.items()}


def _job_of(path):
    return next(r["job"] for r in ref_obs.read_audit(path)
                if r["kind"] == "queue_pos")


VERBS = {
    "summarize": lambda f: ["summarize", f["trace"], f["metrics"]],
    "summarize_top": lambda f: ["summarize", f["trace"], "--top", "5"],
    "validate": lambda f: ["validate", f["trace"]],
    "timeline": lambda f: ["timeline", f["metrics"]],
    "contention": lambda f: ["contention", f["audit"]],
    "contention_replan": lambda f: ["contention", f["audit"], "--replan",
                                    "3", "--atoms", "4"],
    "audit": lambda f: ["audit", f["audit"]],
    "audit_job": lambda f: ["audit", f["audit"], "--job",
                            str(_job_of(f["audit"]))],
    "merge": lambda f: ["merge", f["metrics"], f["metrics2"]],
}


@pytest.mark.parametrize("verb", sorted(VERBS))
def test_obs_cli_prints_the_reference_text(verb, ref_files, capsys):
    argv = VERBS[verb](ref_files)
    rc_ref = ref_obs_main(argv)
    ref = capsys.readouterr()
    rc = port_obs_main(argv)
    got = capsys.readouterr()
    assert rc == rc_ref == 0
    assert got.out == ref.out and got.err == ref.err
    assert got.out.strip()


def test_obs_cli_merge_writes_the_reference_records(ref_files, tmp_path,
                                                    capsys):
    outs = {}
    for tag, main in (("ref", ref_obs_main), ("port", port_obs_main)):
        path = tmp_path / f"{tag}.jsonl"
        assert main(["merge", ref_files["metrics"], ref_files["metrics2"],
                     "--out", str(path)]) == 0
        outs[tag] = (path.read_bytes(),
                     capsys.readouterr().out.replace(str(path), "OUT"))
    assert outs["port"] == outs["ref"]


def test_obs_cli_errors_match_the_reference(tmp_path, capsys):
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"traceEvents": [{"ph": "X"}]}))
    empty = tmp_path / "empty.jsonl"
    empty.write_text("")
    a, b = tmp_path / "a.jsonl", tmp_path / "b.jsonl"
    ha = port_obs.Histogram("lat", lo=1e-6, hi=10.0)
    hb = port_obs.Histogram("lat", lo=1e-5, hi=10.0)
    ha.record(0.1)
    hb.record(0.2)
    a.write_text(json.dumps(ha.snapshot()) + "\n")
    b.write_text(json.dumps(hb.snapshot()) + "\n")
    for argv in (["validate", str(bad)], ["timeline", str(empty)],
                 ["merge", str(a), str(b)]):
        rc_ref = ref_obs_main(argv)
        ref = capsys.readouterr()
        rc = port_obs_main(argv)
        got = capsys.readouterr()
        assert rc == rc_ref == 1
        assert (got.out, got.err) == (ref.out, ref.err)


def test_obs_cli_on_the_ports_files(tmp_path, capsys):
    """What the port writes renders as the reference renders it."""
    _, spec = tiny_pair("flaky_ingest")
    t, m, a = (str(tmp_path / n) for n in ("t.json", "m.jsonl", "a.jsonl"))
    P.run_scenario(spec, scheds=["venn"], engine="array", trace_out=t,
                   metrics_out=m, audit_out=a, device="cpu")
    for argv in (["validate", t], ["timeline", m], ["contention", a],
                 ["audit", a]):
        assert ref_obs_main(argv) == 0
        ref = capsys.readouterr().out
        assert port_obs_main(argv) == 0
        assert capsys.readouterr().out == ref
