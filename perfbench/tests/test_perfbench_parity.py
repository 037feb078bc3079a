"""The benchmark's frozen generators against the program's, and its plain
reference against the program's array drain (``device="cpu"``), on a few
simulated hours of the configuration."""
import copy
import hashlib
import json
import sys
from pathlib import Path

import numpy as np
import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent / "src")]

import check  # noqa: E402
import program  # noqa: E402
from gen import checkins as gen_checkins  # noqa: E402
from gen import jobs as gen_jobs  # noqa: E402
from reference import sim as reference  # noqa: E402

CONFIG = "venn-paper-even-j50"
CONFIGS = [CONFIG, "venn-paper-resource-heavy-j50"]
# the program's Sec. 5.4 biases by name, and the class index each pins
BIASED = {"general": 0, "compute_heavy": 1, "memory_heavy": 2,
          "resource_heavy": 3}


def _cfg(name):
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("seed", [1, 20231208])
@pytest.mark.parametrize("name,bias", [(c, None) for c in CONFIGS]
                         + [(CONFIG, b) for b in BIASED])
def test_job_generator_draws_the_programs_trace(seed, name, bias):
    """Each configuration's own trace, and the even one under each of the
    program's biases (a ``bias`` key naming the class index), against the
    program's generator."""
    from repro_torch.sim.devices import REQUIREMENT_CLASSES
    from repro_torch.sim.traces import BIASED as PROGRAMS_BIASED
    from repro_torch.sim.traces import JobTraceConfig, generate_jobs
    assert PROGRAMS_BIASED == BIASED
    p = dict(_cfg(name)["jobs"])
    if bias is not None:
        p["bias"] = BIASED[bias]
    elif p.get("bias") is not None:
        bias = {v: k for k, v in BIASED.items()}[p["bias"]]
    mine = gen_jobs.generate(p, seed, len(REQUIREMENT_CLASSES))
    theirs = generate_jobs(JobTraceConfig(
        num_jobs=p["num_jobs"], mean_interarrival=p["mean_interarrival"],
        workload=p["workload"], bias=bias, seed=seed))
    if p["pin"] is not None:
        for j in theirs:
            j.requirement = REQUIREMENT_CLASSES[p["pin"]]
    assert mine["demand"].tolist() == [j.demand_per_round for j in theirs]
    assert mine["rounds"].tolist() == [j.total_rounds for j in theirs]
    assert mine["arrival"].tolist() == [j.arrival_time for j in theirs]
    assert mine["task_mean"].tolist() == [j.task_time_mean for j in theirs]
    assert mine["deadline"].tolist() == [j.deadline for j in theirs]
    names = [r["name"] for r in _cfg(name)["requirements"]]
    assert [names[i] for i in mine["requirement"].tolist()] == \
        [j.requirement.name for j in theirs]


@pytest.mark.parametrize("seed,horizon", [(4000000321, 40000.0),
                                          (17, 90000.0)])
def test_checkin_sampler_draws_the_programs_chunks(seed, horizon):
    name = CONFIG
    from repro_torch.sim.devices import (DeviceGenerator, GeneratorStream,
                                         PopulationConfig)
    p = _cfg(name)["population"]
    mine = gen_checkins.generate(p, seed, horizon)
    keys = ("base_rate", "diurnal_amplitude", "diurnal_phase", "cpu_med",
            "cpu_sigma", "mem_med", "mem_sigma", "cap_corr",
            "speed_exponent", "speed_noise_sigma", "fail_base",
            "fail_slow_boost")
    gen = DeviceGenerator(PopulationConfig(seed=seed,
                                           **{k: p[k] for k in keys}))
    theirs = GeneratorStream(gen, horizon)
    for i in range(mine.num_chunks()):
        ck = theirs.next_chunk()
        for f, a in mine.chunk(i).items():
            assert np.array_equal(a, getattr(ck, f)), (i, f)
    assert theirs.next_chunk() is None


@pytest.mark.parametrize("seed,horizon", [(3000000007, 10800.0),
                                          (2718281829, 21600.0)])
@pytest.mark.parametrize("name,epsilon",
                         [pytest.param(c, None, id=c) for c in CONFIGS]
                         + [pytest.param(CONFIG, 2.0, id=f"{CONFIG}-eps2")])
def test_reference_agrees_with_the_array_drain(seed, horizon, name, epsilon):
    """Each configuration as it is, and the even one with the fairness knob
    at ε = 2 (Sec. 4.4).  Within the first hour a job's attained service
    passes 0.7 of its fair share and a group's queue its clamp, so the ε
    case also has to decide some grant otherwise than ε = 0 does."""
    cfg = _cfg(name)
    if epsilon is not None:
        cfg["scheduler"]["epsilon"] = epsilon
    jobs = gen_jobs.generate(cfg["jobs"], cfg["jobs"]["trace_seed"], 4)
    stream = gen_checkins.generate(cfg["population"], seed, horizon)
    ep = program.Episode(program.port(), cfg, jobs, stream, seed, horizon,
                         "cpu")
    t, done = 0.0, False
    while not done:
        t = min(t + 60.0, horizon)
        done = ep.step_until(t) or t >= horizon
    ans = ep.answers()
    ref = reference.run(cfg, jobs, stream, seed, horizon, horizon)
    got = check.compare(ans, ref, stream.arrays["times"],
                        [r["name"] for r in cfg["requirements"]])
    assert got["grants_compared"] > 0 and got["rounds_compared"] > 0
    assert {k: got[k] for k in check.LIMITS} == \
        {"atom_mismatch": 0, "grant_mismatch": 0, "round_mismatch": 0}
    assert check.verdict(got)
    if epsilon is not None:
        plain = copy.deepcopy(cfg)
        plain["scheduler"]["epsilon"] = 0.0
        ref0 = reference.run(plain, jobs, stream, seed, horizon, horizon)
        apart = check.compare(
            check.as_program(ref, stream.arrays["times"], horizon), ref0,
            stream.arrays["times"], [r["name"] for r in cfg["requirements"]])
        assert apart["grant_mismatch"] > 0


def _digest(ans) -> str:
    """The reference's answers as one hash: grants and rounds (floats by
    their exact hex), each chunk's atom ids, the atoms' keys."""
    def canon(x):
        if isinstance(x, (tuple, list)):
            return [canon(v) for v in x]
        if isinstance(x, (int, np.integer)):
            return int(x)
        return float(x).hex()
    h = hashlib.sha256()
    h.update(json.dumps(canon(ans["grants"])).encode())
    h.update(json.dumps(canon(ans["rounds"])).encode())
    for off, ids in ans["loaded"]:
        h.update(str(int(off)).encode())
        h.update(np.asarray(ids, dtype=np.int64).tobytes())
    h.update(json.dumps([sorted(k) for k in ans["atom_keys"]]).encode())
    return h.hexdigest()


# the answers of the reference before it took the fairness knob, on 12
# simulated hours: at ε = 0 they may not change by a bit, in float64 or in
# the float32 control
PINNED = {
    ("venn-paper-even-j50", 1000000007, "float64"):
        "bd6edd5ff482bba2f4289a9ba55376b80309d9b3b3bf34ef9326249ef3e61378",
    ("venn-paper-even-j50", 1000000007, "float32"):
        "9c4f3e58d5d17ffd2308994fed1e138ab37e64855dd5d25f83d414dd370e45e0",
    ("venn-paper-resource-heavy-j50", 1000000009, "float64"):
        "e8cf9007f70fd5ea9daf185c1f5684d97b56723b8c1803de9041c1f251f2c709",
    ("venn-paper-resource-heavy-j50", 1000000009, "float32"):
        "814b32217d3f47ef696536264ec1667bd73ac47b2c6d3d2383669033635b2974",
}


@pytest.mark.parametrize("name,seed,precision", list(PINNED))
def test_the_reference_at_epsilon_0_keeps_its_answers(name, seed,
                                                      precision):
    cfg = _cfg(name)
    assert cfg["scheduler"]["epsilon"] == 0.0
    horizon = 43200.0
    jobs = gen_jobs.generate(cfg["jobs"], cfg["jobs"]["trace_seed"], 4)
    stream = gen_checkins.generate(cfg["population"], seed, horizon)
    ans = reference.run(cfg, jobs, stream, seed, horizon, horizon,
                        precision=precision)
    assert _digest(ans) == PINNED[name, seed, precision]
