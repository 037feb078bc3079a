"""The benchmark's files: found by name, within the contract's limits, free
of JAX, and the roofline counts pinned to the kernels' published bounds."""
import ast
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path.insert(0, str(BENCH))

from roofline import match_segment, segmented_order  # noqa: E402

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_every_cell_names_a_known_config_traffic_and_readers():
    configs = {c["name"]: c for c in SPEC["configs"]}
    for c in SPEC["configs"]:
        f = ROOT / c["file"]
        assert f.is_file() and f.parent == BENCH / "configs", c
        assert json.loads(f.read_text())["name"] == c["name"]
        for key in c["reduced"]:
            assert key in json.loads(f.read_text())
    used = set()
    for w in SPEC["workloads"]:
        spec = json.loads((BENCH / "workloads" / f"{w['name']}.json")
                          .read_text())
        assert spec["config"] == w["config"] in configs
        assert spec["traffic"] == w["traffic"]
        assert (BENCH / "traffic" / f"{spec['traffic']}.py").is_file()
        assert w["chips"] == 1
        used.add(w["config"])
    assert used == set(configs)
    names = {w["name"] for w in SPEC["workloads"]}
    reported = {}
    for m in SPEC["end_to_end"]:
        for w in m.get("workloads", names):
            reported.setdefault(w, set()).add(m["name"])
    for w in names:
        assert "setup_s" in reported[w] and len(reported[w]) >= 2
    for m in SPEC["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file(), m
        for w in m["workloads"]:
            assert m["moves"] in reported[w], (m["name"], w)


def test_names_and_bounds_keep_to_the_contract():
    groups = ("configs", "workloads", "end_to_end", "per_layer")
    for g in groups:
        names = [x["name"] for x in SPEC[g]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names), names
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"] + SPEC["end_to_end"]:
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
        assert m["better"] in ("lower", "higher")
    for p in BENCH.rglob("*"):
        rel = p.relative_to(BENCH).as_posix()
        if "__pycache__" in rel or rel.startswith("_out"):
            continue
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
    assert SPEC["paths"] == ["perfbench"]
    assert 1 <= SPEC["run_seconds"] <= 51


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_jax_or_jax_package_and_a_reference_of_its_own():
    for p in BENCH.rglob("*.py"):
        tops = set(_imports(p))
        assert not tops & {"jax", "jaxlib", "flax", "repro"}, p
        if "reference" in p.parts:
            assert "repro_torch" not in tops, p


def test_roofline_counts_give_the_published_bounds():
    # segmented_order: n = 2000 in one segment
    assert segmented_order.least_seconds_of(2000) * 1e3 == \
        pytest.approx(0.00070588, rel=1e-5)
    # match_segment at n = 2 on the dense mirror the bound was read on
    # (64 atoms, K = 32, a random 32 of 2048 requests each, seed 12345):
    # the same draws give its requests and the segment's atoms
    rng = np.random.default_rng(12345)
    [int(rng.integers(1, 24)) for _ in range(2048)]
    used = set()
    for _ in range(64):
        picks = rng.permutation(2048)[:32]
        for j, r in enumerate(picks):
            if j < 4 and rng.uniform() < 0.5:
                rng.uniform(0, 3, 2)
            used.add(int(r))
    ids = rng.integers(0, 64, size=16384)
    ms = match_segment.least_seconds_of(
        2, 32, len(used), len(np.unique(ids[:2])), False) * 1e3
    assert ms == pytest.approx(0.0000019164, rel=1e-4)


def test_without_a_card_it_exits_non_zero_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "even.drain",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
