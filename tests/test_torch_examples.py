"""The port's examples (``repro_torch.examples``) against the repo's
``examples/``: ``quickstart`` and ``scenario_tour`` print the reference's
JCT and table lines (wall times, temporary paths and the CLI's package name
masked), ``elastic_restart`` returns 0 on the CPU, and every new entry point
— the five examples, the suite's runner and each benchmark module — raises
the device error on a host without a card unless it is given ``--device
cpu``.  The port runs the array drain with ``device="cpu"``, the reference
its per-device loop.
"""
import importlib
import importlib.util
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread a worker)

ROOT = Path(__file__).resolve().parent.parent

BENCHMARKS = ("bench_kernels", "bench_scenarios", "fig10_overhead",
              "fig11_breakdown", "fig12_numjobs", "fig13_tiers",
              "fig14_fairness", "table1_workloads",
              "table2_demand_percentiles", "table3_resource_types",
              "table4_biased")
EXAMPLES = ("quickstart", "scenario_tour", "serve_batched",
            "fl_multijob_training", "elastic_restart")


def reference_example(name):
    """The repo's ``examples/<name>.py`` as a module (its ``main`` not run)."""
    spec = importlib.util.spec_from_file_location(
        f"reference_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def port_example(name):
    return importlib.import_module(f"repro_torch.examples.{name}")


def test_quickstart_prints_the_reference_lines(capsys):
    capsys.readouterr()
    reference_example("quickstart").main()
    want = capsys.readouterr().out.splitlines()
    port_example("quickstart").main(["--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    # all but the last line, which names each package's benchmarks
    assert got[:-1] == want[:-1]
    assert sum("avg JCT" in ln for ln in got) == 4
    assert got[-3].split()[0] == "venn" and got[-1].startswith("OK")


def _tour_masked(text):
    text = text.replace("python -m repro_torch.obs", "python -m repro.obs")
    text = re.sub(r"(recorded \d+ bytes to )\S+", r"\1<path>", text)
    text = re.sub(r" +\d+\.\dms", " <ms>", text)   # right-aligned columns
    # the comparison tables' last column is the run's wall time
    return re.sub(r"^((venn|random) +(\S+ +){7}\S+) +\S+$", r"\1 <wall>",
                  text, flags=re.M)


def test_scenario_tour_prints_the_reference_lines(capsys):
    capsys.readouterr()
    reference_example("scenario_tour").main()
    want = _tour_masked(capsys.readouterr().out)
    port_example("scenario_tour").main(["--device", "cpu"])
    got = _tour_masked(capsys.readouterr().out)
    assert got == want
    assert "replay bit-identical: True" in got
    assert "metrics bit-identical across backends: True" in got
    assert got.count("<wall>") == 4 and got.count("<ms>") == 10


def test_elastic_restart_returns_0_on_the_cpu(capsys):
    assert port_example("elastic_restart").main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert '"arch": "llama3.2-1b-smoke"' in out and '"steps": 8' in out


def _needs_no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry would run in full")


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_raises_without_a_card(name):
    _needs_no_card()
    with pytest.raises(RuntimeError, match="CUDA"):
        port_example(name).main([])


@pytest.mark.parametrize("name", BENCHMARKS)
def test_benchmark_raises_without_a_card(name):
    from repro_torch.benchmarks.common import cli
    _needs_no_card()
    mod = importlib.import_module(f"repro_torch.benchmarks.{name}")
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.main()
    with pytest.raises(RuntimeError, match="CUDA"):
        cli(mod.main, [])


def test_benchmark_cli_takes_the_cpu_when_asked(capsys):
    from repro_torch.benchmarks import fig10_overhead
    from repro_torch.benchmarks.common import cli
    out = cli(fig10_overhead.main, ["--device", "cpu"])
    assert len(out) == 6
    assert "fig10_validates,0.0," in capsys.readouterr().out


@pytest.mark.parametrize("module", ["repro_torch.benchmarks.run",
                                    "repro_torch.examples.quickstart"])
def test_python_m_entry_raises_without_a_card(module):
    _needs_no_card()
    res = subprocess.run([sys.executable, "-m", module], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert "RuntimeError" in res.stderr and "CUDA" in res.stderr
    assert "pass device=\"cpu\"" in res.stderr
