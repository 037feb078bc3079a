"""The port's reproduction of the paper's Tables 1-4
(``repro_torch.benchmarks``) against the reference's ``benchmarks/``.

Both packages run at one reduced sizing: 8 jobs, seed 1, a 3-day horizon
(the reference's module constants monkeypatched inside each test; nothing
under ``benchmarks/`` changes).  The reference takes its per-device loop,
the port its array drain and array replan with ``device="cpu"`` (the
kernels' plain versions).  The returned dicts are equal exactly, and so is
the printed output with the ``us_per_call`` column (a wall time) masked:
every ``name,us_per_call,derived`` row's name and derived, and the summary
tables.
"""
import re
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch_parity  # noqa: E402,F401  (one torch thread a worker)
import benchmarks.common as ref_common  # noqa: E402
import repro_torch.benchmarks.common as port_common  # noqa: E402
from repro.sim import SimConfig as RefSimConfig  # noqa: E402
from repro_torch.benchmarks import run as port_run  # noqa: E402
from repro_torch.sim import SimConfig  # noqa: E402

N_JOBS, SEEDS, HORIZON = 8, (1,), 3 * 24 * 3600.0
# modules holding their own copies of N_JOBS / SEEDS
MODULES = ("table1_workloads", "table2_demand_percentiles",
           "table3_resource_types", "table4_biased", "fig11_breakdown",
           "fig12_numjobs", "fig13_tiers", "fig14_fairness")


def shrink(monkeypatch):
    """Both packages' suites at the reduced sizing; the reference's
    ``benchmarks.<module>`` and the port's ``repro_torch.benchmarks.<module>``
    with each module's own ``N_JOBS``/``SEEDS`` and ``speedup_table``'s and
    ``avg_jct_over_seeds``' default seeds."""
    import importlib
    for common, sim in ((ref_common, RefSimConfig), (port_common, SimConfig)):
        monkeypatch.setattr(common, "N_JOBS", N_JOBS)
        monkeypatch.setattr(common, "SEEDS", SEEDS)
        monkeypatch.setattr(common, "BASE_SIM", sim(max_time=HORIZON))
        for fn in (common.speedup_table, common.avg_jct_over_seeds):
            d = list(fn.__defaults__)
            d[d.index((1,) if common.FAST else (1, 2))] = SEEDS
            monkeypatch.setattr(fn, "__defaults__", tuple(d))
    for name in MODULES:
        for pkg in ("benchmarks", "repro_torch.benchmarks"):
            mod = importlib.import_module(f"{pkg}.{name}")
            for const, val in (("N_JOBS", N_JOBS), ("SEEDS", SEEDS)):
                if hasattr(mod, const):
                    monkeypatch.setattr(mod, const, val)


def masked(text):
    """Printed output with each CSV row's ``us_per_call`` masked."""
    return re.sub(r"^([^,\n]+),-?[0-9.]+(e[+-]?\d+)?,", r"\1,<us>,", text,
                  flags=re.M)


def both(name, capsys, monkeypatch):
    """(reference result, its masked output, port result, its output)."""
    import importlib
    shrink(monkeypatch)
    ref = importlib.import_module(f"benchmarks.{name}")
    port = importlib.import_module(f"repro_torch.benchmarks.{name}")
    capsys.readouterr()
    want = ref.main()
    want_out = capsys.readouterr().out
    got = port.main(device="cpu")
    got_out = capsys.readouterr().out
    return want, masked(want_out), got, masked(got_out)


@pytest.mark.parametrize("name", ["table1_workloads",
                                  "table2_demand_percentiles",
                                  "table3_resource_types", "table4_biased"])
def test_table_equals_reference(name, capsys, monkeypatch):
    want, want_out, got, got_out = both(name, capsys, monkeypatch)
    assert got == want
    assert got_out == want_out
    rows = [ln for ln in got_out.splitlines() if ",<us>," in ln]
    assert rows and rows[-1].startswith(name.split("_")[0] + "_validates,")


def test_reduced_sizing_reaches_the_modules(monkeypatch):
    from repro_torch.benchmarks import table2_demand_percentiles
    shrink(monkeypatch)
    assert port_common.speedup_table.__defaults__[1] == SEEDS
    assert port_common.BASE_SIM.max_time == HORIZON
    assert table2_demand_percentiles.N_JOBS == N_JOBS


def test_run_sched_gives_the_device_to_venn_and_the_drain(monkeypatch):
    """``run_workload`` hands its device to the drain engine only; the
    harness builds VENN's replan engine on the same device."""
    from repro_torch.sim import JobTraceConfig
    from repro_torch.sim import simulator
    seen = {}
    real = simulator.Simulator.__init__

    def spy(self, jobs, scheduler, *a, **kw):
        seen["sched_device"] = scheduler.device
        seen["engine"], seen["device"] = kw["engine"], kw["device"]
        real(self, jobs, scheduler, *a, **kw)
    monkeypatch.setattr(simulator.Simulator, "__init__", spy)
    monkeypatch.setattr(port_common, "BASE_SIM", SimConfig(max_time=3600.0))
    port_common.run_sched("venn", JobTraceConfig(num_jobs=2, seed=1), 1,
                          device="cpu")
    assert str(seen["sched_device"]) == "cpu" == str(seen["device"])
    assert seen["engine"] == "array"


def test_both_engines_and_the_reference_agree(monkeypatch):
    """One simulation of Table 1 (``low``, VENN) on the port's array drain,
    on its per-device loop and on the reference's, bit for bit."""
    from repro.sim import JobTraceConfig as RefTrace
    from repro_torch.sim import JobTraceConfig
    from torch_parity import assert_same_metrics
    shrink(monkeypatch)
    cfg = dict(num_jobs=N_JOBS, seed=1, workload="low")
    m_ref, _, _ = ref_common.run_sched("venn", RefTrace(**cfg), 1)
    m_arr, _, _ = port_common.run_sched("venn", JobTraceConfig(**cfg), 1,
                                        device="cpu")
    m_py, _, _ = port_common.run_sched("venn", JobTraceConfig(**cfg), 1,
                                       device="cpu", engine="python")
    assert_same_metrics(m_arr, m_py)
    assert_same_metrics(m_arr, m_ref)
    assert len(m_arr.rounds) > 0


def test_run_lists_the_reference_entries_but_hotpath():
    """The port's ``ALL`` names the reference's entries in its order, now
    ``hotpath`` first as there (the name is from when it was left out)."""
    from benchmarks import run as ref_run
    from repro_torch.benchmarks import bench_hotpath
    assert [n for n, _ in port_run.ALL] == [n for n, _ in ref_run.ALL]
    assert port_run.ALL[0] == ("hotpath", bench_hotpath.main)


def test_run_prints_a_failing_entrys_traceback_and_exits_1(monkeypatch,
                                                           capsys):
    def broken(device):
        raise ValueError("broken entry")

    def fine(device):
        print(f"ran on {device}")
    monkeypatch.setattr(port_run, "ALL", [("broken", broken),
                                          ("fine", fine)])
    with pytest.raises(SystemExit) as e:
        port_run.main(["--device", "cpu"])
    assert e.value.code == 1
    cap = capsys.readouterr()
    assert "ValueError: broken entry" in cap.err
    assert "ran on cpu" in cap.out and "FAILED: ['broken']" in cap.out
    port_run.main(["fine", "--device", "cpu"])
    assert "all benchmarks completed" in capsys.readouterr().out
