"""The port stands alone: it imports neither JAX, nor the reference package,
nor the reference's ``benchmarks`` suite,
its modules import without a GPU or a CUDA compiler, and nothing in it falls
back to the CPU when no card is present."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
SRC = ROOT / "src"
PKG = SRC / "repro_torch"

MODULES = sorted(
    ".".join(p.relative_to(SRC).with_suffix("").parts).removesuffix(
        ".__init__")
    for p in PKG.rglob("*.py"))

_FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|repro|benchmarks)\b"
    r"|from\s+(jax|repro|benchmarks)[\s.])", re.M)


def test_package_has_the_expected_modules():
    for name in ("repro_torch.device", "repro_torch.accel.engine",
                 "repro_torch.accel.match", "repro_torch.accel.state",
                 "repro_torch.accel.replan",
                 "repro_torch.accel.kernels.build",
                 "repro_torch.accel.kernels.schedule_match",
                 "repro_torch.accel.kernels.match_segment",
                 "repro_torch.accel.kernels.stage",
                 "repro_torch.accel.kernels.replan_order",
                 "repro_torch.core.manager", "repro_torch.sim.simulator",
                 "repro_torch.obs.audit", "repro_torch.fed.overcommit",
                 "repro_torch.tree", "repro_torch.configs",
                 "repro_torch.configs.base", "repro_torch.configs.llama3_2_1b",
                 "repro_torch.models.common", "repro_torch.models.ffn",
                 "repro_torch.models.moe", "repro_torch.models.mamba",
                 "repro_torch.models.blocks", "repro_torch.models.model",
                 "repro_torch.models.convert", "repro_torch.kernels.ref",
                 "repro_torch.kernels.ops",
                 "repro_torch.kernels.fedavg_reduce",
                 "repro_torch.kernels.quantize",
                 "repro_torch.train.optimizer",
                 "repro_torch.fed.compression",
                 "repro_torch.fed.aggregation",
                 "repro_torch.kernels.flash_attention",
                 "repro_torch.models.attention", "repro_torch.serve",
                 "repro_torch.serve.engine", "repro_torch.launch",
                 "repro_torch.launch.serve",
                 "repro_torch.faults", "repro_torch.faults.plan",
                 "repro_torch.faults.injector", "repro_torch.faults.recovery",
                 "repro_torch.scenarios", "repro_torch.scenarios.spec",
                 "repro_torch.scenarios.library",
                 "repro_torch.scenarios.streams",
                 "repro_torch.scenarios.trace_io",
                 "repro_torch.scenarios.runner",
                 "repro_torch.scenarios.__main__",
                 "repro_torch.obs.timeline", "repro_torch.obs.contention",
                 "repro_torch.obs.summarize", "repro_torch.obs.__main__",
                 "repro_torch.data", "repro_torch.data.synthetic",
                 "repro_torch.fed.client", "repro_torch.train.train_step",
                 "repro_torch.ckpt", "repro_torch.ckpt.checkpoint",
                 "repro_torch.launch.train", "repro_torch.launch.mesh",
                 "repro_torch.launch.roofline", "repro_torch.launch.dryrun",
                 "repro_torch.launch.elastic", "repro_torch.core.ilp",
                 "repro_torch.benchmarks", "repro_torch.benchmarks.common",
                 "repro_torch.benchmarks.run",
                 "repro_torch.benchmarks.table1_workloads",
                 "repro_torch.benchmarks.table2_demand_percentiles",
                 "repro_torch.benchmarks.table3_resource_types",
                 "repro_torch.benchmarks.table4_biased",
                 "repro_torch.benchmarks.fig10_overhead",
                 "repro_torch.benchmarks.fig11_breakdown",
                 "repro_torch.benchmarks.fig12_numjobs",
                 "repro_torch.benchmarks.fig13_tiers",
                 "repro_torch.benchmarks.fig14_fairness",
                 "repro_torch.benchmarks.bench_scenarios",
                 "repro_torch.benchmarks.bench_kernels",
                 "repro_torch.benchmarks.bench_hotpath",
                 "repro_torch.benchmarks.regress",
                 "repro_torch.examples", "repro_torch.examples.quickstart",
                 "repro_torch.examples.scenario_tour",
                 "repro_torch.examples.serve_batched",
                 "repro_torch.examples.fl_multijob_training",
                 "repro_torch.examples.elastic_restart"):
        assert name in MODULES, name
    csrc = PKG / "accel" / "kernels" / "csrc"
    assert {p.name for p in csrc.glob("*.cu")} == {"masked_first_fit.cu",
                                                   "match_segment.cu",
                                                   "segmented_rank.cu"}
    csrc = PKG / "kernels" / "csrc"
    assert {p.name for p in csrc.glob("*.cu")} == {
        "fedavg_reduce.cu", "flash_attention.cu", "flash_attention_wgmma.cu",
        "quantize.cu"}


def test_every_reference_module_has_a_counterpart_but_two():
    """A diff of the two packages' ``*.py`` lists (``src/repro`` and the
    reference's ``benchmarks/`` against ``src/repro_torch``): only the
    jitted fixed point and the jnp oracles are missing, their work done by
    ``accel/match.py`` + ``accel/kernels/match_segment.py`` and by the
    ``*_ref`` functions of ``schedule_match.py`` / ``replan_order.py``."""
    def names(root, prefix=""):
        return {prefix + str(p.relative_to(root)) for p in root.rglob("*.py")}
    ref = names(SRC / "repro") | names(ROOT / "benchmarks", "benchmarks/")
    assert ref - names(PKG) == {"accel/_jax_impl.py", "accel/kernels/ref.py"}


def test_importing_every_module_pulls_in_neither_jax_nor_repro():
    code = (
        "import importlib, sys\n"
        f"mods = {MODULES!r}\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k.split('.')[0] in ('jax', 'jaxlib', 'repro',\n"
        "                                    'benchmarks'))\n"
        "assert not bad, bad\n"
        "assert 'torch' in sys.modules\n"
        "print('imported', len(mods))\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert f"imported {len(MODULES)}" in out.stdout


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in list(PKG.rglob("*.py"))
    + [ROOT / "chip_smoke.py"]))
def test_sources_import_neither_jax_nor_the_reference(path):
    text = (ROOT / path).read_text()
    m = _FORBIDDEN.search(text)
    assert m is None, f"{path}: {m.group(0)!r}"


def test_kernel_sources_are_cuda_with_a_plain_c_interface():
    from repro_torch.accel.kernels import build
    cus = [cu for d in (PKG / "accel" / "kernels" / "csrc",
                        PKG / "kernels" / "csrc") for cu in d.glob("*.cu")]
    assert len(cus) == 7
    for cu in cus:
        text = cu.read_text()
        assert "__global__" in text and 'extern "C"' in text, cu.name
        assert "torch/" not in text and "ATen" not in text, cu.name
    # one source list, one hash, one build directory for all of them
    assert sorted(build.sources()) == sorted(cus)
    assert "--use_fast_math" not in build.NVCC_FLAGS


def test_default_device_raises_without_cuda():
    import torch

    from repro_torch.device import default_device, resolve_device
    if torch.cuda.is_available():
        assert default_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        default_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    assert resolve_device("cpu").type == "cpu"


def test_no_fallback_that_hides_the_device():
    """No ``cuda if available else cpu`` anywhere in the port."""
    pat = re.compile(r"is_available\(\)\s*else|else\s+[\"']cpu[\"']")
    for p in list(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]:
        assert not pat.search(p.read_text()), p


def test_chip_smoke_fails_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the script would run in full")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=300,
                         cwd=str(ROOT))
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
