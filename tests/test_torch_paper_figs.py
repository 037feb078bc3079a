"""The port's reproduction of Figures 10-14, the scenario bench and the
kernel bench (``repro_torch.benchmarks``) against the reference's
``benchmarks/``, at the reduced sizing of ``test_torch_paper_tables.py``
(8 jobs, seed 1, a 3-day horizon; Figures 12 and 13, the two sweeps, are in
``test_torch_paper_sweeps.py``).

Figures 11 and 14 and the scenario bench (two scenarios): returned dicts equal
exactly, printed output equal with ``us_per_call`` masked.  Fig. 10 and the
kernel bench, whose ``derived`` are timings, match by row names, by
``venn_schedule``'s plan on ``_mk_groups(100, 4)``, and by the plain
kernels' outputs against the reference's oracles.
"""
import sys
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch_parity  # noqa: E402,F401  (one torch thread a worker)
from benchmarks import bench_kernels as ref_bk  # noqa: E402
from benchmarks import bench_scenarios as ref_bs  # noqa: E402
from benchmarks import fig10_overhead as ref_f10  # noqa: E402
from repro.kernels import ref as ref_oracles  # noqa: E402
from repro_torch.benchmarks import bench_kernels as port_bk  # noqa: E402
from repro_torch.benchmarks import bench_scenarios as port_bs  # noqa: E402
from repro_torch.benchmarks import fig10_overhead as port_f10  # noqa: E402
from repro_torch.kernels import ref as port_oracles  # noqa: E402
from test_torch_paper_tables import both, masked  # noqa: E402


def _names(text):
    return [ln.split(",", 1)[0] for ln in text.splitlines()
            if ",<us>," in masked(ln)]


@pytest.mark.parametrize("name", ["fig11_breakdown", "fig14_fairness"])
def test_figure_equals_reference(name, capsys, monkeypatch):
    want, want_out, got, got_out = both(name, capsys, monkeypatch)
    assert got == want
    assert got_out == want_out
    assert _names(got_out)[-1] == name.split("_")[0] + "_validates"


def _plan(plan):
    """A plan as names and ids: groups, per-atom priority, job order and
    the keys that made it."""
    return ([g.requirement.name for g in plan.groups],
            {tuple(sorted(a)): [g.requirement.name for g in gs]
             for a, gs in plan.atom_priority.items()},
            {k: [j.job_id for j in js] for k, js in plan.job_order.items()},
            dict(plan.job_keys))


def test_fig10_plan_equals_reference():
    ref_groups, port_groups = ref_f10._mk_groups(100, 4), \
        port_f10._mk_groups(100, 4)
    want = ref_f10.venn_schedule(ref_groups, queue_len=lambda g: g.queue_len)
    got = port_f10.venn_schedule(port_groups,
                                 queue_len=lambda g: g.queue_len)
    assert _plan(got) == _plan(want)
    assert len(got.job_order) == 4 and len(got.served_jobs()) == 4


def test_fig10_rows_equal_reference(capsys):
    capsys.readouterr()
    ref_f10.main()
    want = _names(capsys.readouterr().out)
    out = port_f10.main(device="cpu")
    got = _names(capsys.readouterr().out)
    assert got == want and len(got) == 7
    assert set(out) == {(100, 4), (1000, 4), (10000, 4), (1000, 16),
                        (10000, 16), (10000, 64)}


SCENARIOS = ("baseline_even", "flash_crowd")


def test_bench_scenarios_equals_reference(capsys, monkeypatch):
    from repro.scenarios import get_scenario as ref_get
    from repro_torch.scenarios import get_scenario as port_get
    monkeypatch.setattr(ref_bs, "all_scenarios",
                        lambda: [ref_get(n) for n in SCENARIOS])
    monkeypatch.setattr(port_bs, "all_scenarios",
                        lambda: [port_get(n) for n in SCENARIOS])
    capsys.readouterr()
    ref_bs.main()
    want = masked(capsys.readouterr().out)
    port_bs.main(device="cpu")
    got = masked(capsys.readouterr().out)
    assert got == want
    assert _names(got) == [f"scenario_{n}" for n in SCENARIOS]


class _Rng:
    """``default_rng``'s draws with every dimension of 1024 or more cut by
    64: the kernel bench's arrays at a size a test can hold, its row names
    (built from its size arguments) unchanged."""

    def __init__(self, seed):
        self._rng = np.random.default_rng(seed)

    def standard_normal(self, shape):
        shape = (shape,) if isinstance(shape, int) else shape
        return self._rng.standard_normal(
            tuple(d // 64 if d >= 1024 else d for d in shape))


def _small_numpy():
    mod = types.SimpleNamespace(**{k: getattr(np, k) for k in dir(np)
                                   if not k.startswith("__")})
    mod.random = types.SimpleNamespace(default_rng=_Rng)
    return mod


def test_bench_kernels_rows_equal_reference(capsys, monkeypatch):
    monkeypatch.setattr(ref_bk, "np", _small_numpy())
    monkeypatch.setattr(port_bk, "np", _small_numpy())
    capsys.readouterr()
    ref_bk.main()
    want = _names(capsys.readouterr().out)
    out = port_bk.main(device="cpu")
    got = _names(capsys.readouterr().out)
    # on the CPU there is no kernel: the plain rows, the reference's names
    assert got == want == ["fedavg_ref_32x4M", "quantize_ref_8M",
                           "attention_ref_1k"]
    assert all("kernel_us" not in v for v in out.values())


def test_bench_kernels_names_follow_the_sizes(capsys):
    out = port_bk.main(device="cpu", K=4, N=3 << 10, NQ=1 << 11, T=32, H=4,
                       HKV=2, D=16)
    assert _names(capsys.readouterr().out) == [
        "fedavg_ref_4x3072", "quantize_ref_2048", "attention_ref_32"]
    assert out["fedavg_reduce"]["bytes"] == (4 * 3072 + 3072) * 4
    assert out["flash_attention_wgmma"]["flops"] == 4 * 32 * 32 * 4 * 16


def test_bench_kernels_plain_versions_equal_the_reference_oracles():
    """The functions the port's bench times as plain versions, on the
    bench's inputs at a reduced size, against the reference's oracles."""
    rng = np.random.default_rng(0)
    u = rng.standard_normal((32, 4096)).astype(np.float32)
    w = np.ones(32, np.float32)
    got = port_oracles.fedavg_reduce_ref(torch.from_numpy(u),
                                         torch.from_numpy(w))
    want = ref_oracles.fedavg_reduce_ref(jnp.asarray(u), jnp.asarray(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    x = rng.standard_normal(8192).astype(np.float32)
    q, s = port_oracles.quantize_ref(torch.from_numpy(x), 256)
    jq, js = ref_oracles.quantize_ref(jnp.asarray(x), 256)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    qq = rng.standard_normal((1, 64, 8, 64))
    kk = rng.standard_normal((1, 64, 2, 64))
    got = port_oracles.flash_attention_ref(
        torch.from_numpy(qq).to(torch.bfloat16),
        torch.from_numpy(kk).to(torch.bfloat16),
        torch.from_numpy(kk).to(torch.bfloat16), causal=True)
    jq, jk = jnp.asarray(qq, jnp.bfloat16), jnp.asarray(kk, jnp.bfloat16)
    want = ref_oracles.flash_attention_ref(jq, jk, jk, causal=True)
    # bf16 outputs of an f32 computation: one bf16 ulp of |o| <= 4 apart
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=0,
                               atol=2 ** -6)
