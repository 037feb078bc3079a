"""The port's model examples against the repo's ``examples/``:
``serve_batched`` prints the reference's first tokens for its three
reduced families (bf16) and ``fl_multijob_training`` makes the reference's
device assignments and eval losses, each package starting from the
reference's initial parameters (carried across by
``repro_torch.models.convert.params_from_jax``).  The reference's own
examples run unedited through the ``reference_dist`` fixture
(``tests/torch_parity.py``).
"""
import re
import sys

import jax
import numpy as np

from repro.configs import get_config as jget_config
from repro.models.model import build_model as jbuild_model
from repro_torch.models import params_from_jax
from test_torch_examples import port_example, reference_example
from torch_parity import reference_dist  # noqa: F401  (a fixture)


def _reference_params(cfg, seed, device):
    jparams = jbuild_model(cfg).init_params(jax.random.PRNGKey(seed))
    return params_from_jax(jax.tree.map(np.asarray, jparams), device)


def test_serve_batched_first_tokens_equal_reference(capsys, reference_dist):
    capsys.readouterr()
    reference_example("serve_batched").main()
    want = re.findall(r"^(\S+) .*first tokens (\[.*\])$",
                      capsys.readouterr().out, flags=re.M)

    def init(arch, model, device):
        return _reference_params(jget_config(arch).reduced(), 0, device)
    port_example("serve_batched").main(["--device", "cpu"],
                                       init_params=init)
    got = re.findall(r"^(\S+) .*first tokens (\[.*\])$",
                     capsys.readouterr().out, flags=re.M)
    assert got == want
    assert [a for a, _ in got] == ["llama3.2-1b", "mixtral-8x22b",
                                   "mamba2-1.3b"]


def _device_ids(types_mod):
    """The next id ``Device`` will take (the counter's repr), unconsumed."""
    return int(re.search(r"\d+", repr(types_mod._device_ids)).group())


def _losses(text):
    return [[float(x) for x in re.findall(r"\d+\.\d+", ln.split("(")[0])]
            for ln in text.splitlines() if ln.startswith("round ")]


ROUNDS = "2"


def test_fl_multijob_training_equals_reference(capsys, monkeypatch,
                                               reference_dist):
    """A client's data mix is ``mixes[hash(dev_id) % 256]``, and ``dev_id``
    comes from a process-wide counter in each package: both counters start
    the run at the same value.  Device assignments are host decisions and
    equal exactly.  The eval losses are held to 2^-8 of the reference's
    (plus the print's 0.0005 a value): the models are bf16, so a loss is
    resolved to about one bf16 ulp of its magnitude, and the two packages'
    bf16 rounding differs in the low bits of each update."""
    import repro.core.types as jtypes
    import repro_torch.core.types as ptypes
    while _device_ids(ptypes) < _device_ids(jtypes):
        next(ptypes._device_ids)
    while _device_ids(jtypes) < _device_ids(ptypes):
        next(jtypes._device_ids)
    capsys.readouterr()
    monkeypatch.setattr(sys, "argv", ["fl_multijob_training.py",
                                      "--rounds", ROUNDS])
    reference_example("fl_multijob_training").main()
    want = capsys.readouterr().out

    def init(i, arch, model, device):
        cfg = jget_config(arch).reduced().with_(n_layers=2, vocab=128)
        return _reference_params(cfg, i, device)
    port_example("fl_multijob_training").main(
        ["--device", "cpu", "--rounds", ROUNDS], init_params=init)
    got = capsys.readouterr().out
    assigned = re.compile(r"devices assigned: [\d,]+")
    assert assigned.findall(got) == assigned.findall(want)
    assert len(assigned.findall(got)) == int(ROUNDS)
    first = re.compile(r"^initial eval losses: .*$", re.M)
    assert first.findall(got) == first.findall(want)
    for g_row, w_row in zip(_losses(got), _losses(want), strict=True):
        for g, w in zip(g_row, w_row, strict=True):
            assert abs(g - w) <= 2 ** -8 * abs(w) + 1e-3, (g_row, w_row)
    assert "3/3 jobs improved eval loss" in got
