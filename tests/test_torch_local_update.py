"""The FL client's local update vs the JAX reference's
``make_local_update``: two SGD steps on the example's client data (a
Dirichlet topic mix, ``B 4 × T 16``) on reduced configurations (2 layers,
vocab 128) at f32.  Losses within ``1e-5`` relative, each delta leaf within
``1e-4`` of that leaf's largest magnitude; ``gemma2-27b``'s attention
softcap takes the plain route, the others the flash wrapper through
``FlashAttentionFn``.  A local update leaves the caller's parameters as
they were.

The reference's forwards run through the ``reference_dist`` fixture
(``tests/torch_parity.py``).
"""
import functools

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.fed.client import make_local_update as jmake_local_update
from repro_torch import tree as tree_util
from repro_torch.fed.client import make_local_update
from torch_parity import client_batches, leaves_close, reduced_pair
from torch_parity import reference_dist  # noqa: F401  (a fixture)

ARCHS = ("llama3.2-1b", "stablelm-1.6b", "qwen3-32b", "gemma2-27b")
B, T, STEPS, LR = 4, 16, 2, 0.15


@functools.lru_cache(maxsize=None)
def _setup(arch):
    """Models, parameters and the example's client data: two minibatches of
    a Dirichlet client mix."""
    return (reduced_pair(arch, n_layers=2, vocab=128),
            client_batches(128, T, B, STEPS))


def _tbatches(batches):
    return {k: torch.from_numpy(v) for k, v in batches.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_local_update_equals_reference(arch, reference_dist):
    (jcfg, jmodel, jparams, cfg, model, params), batches = _setup(arch)
    jdelta, jm = jmake_local_update(jmodel, lr=LR, local_steps=STEPS)(
        jparams, {k: jnp.asarray(v) for k, v in batches.items()})
    delta, m = make_local_update(model, lr=LR, local_steps=STEPS)(
        params, _tbatches(batches))
    for k in ("loss_first", "loss_last"):
        assert abs(float(m[k]) - float(jm[k])) <= 1e-5 * abs(float(jm[k])), k
    assert float(m["loss_last"]) < float(m["loss_first"])
    assert all(t.dtype == torch.float32 for t in tree_util.leaves(delta))
    leaves_close(delta, jdelta, 1e-4, arch)


def test_local_update_leaves_the_callers_params_alone():
    (_, _, _, cfg, model, params), batches = _setup("llama3.2-1b")
    before = tree_util.map(lambda t: t.clone(), params)
    delta, _ = make_local_update(model, lr=LR, local_steps=STEPS,
                                 momentum=0.9)(params, _tbatches(batches))
    for a, b in zip(tree_util.leaves(params), tree_util.leaves(before)):
        assert torch.equal(a, b) and not a.requires_grad
    assert max(float(d.abs().max()) for d in tree_util.leaves(delta)) > 0


def test_local_update_checks_the_steps_axis():
    (_, _, _, cfg, model, params), batches = _setup("llama3.2-1b")
    with pytest.raises(ValueError, match="local_steps=3"):
        make_local_update(model, local_steps=3)(params, _tbatches(batches))
