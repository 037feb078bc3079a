"""The port's parameter declarations vs the JAX reference: spec trees, counts,
the carrying of parameter trees across, ``init_params``, and the pytree
helper's leaf order.

Nothing here allocates a full-width model: spec trees are declarations, and
only reduced configurations are materialised.
"""
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import get_config as jax_get_config
from repro.models.common import is_spec as jax_is_spec
from repro.models.model import build_model as jax_build_model
from repro_torch import tree as tree_util
from repro_torch.configs import ARCHS, get_config
from repro_torch.models import (build_model, is_spec, params_from_jax,
                                params_to_numpy)
from torch_parity import CPU


def _jax_path(path):
    out = []
    for k in path:
        for attr in ("key", "idx", "name"):
            if hasattr(k, attr):
                out.append(getattr(k, attr))
                break
        else:
            raise TypeError(k)
    return tuple(out)


def _jax_specs(cfg_name, reduced):
    cfg = jax_get_config(cfg_name)
    if reduced:
        cfg = cfg.reduced()
    specs = jax_build_model(cfg).param_specs()
    return [(_jax_path(p), s) for p, s in
            jax.tree_util.tree_leaves_with_path(specs, is_leaf=jax_is_spec)]


def _port_model(cfg_name, reduced):
    cfg = get_config(cfg_name)
    return build_model(cfg.reduced() if reduced else cfg)


CASES = [(a, r) for a in JAX_ARCHS for r in (False, True)]


def test_configs_are_the_reference_configs():
    assert ARCHS == JAX_ARCHS
    for name in ARCHS:
        for a, b in ((get_config(name), jax_get_config(name)),
                     (get_config(name).reduced(), jax_get_config(name).reduced()),
                     (get_config(name).with_(n_layers=2, vocab=128),
                      jax_get_config(name).with_(n_layers=2, vocab=128))):
            assert a.__dict__ == b.__dict__, name


@pytest.mark.parametrize("arch,reduced", CASES)
def test_spec_tree_equals_reference(arch, reduced):
    want = _jax_specs(arch, reduced)
    got = tree_util.leaves_with_path(_port_model(arch, reduced).param_specs(),
                                     is_leaf=is_spec)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, s), (_, r) in zip(got, want):
        assert s.shape == r.shape, path
        assert str(s.dtype).removeprefix("torch.") == jnp.dtype(r.dtype).name, path
        assert s.axes == r.axes, path
        assert s.init == r.init and s.scale == r.scale, path


@pytest.mark.parametrize("arch,reduced", CASES)
def test_param_counts_equal_reference(arch, reduced):
    cfg = jax_get_config(arch)
    jm = jax_build_model(cfg.reduced() if reduced else cfg)
    pm = _port_model(arch, reduced)
    assert pm.n_params() == jm.n_params()
    assert pm.n_active_params() == jm.n_active_params()


def test_llama_3_2_1b_count():
    m = build_model(get_config("llama3.2-1b"))
    assert m.n_params() == 1_235_814_400
    leaves = tree_util.leaves(m.param_specs(), is_leaf=is_spec)
    assert len(leaves) == 11
    assert max(int(np.prod(s.shape)) for s in leaves) == 16 * 2048 * 8192


def test_params_from_jax_round_trips_bit_for_bit():
    cfg = jax_get_config("mamba2-1.3b").reduced()       # bf16 + f32 leaves
    jparams = jax_build_model(cfg).init_params(jax.random.PRNGKey(3))
    jnp_tree = jax.tree.map(np.asarray, jparams)
    dtypes = {a.dtype.name for a in jax.tree.leaves(jnp_tree)}
    assert dtypes == {"bfloat16", "float32"}
    ported = params_from_jax(jnp_tree, CPU)
    jpaths = [_jax_path(p) for p, _ in
              jax.tree_util.tree_leaves_with_path(jnp_tree)]
    assert [p for p, _ in tree_util.leaves_with_path(ported)] == jpaths
    for t, a in zip(tree_util.leaves(ported), jax.tree.leaves(jnp_tree)):
        assert str(t.dtype).removeprefix("torch.") == a.dtype.name
        assert tuple(t.shape) == a.shape
    back = params_to_numpy(ported)
    for b, a in zip(tree_util.leaves(back), jax.tree.leaves(jnp_tree)):
        assert b.dtype == np.float32
        wide = np.asarray(a, np.float32)
        assert np.array_equal(b.view(np.uint32), wide.view(np.uint32))


@pytest.mark.parametrize("arch", JAX_ARCHS)
def test_init_params_reduced(arch):
    m = _port_model(arch, True)
    specs = m.param_specs()
    params = m.init_params(torch.Generator().manual_seed(0), CPU)
    sl = tree_util.leaves_with_path(specs, is_leaf=is_spec)
    pl = tree_util.leaves_with_path(params)
    assert [p for p, _ in sl] == [p for p, _ in pl]
    checked = 0
    for (path, s), (_, t) in zip(sl, pl):
        assert tuple(t.shape) == s.shape and t.dtype == s.dtype, path
        assert t.device.type == "cpu"
        x = t.float()
        if s.init == "zeros":
            assert not x.any(), path
        elif s.init == "ones":
            assert bool((x == 1).all()), path
        elif x.numel() >= 2000:
            fan_in = s.shape[-2] if len(s.shape) >= 2 else s.shape[-1]
            std = s.scale if s.scale is not None else fan_in ** -0.5
            assert abs(float(x.std()) / std - 1.0) < 0.1, path
            assert abs(float(x.mean())) < 0.1 * std, path
            checked += 1
    assert checked > 0


def test_init_params_needs_a_device():
    m = _port_model("llama3.2-1b", True)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        m.init_params(torch.Generator().manual_seed(0))


# ------------------------------------------------------------- pytree helper

class Pair(NamedTuple):
    b: object
    a: object


def _mixed_tree():
    return {"z": [1, (2, 3)], "a": Pair(b=4, a={"y": 5, "x": None}),
            "m": {"k2": 6, "k10": 7, "K": 8}, "n": None}


def test_tree_leaf_order_is_jax_order():
    t = _mixed_tree()
    assert tree_util.leaves(t) == jax.tree.leaves(t)
    got = [p for p, _ in tree_util.leaves_with_path(t)]
    want = [_jax_path(p) for p, _ in jax.tree_util.tree_leaves_with_path(t)]
    assert got == want


def test_tree_map_structure_unflatten():
    t = _mixed_tree()
    doubled = tree_util.map(lambda x: 2 * x, t)
    assert doubled == jax.tree.map(lambda x: 2 * x, t)
    assert isinstance(doubled["a"], Pair)
    summed = tree_util.map(lambda x, y: x + y, t, doubled)
    assert tree_util.leaves(summed) == [3 * x for x in tree_util.leaves(t)]
    rebuilt = tree_util.unflatten(tree_util.structure(t),
                                  tree_util.leaves(doubled))
    assert rebuilt == doubled
    with pytest.raises(ValueError):
        tree_util.unflatten(tree_util.structure(t), list(range(20)))
    with pytest.raises(ValueError):
        tree_util.map(lambda x, y: x, {"a": 1}, {"b": 1})
    packed = {"w": {"q": 1, "s": 2}, "v": 3}
    assert tree_util.leaves(packed, is_leaf=lambda x: isinstance(x, dict)
                            and "q" in x) == [3, {"q": 1, "s": 2}]


def test_tree_helpers_leave_no_reference_cycles():
    """A tree's tensors are freed as soon as the caller drops them: the
    helpers build no reference cycle that would hold the leaves until the
    cyclic collector runs (with a model's deltas on a card, gigabytes)."""
    import gc
    import weakref
    t = torch.zeros(4)
    alive = weakref.ref(t)
    tree = {"b": [t, None], "a": Pair(b=torch.ones(2), a={"x": t})}
    was_enabled = gc.isenabled()
    gc.disable()
    try:
        tree_util.leaves(tree)
        tree_util.leaves_with_path(tree)
        tree_util.structure(tree)
        tree_util.unflatten(tree_util.structure(tree), tree_util.leaves(tree))
        tree_util.map(lambda x, y: x, tree, tree)
        tree_util.leaves(tree, is_leaf=lambda x: isinstance(x, list))
        del tree, t
        assert alive() is None
    finally:
        if was_enabled:
            gc.enable()
