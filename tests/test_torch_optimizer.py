"""The port's optimizers vs the JAX reference (``repro/train/optimizer.py``):
AdamW (with and without clipping and weight decay), SGD with and without
momentum, and ``global_norm``, over a few steps on random trees made with
NumPy from a seed.  Tolerance 1e-6: the same f32 operations, summed in
another order inside each leaf's norm.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import optimizer as jopt
from repro_torch import tree as tree_util
from repro_torch.train import optimizer as opt
from torch_parity import CPU  # noqa: F401  (sets torch's thread count)


def _to_torch(tree):
    return tree_util.map(lambda a: torch.from_numpy(np.array(a)), tree)


def assert_trees_close(got, want, tol):
    g, w = tree_util.leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=tol,
                                   atol=tol)


def _random_tree(seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((33, 17)).astype(dtype),
            "b": [rng.standard_normal(40).astype(dtype),
                  rng.standard_normal((3, 5)).astype(dtype)]}


@pytest.mark.parametrize("grad_clip,wd", [(0.0, 0.0), (1.0, 0.1), (50.0, 0.0)])
def test_adamw_update_equals_reference(grad_clip, wd):
    kw = dict(lr=0.05, b1=0.9, b2=0.95, eps=1e-8, weight_decay=wd,
              grad_clip=grad_clip)
    oj, ot = jopt.AdamW(**kw), opt.AdamW(**kw)
    pj = jax.tree.map(jnp.asarray, _random_tree(0))
    pt = _to_torch(_random_tree(0))
    sj, st = oj.init(pj), ot.init(pt)
    for step in range(3):
        g = _random_tree(100 + step)
        pj, sj = oj.update(jax.tree.map(jnp.asarray, g), sj, pj)
        pt, st = ot.update(_to_torch(g), st, pt)
        assert int(st.step) == step + 1
        assert_trees_close(st.mu, sj.mu, 1e-6)
        assert_trees_close(st.nu, sj.nu, 1e-6)
        assert_trees_close(pt, pj, 1e-6)


def test_adamw_bf16_params_keep_f32_state():
    o = opt.AdamW(lr=0.01)
    p = {"w": torch.ones(8, dtype=torch.bfloat16)}
    s = o.init(p)
    assert s.mu["w"].dtype == torch.float32 and s.step.dtype == torch.int32
    p1, _ = o.update({"w": torch.ones(8, dtype=torch.bfloat16)}, s, p)
    assert p1["w"].dtype == torch.bfloat16


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_sgd_update_equals_reference(momentum):
    oj, ot = jopt.SGD(lr=0.1, momentum=momentum), opt.SGD(lr=0.1,
                                                          momentum=momentum)
    pj = jax.tree.map(jnp.asarray, _random_tree(1))
    pt = _to_torch(_random_tree(1))
    sj, st = oj.init(pj), ot.init(pt)
    assert (st is None) == (momentum == 0.0)
    for step in range(3):
        g = _random_tree(200 + step)
        pj, sj = oj.update(jax.tree.map(jnp.asarray, g), sj, pj)
        pt, st = ot.update(_to_torch(g), st, pt)
        assert_trees_close(pt, pj, 1e-6)
        if momentum:
            assert_trees_close(st, sj, 1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_global_norm_equals_reference(seed):
    t = _random_tree(seed)
    want = float(jopt.global_norm(jax.tree.map(jnp.asarray, t)))
    got = opt.global_norm(_to_torch(t))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=1e-6)
    assert float(opt.global_norm({"a": torch.tensor([3.0]),
                                  "b": torch.tensor([4.0])})) == 5.0
