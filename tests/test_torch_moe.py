"""The port's Mixture-of-Experts (``repro_torch.models.moe``) vs the JAX
reference's ``repro.models.moe``.

``moe_ffn`` ungrouped (``groups=1``) and grouped (2 and 4 groups, and the
automatic count), with ample, tight and vanishing capacity (tokens
dropped), the shared expert, a seeded router bias, the aux loss, the tie
order of the top-k, and the gradient.  Reduced sizes (``D 32``, 8 experts,
top-2, ``d_ff 64``) at f32, parameters from the reference's
``materialize`` with the router bias drawn by NumPy, inputs from NumPy.
Tolerance: ``2e-5`` on outputs and the aux loss (the reference's own
``tests/test_moe.py``), ``1e-4`` of each gradient leaf's largest magnitude.
The reference's grouped path imports ``repro.dist``: those cases run
through the ``reference_dist`` fixture.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.common import materialize
from repro.models.moe import auto_groups as jauto_groups
from repro.models.moe import moe_ffn as jmoe_ffn
from repro.models.moe import moe_specs
from repro_torch.models import moe, params_from_jax
from repro_torch.train.train_step import value_and_grad
from torch_parity import CPU, leaves_close
from torch_parity import reference_dist  # noqa: F401  (a fixture)

D, E, K, FF = 32, 8, 2, 64
TOL = 2e-5


def _setup(seed=0, shared=1, zero_router=False):
    """Reference parameters (f32) with a seeded router bias, the port's
    copy, and a (2, 64, D) input."""
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      materialize(moe_specs(D, FF, E, n_shared=shared),
                                  jax.random.PRNGKey(seed)))
    if zero_router:
        jp["router"] = jnp.zeros_like(jp["router"])
    rng = np.random.default_rng(seed)
    bias = (0.05 * rng.standard_normal(E)).astype(np.float32)
    x = rng.standard_normal((2, 64, D)).astype(np.float32)
    p = params_from_jax(jax.tree.map(np.asarray, jp), CPU)
    return jp, p, bias, x


def _both(jp, p, x, bias=None, **kw):
    jy, jaux = jmoe_ffn(jp, jnp.asarray(x), top_k=K,
                        router_bias=None if bias is None else jnp.asarray(bias),
                        **kw)
    y, aux = moe.moe_ffn(p, torch.from_numpy(x), top_k=K,
                         router_bias=None if bias is None
                         else torch.from_numpy(bias), **kw)
    return np.asarray(jy), float(jaux), y.numpy(), float(aux)


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("groups", [1, 2, 4, 0])
@pytest.mark.parametrize("with_bias", [False, True])
def test_moe_ffn_equals_reference(groups, with_bias, reference_dist):
    """Ample capacity: no token dropped.  ``groups=0`` is the automatic
    count (1 group of these 128 tokens)."""
    jp, p, bias, x = _setup()
    jy, jaux, y, aux = _both(jp, p, x, bias if with_bias else None,
                             capacity_factor=8.0, groups=groups)
    _close(y, jy)
    assert aux == pytest.approx(jaux, rel=TOL)


@pytest.mark.parametrize("groups", [1, 4])
@pytest.mark.parametrize("cf", [0.25, 1.0, 1e-9])
def test_tight_capacity_drops_like_the_reference(groups, cf, reference_dist):
    """Tight capacity (and the one-slot floor at ``cf -> 0``): the same
    slots are dropped, the outputs equal and finite."""
    jp, p, bias, x = _setup(seed=1)
    jy, jaux, y, aux = _both(jp, p, x, bias, capacity_factor=cf,
                             groups=groups)
    assert np.isfinite(y).all()
    _close(y, jy)
    assert aux == pytest.approx(jaux, rel=TOL)
    # tokens really were dropped: the ample-capacity output differs
    _, _, y_ample, _ = _both(jp, p, x, bias, capacity_factor=8.0,
                             groups=groups)
    assert np.abs(y - y_ample).max() > 1e-3


@pytest.mark.parametrize("n", [1, 4, 64, 333, 2048, 4096, 4224, 1_048_576])
def test_auto_groups_equals_reference(n):
    assert moe.auto_groups(n) == jauto_groups(n)
    assert n % moe.auto_groups(n) == 0


def test_top_k_breaks_ties_toward_the_lower_index():
    """``jax.lax.top_k``'s order on tied scores: all-equal rows, and a row
    whose three ones tie (``torch.topk`` orders both otherwise)."""
    rows = np.zeros((3, 16), np.float32)
    rows[1, [3, 9, 12]] = 1.0
    rows[2] = np.random.default_rng(0).integers(0, 3, 16)
    _, want = jax.lax.top_k(jnp.asarray(rows), 4)
    got = moe.top_k_lower_first(torch.from_numpy(rows), 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[0].tolist() == [0, 1, 2, 3]
    assert got[1].tolist() == [3, 9, 12, 0]


@pytest.mark.parametrize("groups", [1, 4])
def test_tied_router_routes_like_the_reference(groups, reference_dist):
    """A zero router: every routing score ties, so every token goes to
    experts 0 and 1 — with tight capacity, the same tokens overflow."""
    jp, p, _, x = _setup(seed=2, zero_router=True)
    for cf in (8.0, 0.5):
        jy, jaux, y, aux = _both(jp, p, x, capacity_factor=cf, groups=groups)
        _close(y, jy)
        assert aux == pytest.approx(jaux, rel=TOL)


def test_router_bias_changes_routing_not_gates():
    """A bias shifts which experts are chosen, never the gate values: a
    bias equal on every expert changes nothing at all; one that forces
    expert 0 changes the output, and equals the reference's."""
    jp, p, _, x = _setup(seed=3, shared=0)
    tx = torch.from_numpy(x)
    y0, aux0 = moe.moe_ffn(p, tx, top_k=K, capacity_factor=8.0, groups=1)
    flat = torch.full((E,), 3.0)
    y1, aux1 = moe.moe_ffn(p, tx, top_k=K, capacity_factor=8.0, groups=1,
                           router_bias=flat)
    assert torch.equal(y0, y1) and float(aux0) == float(aux1)
    force = np.zeros(E, np.float32)
    force[0] = 100.0
    jy, jaux, y, aux = _both(jp, p, x, force, capacity_factor=8.0, groups=1)
    assert float((y0 - torch.from_numpy(y)).abs().max()) > 1e-3
    _close(y, jy)
    assert aux == pytest.approx(jaux, rel=TOL)


@pytest.mark.parametrize("groups", [1, 4])
def test_moe_gradient_equals_reference(groups, reference_dist):
    """``mean(y²) + 0.01 · aux``: value and every gradient leaf (router,
    experts, shared expert; the input) against ``jax.value_and_grad``,
    with drops (capacity factor 1)."""
    jp, p, bias, x = _setup(seed=4)

    def jloss(jp, x):
        y, aux = jmoe_ffn(jp, x, top_k=K, capacity_factor=1.0, groups=groups,
                          router_bias=jnp.asarray(bias))
        return jnp.mean(y ** 2) + 0.01 * aux

    def loss(tree):
        y, aux = moe.moe_ffn(tree["p"], tree["x"], top_k=K,
                             capacity_factor=1.0, groups=groups,
                             router_bias=torch.from_numpy(bias))
        return torch.mean(y ** 2) + 0.01 * aux

    jval, jgrads = jax.value_and_grad(jloss, argnums=(0, 1))(
        jp, jnp.asarray(x))
    val, grads = value_and_grad(loss, {"p": p, "x": torch.from_numpy(x)})
    assert float(val) == pytest.approx(float(jval), rel=1e-6)
    leaves_close(grads["p"], jgrads[0], 1e-4, "params")
    leaves_close([grads["x"]], [jgrads[1]], 1e-4, "x")


def test_moe_rejects_groups_that_do_not_divide_the_tokens():
    _, p, _, x = _setup()
    with pytest.raises(ValueError, match="do not divide"):
        moe.moe_ffn(p, torch.from_numpy(x), top_k=K, groups=3)


@pytest.mark.parametrize("groups", [1, 4])
@pytest.mark.parametrize("cf", [8.0, 1.0])
def test_buffers_cut_to_the_load_change_nothing(groups, cf, monkeypatch,
                                                reference_dist):
    """With every empty buffer row over the limit (``PAD_ROWS = 0``) the
    buffers hold only the largest kept load: the output equals the uncut
    one bit for bit, and the reference's."""
    jp, p, bias, x = _setup(seed=6)
    jy, jaux, full, _ = _both(jp, p, x, bias, capacity_factor=cf,
                              groups=groups)
    monkeypatch.setattr(moe, "PAD_ROWS", 0)
    _, _, cut, aux = _both(jp, p, x, bias, capacity_factor=cf,
                           groups=groups)
    np.testing.assert_array_equal(cut, full)
    _close(cut, jy)
    assert aux == pytest.approx(jaux, rel=TOL)
