"""The port's Mamba-2 SSD block (``repro_torch.models.mamba``) vs the JAX
reference's ``repro.models.mamba``.

``mamba_block`` at chunks 8, 16 and 64 and a ``T`` that is no multiple of
the chunk (the right-pad with ``dt = 0``), with one and two groups;
``return_state``; ``mamba_decode`` step by step against the reference's and
against the forward over the longer sequence; the causal conv with a tail;
the gradient; and the reference's NaN gradient at the published chunk of
256, which the port does not copy.  Small sizes (``D 32``, 4 heads × 16,
state 16) at f32, the reference's seeded parameters with ``a_log``,
``dt_bias`` and ``d_skip`` redrawn by NumPy (their inits are constants),
inputs from NumPy.  Tolerances: ``2e-4`` forward and state, ``5e-4``
decode (the reference tests' own, ``tests/test_models_parity.py``);
gradients within ``1e-4`` of each leaf's largest magnitude.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mamba as jmamba
from repro.models.common import materialize
from repro_torch import tree as tree_util
from repro_torch.models import mamba, params_from_jax
from repro_torch.train.train_step import value_and_grad
from torch_parity import CPU, leaves_close

D, H, P, N = 32, 4, 16, 16
KW = dict(n_heads=H, head_dim=P, d_state=N)


def _setup(seed=0, groups=1):
    rng = np.random.default_rng(seed)
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      materialize(jmamba.mamba_specs(D, H, P, N, groups),
                                  jax.random.PRNGKey(seed)))
    jp["a_log"] = jnp.asarray(0.5 * rng.standard_normal(H), jnp.float32)
    jp["dt_bias"] = jnp.asarray(0.5 * rng.standard_normal(H), jnp.float32)
    jp["d_skip"] = jnp.asarray(1 + 0.3 * rng.standard_normal(H), jnp.float32)
    p = params_from_jax(jax.tree.map(np.asarray, jp), CPU)
    return jp, p, rng


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("chunk,T", [(8, 64), (16, 64), (64, 64), (16, 50),
                                     (64, 37)])
@pytest.mark.parametrize("groups", [1, 2])
def test_mamba_block_equals_reference(chunk, T, groups):
    jp, p, rng = _setup(seed=chunk + T, groups=groups)
    x = rng.standard_normal((2, T, D)).astype(np.float32)
    want = jmamba.mamba_block(jp, jnp.asarray(x), n_groups=groups,
                              chunk=chunk, **KW)
    got = mamba.mamba_block(p, torch.from_numpy(x), n_groups=groups,
                            chunk=chunk, **KW)
    assert tuple(got.shape) == want.shape
    _close(got.detach(), want, 2e-4)


@pytest.mark.parametrize("chunk,T", [(16, 64), (16, 50), (64, 37)])
def test_return_state_equals_reference(chunk, T):
    """The state handed to decode: the SSM state after the last real step
    (the padded steps leave it unchanged) and the conv tails."""
    jp, p, rng = _setup(seed=7, groups=2)
    x = rng.standard_normal((2, T, D)).astype(np.float32)
    jout, jst = jmamba.mamba_block(jp, jnp.asarray(x), n_groups=2,
                                   chunk=chunk, return_state=True, **KW)
    out, st = mamba.mamba_block(p, torch.from_numpy(x), n_groups=2,
                                chunk=chunk, return_state=True, **KW)
    _close(out.detach(), jout, 2e-4)
    assert st._fields == jst._fields
    for name, a, b in zip(st._fields, st, jst):
        assert tuple(a.shape) == b.shape, name
        _close(a.detach(), b, 2e-4)


def test_init_state_equals_reference():
    st = mamba.init_state(3, H, P, N, 2)
    jst = jmamba.init_state(3, H, P, N, 2)
    for a, b in zip(st, jst):
        assert tuple(a.shape) == b.shape and not a.any()


def test_causal_conv_with_a_tail_equals_reference():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 9, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    tail = rng.standard_normal((2, 3, 12)).astype(np.float32)
    for t in (None, tail):
        want = jmamba._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                   None if t is None else jnp.asarray(t))
        got = mamba._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                                 None if t is None else torch.from_numpy(t))
        _close(got, want, 1e-6)


@pytest.mark.parametrize("groups", [1, 2])
def test_mamba_decode_stepwise_equals_reference_and_forward(groups):
    """Prefill 20 tokens, then 6 decode steps: each step's output equals
    the reference's decode and the forward over the whole sequence at that
    position; the state equals the reference's after every step."""
    T0, steps = 20, 6
    jp, p, rng = _setup(seed=11, groups=groups)
    x = rng.standard_normal((2, T0 + steps, D)).astype(np.float32)
    full = mamba.mamba_block(p, torch.from_numpy(x), n_groups=groups,
                             chunk=8, **KW).detach()
    _, jst = jmamba.mamba_block(jp, jnp.asarray(x[:, :T0]), n_groups=groups,
                                chunk=8, return_state=True, **KW)
    _, st = mamba.mamba_block(p, torch.from_numpy(x[:, :T0]),
                              n_groups=groups, chunk=8, return_state=True,
                              **KW)
    for i in range(steps):
        xt = x[:, T0 + i:T0 + i + 1]
        want, jst = jmamba.mamba_decode(jp, jnp.asarray(xt), jst,
                                        n_groups=groups, **KW)
        got, st = mamba.mamba_decode(p, torch.from_numpy(xt), st,
                                     n_groups=groups, **KW)
        _close(got.detach(), want, 5e-4)
        _close(got.detach(), full[:, T0 + i:T0 + i + 1], 5e-4)
        for a, b in zip(st, jst):
            _close(a.detach(), b, 5e-4)


@pytest.mark.parametrize("chunk", [16, 64])
def test_mamba_gradient_equals_reference(chunk):
    """``mean(y²)``: every parameter's gradient and the input's, at a T
    that is no multiple of the chunk."""
    jp, p, rng = _setup(seed=5, groups=2)
    x = rng.standard_normal((2, 72, D)).astype(np.float32)

    def jloss(jp, x):
        return jnp.mean(jmamba.mamba_block(jp, x, n_groups=2, chunk=chunk,
                                           **KW) ** 2)

    def loss(tree):
        return torch.mean(mamba.mamba_block(tree["p"], tree["x"], n_groups=2,
                                            chunk=chunk, **KW) ** 2)
    jval, jgrads = jax.value_and_grad(jloss, argnums=(0, 1))(
        jp, jnp.asarray(x))
    val, grads = value_and_grad(loss, {"p": p, "x": torch.from_numpy(x)})
    assert float(val) == pytest.approx(float(jval), rel=1e-5)
    leaves_close(grads["p"], jgrads[0], 1e-4, "params")
    leaves_close([grads["x"]], [jgrads[1]], 1e-4, "x")


def test_gradient_at_the_published_chunk_is_finite():
    """mamba2-1.3b's ``ssm_chunk = 256`` at ``T = 512``: the reference's
    ``where(causal, exp(diff), 0)`` overflows above the diagonal and its
    gradient is NaN; the port masks before the exponential, and its
    gradient is finite and equals the reference's at chunk 16 (the function
    does not depend on the chunk)."""
    jp, p, rng = _setup(seed=9)
    # the decay of the published init (a_log = dt_bias = 0): A = -1, dt =
    # softplus(·) around 0.7 — a chunk's log-decay spans about -180
    jp["a_log"] = jnp.zeros(H, jnp.float32)
    jp["dt_bias"] = jnp.zeros(H, jnp.float32)
    p = params_from_jax(jax.tree.map(np.asarray, jp), CPU)
    x = rng.standard_normal((1, 512, D)).astype(np.float32)

    def jloss(jp, chunk):
        return jnp.mean(jmamba.mamba_block(jp, jnp.asarray(x), chunk=chunk,
                                           **KW) ** 2)
    ref256 = jax.grad(jloss)(jp, 256)
    assert not all(bool(jnp.isfinite(g).all())
                   for g in jax.tree.leaves(ref256))     # fault 2, documented
    ref16 = jax.grad(jloss)(jp, 16)
    _, grads = value_and_grad(
        lambda q: torch.mean(mamba.mamba_block(q, torch.from_numpy(x),
                                               chunk=256, **KW) ** 2), p)
    for name in ("a_log", "dt_bias", "w_dt"):
        assert bool(torch.isfinite(grads[name]).all()), name
    assert all(bool(torch.isfinite(g).all())
               for g in tree_util.leaves(grads))
    leaves_close(grads, ref16, 1e-4, "chunk 256 vs the reference at 16")
