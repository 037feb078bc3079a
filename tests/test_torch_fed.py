"""The port's federated server round vs the JAX reference: compression,
top-k, aggregation and the FedAvg / FedAdam server steps.

Inputs are made with NumPy from a seed (parameters by the reference's own
``init_params``, carried across by ``params_from_jax``) and go through both
packages; the port runs on the CPU.  Tolerances: int8 codes bit-equal,
scales and reconstructions bit-equal to the reference's oracles (within
1e-6 of its Pallas kernel, see below); aggregation 1e-5 (the reference test's own); Adam moments 1e-6; bf16
parameters within one bf16 ulp (a moment that differs in its last f32 bit
can move the rounded bf16 by one step).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.fed import aggregation as jagg
from repro.fed import compression as jcomp
from repro.kernels import ref as jref
from repro.models.model import build_model as jax_build_model
from repro_torch import tree as tree_util
from repro_torch.fed import aggregation as agg
from repro_torch.fed import compression as comp
from repro_torch.kernels import fedavg_reduce as fedavg_mod
from repro_torch.kernels import quantize as quant_mod
from repro_torch.models import params_from_jax
from torch_parity import CPU


def _np(x):
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x, np.float32) if x.dtype.name == "bfloat16" \
        else np.asarray(x)


def _to_torch(tree):
    return tree_util.map(lambda a: torch.from_numpy(np.array(a)), tree)


@functools.lru_cache(maxsize=1)
def _tiny_llama():
    """``tests/test_fed.py``'s tiny model, in both packages (read-only: the
    server steps return new trees)."""
    cfg = jax_get_config("llama3.2-1b").reduced().with_(n_layers=2, vocab=128)
    jparams = jax_build_model(cfg).init_params(jax.random.PRNGKey(0))
    return jparams, params_from_jax(jax.tree.map(np.asarray, jparams), CPU)


def _random_deltas(jparams, n, seed):
    rng = np.random.default_rng(seed)
    return [jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(
        np.float32), jparams) for _ in range(n)]


def _ordered_bf16(x):
    """bf16 values (held as f32) as integers in value order, one per ulp."""
    b = (np.ascontiguousarray(x, np.float32).view(np.uint32) >> 16).astype(
        np.int64)
    return np.where(b & 0x8000, -(b & 0x7FFF), b)


def assert_within_one_bf16_ulp(got, want):
    d = np.abs(_ordered_bf16(got) - _ordered_bf16(want))
    assert d.max(initial=0) <= 1, d.max()


def assert_trees_close(got, want, tol):
    g, w = tree_util.leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(_np(a), _np(b), rtol=tol, atol=tol)


# ----------------------------------------------------------------- compress

def _fed_tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((512, 16)).astype(np.float32),
            "b": rng.standard_normal((1000,)).astype(np.float32)}


@pytest.mark.parametrize("block", [256, 128])
def test_compress_decompress_equal_reference(block):
    """Codes bit-equal to the reference's ``compress``; scales bit-equal to
    its oracle ``quantize_ref`` and within 1e-6 of its ``compress``, whose
    Pallas kernel (interpret mode, compiled by XLA on the CPU) takes
    ``absmax / 127`` as a multiply by the reciprocal, one ulp off in some
    blocks (one here, at block 128).  Reconstructions are bit-equal to
    the reference's ``dequantize`` of the same codes and scales."""
    tree = _fed_tree()
    cfg_j = jcomp.QuantizeConfig(block=block)
    cfg_t = comp.QuantizeConfig(block=block)
    pj = jcomp.compress(jax.tree.map(jnp.asarray, tree), cfg_j)
    quant_mod.reset_launches()
    pt = comp.compress(_to_torch(tree), cfg_t)
    for k in tree:
        assert pt[k]["shape"] == tuple(pj[k]["shape"])
        assert pt[k]["pad"] == pj[k]["pad"]
        np.testing.assert_array_equal(pt[k]["q"].numpy(), np.asarray(pj[k]["q"]))
        np.testing.assert_allclose(pt[k]["scales"].numpy(),
                                   np.asarray(pj[k]["scales"]), rtol=1e-6)
        flat = np.pad(tree[k].reshape(-1), (0, pt[k]["pad"]))
        qr, sr = jref.quantize_ref(jnp.asarray(flat), block=block)
        np.testing.assert_array_equal(pt[k]["q"].numpy(), np.asarray(qr))
        np.testing.assert_array_equal(pt[k]["scales"].numpy().view(np.uint32),
                                      np.asarray(sr).view(np.uint32))
    assert comp.compressed_bytes(pt) == jcomp.compressed_bytes(pj)
    dj = jcomp.decompress(pj, cfg_j)
    dt = comp.decompress(pt, cfg_t)
    for k in tree:
        assert tuple(dt[k].shape) == tree[k].shape
        np.testing.assert_allclose(dt[k].numpy(), np.asarray(dj[k]),
                                   rtol=1e-6, atol=0)
        same = jref.dequantize_ref(jnp.asarray(pt[k]["q"].numpy()),
                                   jnp.asarray(pt[k]["scales"].numpy()),
                                   block=block)
        n = tree[k].size
        np.testing.assert_array_equal(
            dt[k].numpy().reshape(-1).view(np.uint32),
            np.asarray(same)[:n].view(np.uint32))
    assert quant_mod.quantize_launches == 0 == quant_mod.dequantize_launches


def test_compression_disabled_and_raw_bytes():
    tree = _to_torch(_fed_tree(1))
    off = comp.QuantizeConfig(enabled=False)
    assert comp.compress(tree, off) is tree
    assert comp.decompress(tree, off) is tree
    raw = comp.compressed_bytes(tree)
    assert raw == jcomp.compressed_bytes(jax.tree.map(jnp.asarray,
                                                      _fed_tree(1)))
    assert comp.compressed_bytes(comp.compress(tree)) < 0.35 * raw


@pytest.mark.parametrize("frac", [0.05, 0.3, 1e-6])
def test_topk_equals_reference(frac):
    x = {"w": np.random.default_rng(1).standard_normal((64, 64)).astype(
        np.float32), "v": np.arange(-50, 50, dtype=np.float32)}
    pj = jcomp.topk_sparsify(jax.tree.map(jnp.asarray, x), frac=frac)
    pt = comp.topk_sparsify(_to_torch(x), frac=frac)
    for k in x:
        idx_j = np.asarray(pj[k]["idx"])
        idx_t = pt[k]["idx"].numpy()
        assert set(idx_t.tolist()) == set(idx_j.tolist())
        order_j, order_t = np.argsort(idx_j), np.argsort(idx_t)
        np.testing.assert_array_equal(pt[k]["val"].numpy()[order_t],
                                      np.asarray(pj[k]["val"])[order_j])
        assert pt[k]["shape"] == tuple(pj[k]["shape"])
    dj = jcomp.topk_densify(pj)
    dt = comp.topk_densify(pt)
    for k in x:
        np.testing.assert_array_equal(dt[k].numpy(), np.asarray(dj[k]))


# ---------------------------------------------------------------- aggregate

@pytest.mark.parametrize("use_kernel,min_size", [(True, 1), (True, 1024),
                                                 (False, 1024)])
def test_aggregate_deltas_equals_reference(use_kernel, min_size):
    jparams, _ = _tiny_llama()
    deltas = _random_deltas(jparams, 5, seed=0)
    w = [1.0, 2.0, 0.5, 3.0, 1.5]
    want = jagg.aggregate_deltas([jax.tree.map(jnp.asarray, d) for d in deltas],
                                 w, use_kernel=use_kernel,
                                 min_kernel_size=min_size)
    agg.reset_counts()
    fedavg_mod.reset_launches()
    got = agg.aggregate_deltas([_to_torch(d) for d in deltas], w,
                               use_kernel=use_kernel, min_kernel_size=min_size)
    assert_trees_close(got, want, 1e-5)
    sizes = [int(np.prod(p.shape)) for p in jax.tree.leaves(jparams)]
    small = sum(n < min_size for n in sizes)
    assert agg.plain_leaves == (len(sizes) if not use_kernel else small)
    assert fedavg_mod.launches == 0


def test_aggregate_deltas_argument_checks():
    with pytest.raises(ValueError):
        agg.aggregate_deltas([], [])
    with pytest.raises(ValueError):
        agg.aggregate_deltas([{"a": torch.zeros(3)}], [1.0, 2.0])


def test_fedavg_apply_equals_reference():
    jparams, tparams = _tiny_llama()
    delta = _random_deltas(jparams, 1, seed=3)[0]
    delta = jax.tree.map(lambda d: 0.01 * d, delta)
    sj = jagg.FedAvg(server_lr=0.5)
    st = agg.FedAvg(server_lr=0.5)
    nj, _ = sj.apply(jparams, jax.tree.map(jnp.asarray, delta),
                     sj.init(jparams))
    nt, state = st.apply(tparams, _to_torch(delta), st.init(tparams))
    assert state is None
    for a, b in zip(tree_util.leaves(nt), jax.tree.leaves(nj)):
        assert a.dtype == torch.bfloat16
        assert_within_one_bf16_ulp(_np(a), _np(b))


def test_fedadam_apply_equals_reference():
    jparams, tparams = _tiny_llama()
    sj, st = jagg.FedAdam(lr=1e-2), agg.FedAdam(lr=1e-2)
    statej, statet = sj.init(jparams), st.init(tparams)
    for rnd in range(2):
        delta = jax.tree.map(lambda d: 1e-3 * d,
                             _random_deltas(jparams, 1, seed=10 + rnd)[0])
        jparams, statej = sj.apply(jparams, jax.tree.map(jnp.asarray, delta),
                                   statej)
        tparams, statet = st.apply(tparams, _to_torch(delta), statet)
        assert int(statet.step) == int(statej.step) == rnd + 1
        assert statet.step.dtype == torch.int32
        assert_trees_close(statet.mu, statej.mu, 1e-6)
        assert_trees_close(statet.nu, statej.nu, 1e-6)
        for a, b in zip(tree_util.leaves(tparams), jax.tree.leaves(jparams)):
            assert a.dtype == torch.bfloat16
            assert_within_one_bf16_ulp(_np(a), _np(b))
        # carry on from the reference's parameters, so one ulp cannot grow
        tparams = params_from_jax(jax.tree.map(np.asarray, jparams), CPU)
