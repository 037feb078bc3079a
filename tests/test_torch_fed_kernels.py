"""Plain PyTorch versions of the port's federated-learning kernels vs the JAX
reference.

On the CPU a wrapper of ``repro_torch.kernels.ops`` runs its kernel's plain
version, so these tests hold that version (and the wrappers' argument
checks) against the reference's Pallas kernels in interpret mode and its jnp
oracles.  Inputs are made with NumPy from a seed and handed to both
packages.  Tolerances: ``fedavg_reduce`` 1e-6 in f32 and 2e-2 in bf16 (the
reference's own, ``tests/test_kernels.py``: sums in another order);
``quantize`` / ``dequantize`` bit-equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref
from repro_torch.kernels import fedavg_reduce as fedavg_mod
from repro_torch.kernels import quantize as quant_mod
from torch_parity import CPU  # noqa: F401  (sets torch's thread count)

_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _to_f32(x):
    return np.asarray(x, np.float32)


def _bits(a):
    """Bit patterns of an f32 array (NaN payloads and signed zeros count)."""
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


# -------------------------------------------------------------- fedavg reduce

FEDAVG_CASES = [(5, 1000, 256, 2), (16, 4096, 2048, 8), (3, 7, 2048, 8),
                (64, 513, 128, 16), (1, 300, 2048, 8)]


@pytest.mark.parametrize("K,N,bn,bk", FEDAVG_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fedavg_reduce_equals_reference(K, N, bn, bk, dtype):
    rng = np.random.default_rng(31 * K + N)
    u32 = rng.standard_normal((K, N)).astype(np.float32)
    w = rng.uniform(0.1, 5.0, K).astype(np.float32)
    uj = jnp.asarray(u32, _JDT[dtype])
    want_kernel = _to_f32(jops.fedavg_reduce(uj, jnp.asarray(w), block_n=bn,
                                             block_k=bk))
    want_ref = _to_f32(jref.fedavg_reduce_ref(uj, jnp.asarray(w)))
    ut = torch.from_numpy(u32).to(_TDT[dtype])
    fedavg_mod.reset_launches()
    got = ops.fedavg_reduce(ut, torch.from_numpy(w), block_n=bn, block_k=bk)
    assert fedavg_mod.launches == 0             # the CPU runs the plain version
    assert got.dtype == _TDT[dtype] and tuple(got.shape) == (N,)
    assert torch.equal(got, ref.fedavg_reduce_ref(ut, torch.from_numpy(w)))
    tol = 1e-6 if dtype == "float32" else 2e-2
    g = got.float().numpy()
    np.testing.assert_allclose(g, want_kernel, rtol=tol, atol=tol)
    np.testing.assert_allclose(g, want_ref, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fedavg_reduce_zero_weights_give_zero(dtype):
    rng = np.random.default_rng(5)
    u32 = rng.standard_normal((4, 600)).astype(np.float32)
    w = np.zeros(4, np.float32)
    want = _to_f32(jops.fedavg_reduce(jnp.asarray(u32, _JDT[dtype]),
                                      jnp.asarray(w)))
    got = ops.fedavg_reduce(torch.from_numpy(u32).to(_TDT[dtype]),
                            torch.from_numpy(w))
    assert not want.any()
    assert not got.float().numpy().any()


def test_fedavg_reduce_argument_checks():
    u = torch.zeros(3, 8)
    with pytest.raises(ValueError):
        ops.fedavg_reduce(u, torch.ones(2))
    with pytest.raises(ValueError):
        ops.fedavg_reduce(torch.zeros(0, 8), torch.ones(0))
    with pytest.raises(ValueError):
        ops.fedavg_reduce(u, torch.ones(3), block_n=0)


# ------------------------------------------------------------------- quantize

QUANT_CASES = [(1024, 256), (256 * 192, 256), (512, 128), (4096, 512)]


@pytest.mark.parametrize("N,block", QUANT_CASES)
def test_quantize_equals_reference(N, block):
    rng = np.random.default_rng(N + block)
    x = (rng.standard_normal(N) * rng.uniform(0.01, 100)).astype(np.float32)
    xj = jnp.asarray(x)
    qk, sk = jops.quantize(xj, block=block, rows_per_tile=1)
    qr, sr = jref.quantize_ref(xj, block=block)
    quant_mod.reset_launches()
    q, s = ops.quantize(torch.from_numpy(x), block=block, rows_per_tile=1)
    assert quant_mod.quantize_launches == 0
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert tuple(q.shape) == (N,) and tuple(s.shape) == (N // block,)
    np.testing.assert_array_equal(q.numpy(), np.asarray(qk))
    np.testing.assert_array_equal(q.numpy(), np.asarray(qr))
    np.testing.assert_allclose(s.numpy(), np.asarray(sk), rtol=1e-6)
    np.testing.assert_array_equal(_bits(s.numpy()), _bits(np.asarray(sr)))


@pytest.mark.parametrize("N,block", QUANT_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dequantize_equals_reference(N, block, dtype):
    rng = np.random.default_rng(7 * N + block)
    q = rng.integers(-127, 128, N).astype(np.int8)
    s = rng.uniform(1e-4, 3.0, N // block).astype(np.float32)
    want_kernel = jops.dequantize(jnp.asarray(q), jnp.asarray(s), block=block,
                                  rows_per_tile=1, dtype=_JDT[dtype])
    want_ref = jref.dequantize_ref(jnp.asarray(q), jnp.asarray(s), block=block,
                                   dtype=_JDT[dtype])
    quant_mod.reset_launches()
    got = ops.dequantize(torch.from_numpy(q), torch.from_numpy(s), block=block,
                         rows_per_tile=1, dtype=_TDT[dtype])
    assert quant_mod.dequantize_launches == 0
    assert got.dtype == _TDT[dtype]
    g = _bits(got.float().numpy())
    assert np.array_equal(g, _bits(_to_f32(want_kernel)))
    assert np.array_equal(g, _bits(_to_f32(want_ref)))


def test_quantize_round_trip_bound_and_half_even():
    """Exact halves round to even, as ``jnp.round`` does; the reconstruction
    error is at most half a step."""
    x = np.zeros(256, np.float32)
    x[0] = 127.0                                  # scale 1.0
    x[1:9] = [0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5]
    q, s = ops.quantize(torch.from_numpy(x), block=256)
    qj, _ = jref.quantize_ref(jnp.asarray(x), block=256)
    assert float(s[0]) == 1.0
    assert q[1:9].tolist() == [0, 2, 2, 0, -2, -2, 126, -126]
    np.testing.assert_array_equal(q.numpy(), np.asarray(qj))
    d = ops.dequantize(q, s, block=256).numpy()
    assert np.abs(d - x).max() <= 0.5


@pytest.mark.parametrize("bad", ["nan", "inf"])
def test_quantize_non_finite_block(bad):
    """A block holding a NaN gets scale NaN and codes 0 in both packages; a
    block holding an inf gets scale inf and codes 0 (finite / inf = 0,
    inf / inf = NaN)."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal(1024).astype(np.float32)
    x[300] = np.float32(bad)
    qj, sj = jref.quantize_ref(jnp.asarray(x), block=256)
    qk, sk = jops.quantize(jnp.asarray(x), block=256, rows_per_tile=1)
    q, s = ops.quantize(torch.from_numpy(x), block=256)
    assert np.array_equal(_bits(s.numpy()), _bits(np.asarray(sj)))
    assert np.array_equal(_bits(s.numpy()), _bits(np.asarray(sk)))
    np.testing.assert_array_equal(q.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(q.numpy(), np.asarray(qk))
    assert not q[256:512].any()
    assert q[:256].any() and q[512:].any()
    assert (np.isnan(s[1].item()) if bad == "nan" else s[1].item() == np.inf)


def test_quantize_argument_checks_follow_the_reference():
    x = torch.zeros(1000)
    with pytest.raises(ValueError):
        ops.quantize(x, block=256)                    # N % block
    with pytest.raises(ValueError):
        ops.quantize(torch.zeros(256 * 3), block=256, rows_per_tile=2)
    with pytest.raises(ValueError):
        ops.dequantize(torch.zeros(256 * 3, dtype=torch.int8),
                       torch.ones(3), block=256, rows_per_tile=2)
    with pytest.raises(ValueError):
        ops.dequantize(torch.zeros(512, dtype=torch.int8), torch.ones(3),
                       block=256)
    # the reference refuses the same calls
    with pytest.raises(AssertionError):
        jops.quantize(jnp.zeros(1000), block=256)
    with pytest.raises(AssertionError):
        jops.quantize(jnp.zeros(256 * 3), block=256, rows_per_tile=2)
