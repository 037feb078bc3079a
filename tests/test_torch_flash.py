"""The port's flash attention and attention layers vs the JAX reference.

On the CPU the flash kernel's wrapper runs its plain version
(``flash_attention_plain``, the reference's ``chunked_attention`` in plain
torch), so these tests hold that version, the public ``ops.flash_attention``
and the port's oracle against the reference's Pallas kernel in interpret mode
(as ``tests/test_kernels.py`` runs it) and its jnp oracle; then the model's
``chunked_attention`` (both its routes, and its refusal of query rows
without a key) and ``decode_attention`` against the reference's.  Inputs are made with NumPy
from a seed and handed to both packages.

Tolerances: ``2e-6`` in f32 and ``2e-2`` in bf16 for the kernel's function,
the reference's own (``tests/test_kernels.py``: the same sums in another
order; bf16 output rounding).  ``chunked_attention`` against the
reference's: ``2e-5`` in f32, as ``tests/test_kernels.py`` holds the kernel
against it (chunks of another size, so sums in another order).
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro_torch.kernels import flash_attention as fm
from repro_torch.kernels import ops, ref
from repro_torch.models import attention
from torch_parity import CPU  # noqa: F401  (sets torch's thread count)

_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_TOL = {"float32": 2e-6, "bfloat16": 2e-2}

# tests/test_kernels.py::FLASH_CASES
FLASH_CASES = [
    # (B, T, S, H, Hkv, D, causal, window, bq, bk)
    (1, 128, 128, 2, 2, 64, True, 0, 128, 128),
    (2, 256, 256, 4, 2, 64, True, 0, 128, 64),
    (1, 128, 128, 4, 1, 128, True, 64, 64, 64),
    (1, 256, 256, 2, 2, 32, False, 0, 128, 128),
    (2, 128, 128, 8, 4, 64, True, 32, 64, 32),
    (1, 512, 512, 2, 1, 64, True, 128, 128, 128),
]


def _qkv(seed, B, T, S, H, Hkv, D, Dv=None):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, Dv or D)).astype(np.float32)
    return q, k, v


def _both(arrays, dtype):
    """The same arrays for the reference (jnp) and the port (torch)."""
    j = [jnp.asarray(a, _JDT[dtype]) for a in arrays]
    t = [torch.from_numpy(a).to(_TDT[dtype]) for a in arrays]
    return j, t


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


# ------------------------------------------------------ the kernel's function

@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_equals_reference_kernel(case, dtype):
    B, T, S, H, Hkv, D, causal, window, bq, bk = case
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(sum(case), B, T, S, H, Hkv, D),
                                       dtype)
    want = jops.flash_attention(jq, jk, jv, causal=causal, window=window,
                                block_q=bq, block_k=bk)
    want_ref = jref.flash_attention_ref(jq, jk, jv, causal=causal,
                                        window=window)
    fm.reset_launches()
    got_ops = ops.flash_attention(tq, tk, tv, causal=causal, window=window,
                                  block_q=bq, block_k=bk)
    got = fm.flash_attention(tq, tk, tv, causal=causal, window=window)
    plain = fm.flash_attention_plain(tq, tk, tv, causal=causal, window=window,
                                     kv_chunk=bk)
    assert fm.launches == 0                 # the CPU runs the plain version
    assert got.dtype == _TDT[dtype] and tuple(got.shape) == (B, T, H, D)
    assert torch.equal(got_ops, got)
    for out in (got, plain):
        _close(out, want, _TOL[dtype])
        _close(out, want_ref, _TOL[dtype])


@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_ref_equals_reference_oracle(case, dtype):
    B, T, S, H, Hkv, D, causal, window, _, _ = case
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(7 + sum(case), B, T, S, H, Hkv,
                                            D), dtype)
    want = jref.flash_attention_ref(jq, jk, jv, causal=causal, window=window)
    got = ref.flash_attention_ref(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == _TDT[dtype]
    _close(got, want, _TOL[dtype])


@pytest.mark.parametrize("T,S,bq,bk", [(200, 128, 128, 128),
                                       (128, 100, 64, 64),
                                       (192, 192, 128, 128)])
def test_ops_flash_attention_keeps_the_reference_tile_check(T, S, bq, bk):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(3, 1, T, S, 2, 1, 16), "float32")
    with pytest.raises(AssertionError):
        jops.flash_attention(jq, jk, jv, block_q=bq, block_k=bk)
    with pytest.raises(ValueError, match="multiples of the blocks"):
        ops.flash_attention(tq, tk, tv, block_q=bq, block_k=bk)


@pytest.mark.parametrize("T,S,H,Hkv,D,causal,window,q_offset", [
    (100, 100, 4, 2, 64, True, 0, 0),        # ragged: no 64 / 128 multiple
    (1000, 1000, 2, 1, 16, True, 0, 0),
    (37, 37, 4, 4, 32, False, 0, 0),
    (77, 77, 4, 2, 16, True, 32, 0),
    (100, 356, 4, 2, 64, True, 0, 256),      # prefill continuation
    (33, 97, 2, 2, 32, True, 40, 64),
    (130, 130, 2, 1, 128, False, 50, 0),
    (50, 50, 4, 4, 80, False, 0, 0),         # hubert-xlarge's head_dim
])
def test_flash_attention_any_length_and_offset(T, S, H, Hkv, D, causal,
                                               window, q_offset):
    """Ragged lengths and ``q_offset`` (which the reference's kernel does
    not take) against the reference's ``chunked_attention``."""
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(T + S, 2, T, S, H, Hkv, D),
                                       "float32")
    want = jattn.chunked_attention(jq, jk, jv, causal=causal, window=window,
                                   kv_chunk=64, q_offset=q_offset)
    got = fm.flash_attention(tq, tk, tv, causal=causal, window=window,
                             q_offset=q_offset)
    _close(got, want, 2e-5)


_GRID = list(itertools.product((1, 5, 64), (1, 5, 64, 70), (0, 3, 60),
                               (False, True), (0, 1, 7, 64)))


@pytest.mark.parametrize("chunk", range(4))
def test_rows_without_key_is_exact(chunk):
    """The contract check against a brute-force mask."""
    for T, S, q_offset, causal, window in _GRID[chunk::4]:
        rel = (q_offset + np.arange(T))[:, None] - np.arange(S)[None, :]
        ok = np.ones_like(rel, dtype=bool)
        if causal:
            ok &= rel >= 0
        if window > 0:
            ok &= rel < window
        want = not ok.any(axis=1).all()
        assert fm.rows_without_key(T, S, q_offset, causal, window) == want, \
            (T, S, q_offset, causal, window)


@pytest.mark.parametrize("T,S,causal,window,q_offset", [
    (8, 4, False, 8, 100),        # the window ends before the keys start
    (8, 16, True, 4, 30),
    (8, 8, True, 0, -1),          # a negative offset: row 0 sees no key
    (4, 0, False, 0, 0),          # no keys at all
])
def test_flash_attention_refuses_rows_without_a_key(T, S, causal, window,
                                                    q_offset):
    _, (tq, tk, tv) = _both(_qkv(1, 1, T, S, 2, 1, 16), "float32")
    with pytest.raises(ValueError, match="no valid key"):
        fm.flash_attention(tq, tk, tv, causal=causal, window=window,
                           q_offset=q_offset)


def test_flash_attention_rejects_bad_shapes():
    t = torch.zeros((1, 8, 3, 16))
    kv = torch.zeros((1, 8, 2, 16))
    with pytest.raises(ValueError, match="H % Hkv"):
        fm.flash_attention(t, kv, kv)
    with pytest.raises(ValueError, match="dtype"):
        fm.flash_attention(torch.zeros((1, 8, 2, 16)), kv.to(torch.bfloat16),
                           kv)


# ------------------------------------------------------------ the model layer

CHUNKED_CASES = [
    # (B, Tq, Tk, H, Hkv, D, Dv, causal, window, softcap, kv_chunk, q_offset)
    (2, 48, 48, 4, 2, 16, 16, True, 0, 0.0, 16, 0),
    (2, 48, 48, 4, 2, 16, 16, False, 0, 0.0, 16, 0),
    (1, 40, 40, 4, 1, 32, 32, True, 32, 0.0, 64, 0),
    (1, 40, 40, 4, 4, 16, 16, False, 8, 0.0, 16, 0),
    (2, 24, 40, 4, 2, 16, 16, True, 0, 0.0, 16, 16),       # q_offset
    (2, 33, 33, 4, 2, 16, 16, True, 0, 0.0, 10, 0),        # 10 ∤ 33
    (1, 45, 45, 2, 2, 64, 64, True, 0, 0.0, 7, 0),
    (2, 40, 40, 4, 2, 16, 16, True, 0, 50.0, 16, 0),       # gemma2 softcap
    (1, 40, 40, 4, 2, 16, 16, True, 32, 20.0, 64, 0),
    (2, 32, 32, 4, 4, 24, 16, True, 0, 0.0, 16, 0),        # Dv != D (MLA)
    (1, 30, 30, 2, 1, 80, 80, False, 0, 0.0, 16, 0),       # hubert's D = 80
]


def _plain_route(case):
    B, Tq, Tk, H, Hkv, D, Dv, causal, window, cap, _, q_offset = case
    return cap > 0 or Dv != D


@pytest.mark.parametrize("case", CHUNKED_CASES)
def test_chunked_attention_equals_reference(case):
    B, Tq, Tk, H, Hkv, D, Dv, causal, window, cap, chunk, q_offset = case
    (jq, jk, jv), (tq, tk, tv) = _both(
        _qkv(Tq * Tk + D, B, Tq, Tk, H, Hkv, D, Dv), "float32")
    kw = dict(causal=causal, window=window, attn_softcap=cap, kv_chunk=chunk,
              q_offset=q_offset)
    want = jattn.chunked_attention(jq, jk, jv, **kw)
    attention.reset_counts()
    fm.reset_launches()
    got = attention.chunked_attention(tq, tk, tv, **kw)
    assert attention.attention_plain_calls == int(_plain_route(case))
    assert fm.launches == 0
    assert tuple(got.shape) == (B, Tq, H, Dv)
    _close(got, want, 2e-5)
    # the plain version alone is the reference's algorithm, chunk for chunk
    _close(fm.flash_attention_plain(tq, tk, tv, **kw), want, 2e-6)


@pytest.mark.parametrize("Tq,Tk,causal,window,q_offset", [
    (8, 8, True, 4, 20),          # the window ends before the keys start
    (8, 4, False, 8, 100),
])
def test_chunked_attention_refuses_rows_without_a_key(Tq, Tk, causal, window,
                                                      q_offset):
    """Outside the kernel's contract: refused on the CPU as on the card,
    where the kernel (which skips masked tiles) would give such a row other
    values than the reference (which visits them)."""
    _, (tq, tk, tv) = _both(_qkv(2, 1, Tq, Tk, 2, 2, 16), "float32")
    attention.reset_counts()
    with pytest.raises(ValueError, match="no valid key"):
        attention.chunked_attention(tq, tk, tv, causal=causal, window=window,
                                    kv_chunk=16, q_offset=q_offset)
    assert attention.attention_plain_calls == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_attention_bf16_and_f32_keep_the_dtype(dtype):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(5, 2, 40, 40, 4, 2, 16), dtype)
    want = jattn.chunked_attention(jq, jk, jv, kv_chunk=16)
    got = attention.chunked_attention(tq, tk, tv, kv_chunk=16)
    assert got.dtype == _TDT[dtype]
    _close(got, want, _TOL[dtype] if dtype == "bfloat16" else 2e-5)


DECODE_CASES = [
    # (B, S, H, Hkv, D, cache_len, softcap)
    (2, 40, 4, 2, 16, 17, 0.0),
    (2, 40, 4, 2, 16, 40, 0.0),
    (1, 32, 4, 4, 32, 1, 0.0),
    (2, 32, 4, 2, 16, 32, 50.0),
    (3, 24, 8, 2, 16, (5, 24, 12), 0.0),         # per-row lengths (B,)
]


@pytest.mark.parametrize("case", DECODE_CASES)
def test_decode_attention_equals_reference(case):
    B, S, H, Hkv, D, n, cap = case
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(S + H, B, 1, S, H, Hkv, D),
                                       "float32")
    if isinstance(n, tuple):
        jn, tn = jnp.asarray(n, jnp.int32), torch.tensor(n)
    else:
        jn, tn = jnp.asarray(n, jnp.int32), n
    want = jattn.decode_attention(jq, jk, jv, cache_len=jn, attn_softcap=cap)
    got = attention.decode_attention(tq, tk, tv, cache_len=tn,
                                     attn_softcap=cap)
    assert tuple(got.shape) == (B, 1, H, D)
    _close(got, want, 2e-6)


def test_kv_repeat_and_mask_equal_reference():
    rng = np.random.default_rng(4)
    kv = rng.standard_normal((2, 5, 2, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        attention.kv_repeat(torch.from_numpy(kv), 6).numpy(),
        np.asarray(jattn.kv_repeat(jnp.asarray(kv), 6)))
    qpos, kpos = np.arange(7, 15), np.arange(12)
    for causal, window in ((True, 0), (False, 3), (True, 4)):
        np.testing.assert_array_equal(
            attention._mask(torch.from_numpy(qpos), torch.from_numpy(kpos),
                            causal, window).numpy(),
            np.asarray(jattn._mask(jnp.asarray(qpos), jnp.asarray(kpos),
                                   causal, window)))
    assert attention.NEG_INF == jattn.NEG_INF == fm.NEG_INF
