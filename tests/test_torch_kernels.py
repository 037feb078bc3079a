"""Plain PyTorch versions of the port's two kernels vs the JAX reference.

On the CPU a wrapper of ``repro_torch.accel.kernels`` runs its kernel's plain
version, so these tests hold that version (and the wrappers' argument
handling) against the reference's Pallas kernels in interpret mode, against
the reference's jnp oracles, and against ``np.lexsort``.  All outputs are
integers: every comparison is exact.
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.accel.kernels import (masked_first_fit as jax_first_fit,
                                 masked_first_fit_ref as jax_first_fit_ref,
                                 segmented_order as jax_segmented_order,
                                 segmented_rank as jax_segmented_rank,
                                 segmented_rank_ref as jax_segmented_rank_ref)
from repro_torch.accel.kernels import (first_fit_choice, masked_first_fit,
                                       masked_first_fit_ref, segmented_order,
                                       segmented_order_ref, segmented_rank,
                                       segmented_rank_ref)
from repro_torch.accel.kernels import build, replan_order, schedule_match
from torch_parity import CPU


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ------------------------------------------------------------ masked first-fit

@pytest.mark.parametrize("n,K", [(1, 1), (7, 3), (64, 5), (300, 17),
                                 (1024, 130), (33, 32), (40, 64)])
def test_masked_first_fit_equals_reference(n, K):
    rng = np.random.default_rng(1000 * n + K)
    elig = (rng.uniform(size=(n, K)) < 0.4).astype(np.int32)
    fill = rng.integers(-1, n + 1, size=(n, K)).astype(np.int32)
    pos = np.arange(n, dtype=np.int32)
    want_kernel = np.asarray(jax_first_fit(
        jnp.asarray(elig), jnp.asarray(fill), jnp.asarray(pos),
        interpret=True))
    want_ref = np.asarray(jax_first_fit_ref(
        jnp.asarray(elig), jnp.asarray(fill), jnp.asarray(pos)))
    got = masked_first_fit(_t(elig), _t(fill), _t(pos))
    got_ref = masked_first_fit_ref(_t(elig), _t(fill), _t(pos))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want_kernel)
    assert np.array_equal(got.numpy(), want_ref)
    assert torch.equal(got, got_ref)
    # bool and uint8 masks are the same function
    assert torch.equal(masked_first_fit(_t(elig != 0), _t(fill), _t(pos)), got)


@pytest.mark.parametrize("n,K,R", [(1, 1, 1), (50, 4, 3), (257, 33, 40),
                                   (512, 130, 200)])
def test_fused_choice_equals_pregathered_reference(n, K, R):
    """The fused form (gather ``fill[reqix]`` inside, emit the chosen request)
    equals the reference's three steps: pre-gather, first-fit, take."""
    rng = np.random.default_rng(7 * n + K + R)
    reqix = rng.integers(-1, R, size=(n, K)).astype(np.int32)
    elig = (rng.uniform(size=(n, K)) < 0.5) & (reqix >= 0)
    fill = rng.integers(-1, n + 1, size=R).astype(np.int32)
    pos = np.arange(n, dtype=np.int32)
    safe = np.where(reqix >= 0, reqix, 0)
    want_kidx = np.asarray(jax_first_fit(
        jnp.asarray(elig.astype(np.int32)), jnp.asarray(fill[safe]),
        jnp.asarray(pos), interpret=True))
    want_choice = np.where(want_kidx < K,
                           reqix[pos, np.minimum(want_kidx, K - 1)], -1)
    kidx, choice = first_fit_choice(_t(elig), _t(reqix), _t(fill), _t(pos))
    assert kidx.dtype == torch.int32 and choice.dtype == torch.int32
    assert np.array_equal(kidx.numpy(), want_kidx)
    assert np.array_equal(choice.numpy(), want_choice)


def test_first_fit_empty_shapes_launch_nothing():
    schedule_match.reset_launches()
    z2 = torch.zeros((0, 4), dtype=torch.int32)
    assert masked_first_fit(z2, z2, torch.zeros(0, dtype=torch.int32)
                            ).shape == (0,)
    kidx, choice = first_fit_choice(
        torch.zeros((3, 2), dtype=torch.bool),
        torch.full((3, 2), -1, dtype=torch.int32),
        torch.zeros(0, dtype=torch.int32), torch.arange(3, dtype=torch.int32))
    assert kidx.tolist() == [2, 2, 2] and choice.tolist() == [-1, -1, -1]
    assert schedule_match.launches == 0      # the CPU never launches


def test_first_fit_shape_mismatch_raises():
    with pytest.raises(ValueError):
        masked_first_fit(torch.zeros((3, 2), dtype=torch.int32),
                         torch.zeros((3, 3), dtype=torch.int32),
                         torch.arange(3, dtype=torch.int32))


# -------------------------------------------------------------- segmented rank

def _rank_inputs(n, rng):
    seg = np.sort(rng.integers(0, max(1, n // 9) + 1, n)).astype(np.int32)
    keys = rng.uniform(0, 100, n).astype(np.float32)
    if n > 4:                          # exercise the tie-break axis
        keys[1] = keys[0]
        keys[3] = keys[2]
    ties = rng.permutation(n).astype(np.int32)
    return seg, keys, ties


@pytest.mark.parametrize("n", [1, 2, 7, 64, 200, 513, 1024])
def test_segmented_rank_equals_reference(n):
    """f32-representable keys: the f64 ranks equal the reference kernel's."""
    seg, keys, ties = _rank_inputs(n, np.random.default_rng(n))
    want_kernel = np.asarray(jax_segmented_rank(
        jnp.asarray(seg), jnp.asarray(keys), jnp.asarray(ties),
        interpret=True))
    want_ref = np.asarray(jax_segmented_rank_ref(
        jnp.asarray(seg), jnp.asarray(keys), jnp.asarray(ties)))
    args = (_t(seg), _t(keys.astype(np.float64)), _t(ties))
    got = segmented_rank(*args)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want_kernel)
    assert np.array_equal(got.numpy(), want_ref)
    assert torch.equal(got, segmented_rank_ref(*args))


@pytest.mark.parametrize("n", [1, 6, 50, 257])
def test_segmented_order_equals_lexsort_and_reference(n):
    rng = np.random.default_rng(100 + n)
    seg = np.sort(rng.integers(0, max(1, n // 6) + 1, n)).astype(np.int32)
    keys = rng.uniform(0, 10, n).astype(np.float32)
    ties = rng.permutation(n).astype(np.int32)
    want = np.asarray(jax_segmented_order(
        jnp.asarray(seg), jnp.asarray(keys), jnp.asarray(ties),
        interpret=True))
    got = segmented_order(_t(seg), _t(keys.astype(np.float64)), _t(ties))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(got.numpy(), np.lexsort((ties, keys, seg)))


@pytest.mark.parametrize("n", [2, 9, 130, 600])
def test_segmented_order_f64_keys_colliding_in_f32(n):
    """Keys that differ only beyond f32 precision still sort as np.lexsort
    sorts the f64 keys — the case the f32 reference kernel hands to its
    host-side guard."""
    rng = np.random.default_rng(n)
    base = rng.choice([0.5, 1.25, 2.0, 1e6 / 3.0], size=n)
    keys = base * (1.0 + rng.integers(0, 4, n) * 2.0 ** -40)
    keys[0], keys[1] = 1.25 * (1.0 + 2.0 ** -40), 1.25
    assert len(np.unique(keys.astype(np.float32))) < len(np.unique(keys))
    seg = np.sort(rng.integers(0, 3, n)).astype(np.int32)
    ties = rng.permutation(n).astype(np.int32)
    got = segmented_order(_t(seg), _t(keys), _t(ties))
    assert np.array_equal(got.numpy(), np.lexsort((ties, keys, seg)))


def test_segmented_rank_negative_segment_never_matches():
    seg = _t(np.array([-1, -1, 0, 0], dtype=np.int32))
    keys = _t(np.array([1.0, 0.0, 5.0, 4.0]))
    ties = _t(np.arange(4, dtype=np.int32))
    assert segmented_rank(seg, keys, ties).tolist() == [0, 0, 1, 0]


def test_segmented_rank_rejects_wrong_dtypes_and_empty_is_free():
    replan_order.reset_launches()
    seg = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="keys"):
        segmented_rank(seg, torch.zeros(3, dtype=torch.float32), seg)
    with pytest.raises(ValueError, match="ties"):
        segmented_rank(seg, torch.zeros(3, dtype=torch.float64),
                       torch.zeros(3, dtype=torch.int64))
    e = torch.zeros(0, dtype=torch.int32)
    assert segmented_order(e, torch.zeros(0, dtype=torch.float64), e
                           ).shape == (0,)
    assert replan_order.launches == 0
    assert seg.device == CPU


# ------------------------------------------------------------ segmented order

@pytest.mark.parametrize("n,nseg", [(1, 1), (2, 1), (40, 1), (333, 1),
                                    (3, 2), (50, 7), (257, 30), (600, 4)])
def test_segmented_order_one_launch_form_equals_lexsort_and_reference(n,
                                                                      nseg):
    """Sorted segment ids (or None for one segment), f32-exact keys with
    ties: the order entry equals np.lexsort, the reference's Pallas
    segmented_order in interpret mode, and the bincount route."""
    rng = np.random.default_rng(31 * n + nseg)
    seg = np.sort(rng.integers(0, nseg, n)).astype(np.int32)
    keys = rng.choice([0.5, 1.25, 3.0, 7.75], size=n).astype(np.float32)
    ties = rng.permutation(n).astype(np.int32)
    want = np.lexsort((ties, keys, seg))
    jax_want = np.asarray(jax_segmented_order(
        jnp.asarray(seg), jnp.asarray(keys), jnp.asarray(ties),
        interpret=True))
    assert np.array_equal(jax_want, want)
    k64 = _t(keys.astype(np.float64))
    got = segmented_order(_t(seg), k64, _t(ties))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert torch.equal(got, segmented_order_ref(_t(seg), k64, _t(ties)))
    if nseg == 1:
        one = segmented_order(None, k64, _t(ties))
        assert np.array_equal(one.numpy(), np.lexsort((ties, keys)))


@pytest.mark.parametrize("segmented", [False, True])
def test_segmented_order_nan_keys_still_give_valid_indices(segmented):
    keys = np.array([2.0, np.nan, 1.0, 1.0, np.nan, 0.5, 3.0])
    n = len(keys)
    seg = _t(np.array([0, 0, 0, 1, 1, 1, 1], dtype=np.int32)) \
        if segmented else None
    perm = segmented_order(seg, _t(keys), _t(np.arange(n, dtype=np.int32)))
    assert perm.shape == (n,) and perm.dtype == torch.int32
    assert int(perm.min()) >= 0 and int(perm.max()) < n


@pytest.mark.parametrize("seg", [[1, 0, 2], [0, 2, 1], [-1, 0, 0]])
def test_segmented_order_refuses_unsorted_segments_on_the_cpu(seg):
    with pytest.raises(ValueError, match="sorted"):
        segmented_order(_t(np.array(seg, dtype=np.int32)),
                        torch.zeros(3, dtype=torch.float64),
                        torch.arange(3, dtype=torch.int32))


def test_order_and_rank_launches_are_counted_apart(monkeypatch):
    """With a stand-in library (no kernel runs on the CPU): each entry
    passes its pointers, n and the stream, and counts under its own name;
    the order form passes a null segment pointer for one segment."""
    calls = {}

    def entry(name):
        def fn(*args):
            calls.setdefault(name, []).append(args)
            return 0
        fn.argtypes = fn.restype = None
        return fn

    lib = types.SimpleNamespace(venn_segmented_rank=entry("rank"),
                                venn_segmented_order=entry("order"))
    monkeypatch.setattr(build, "load_library", lambda name: lib)
    monkeypatch.setattr(replan_order, "_fns", {})
    replan_order.reset_launches()
    seg = torch.zeros(5, dtype=torch.int32)
    keys = torch.zeros(5, dtype=torch.float64)
    ties = torch.arange(5, dtype=torch.int32)
    out = torch.zeros(5, dtype=torch.int32)
    replan_order._launch("venn_segmented_order", None, keys, ties, out, 7)
    replan_order._launch("venn_segmented_order", seg, keys, ties, out, 7)
    replan_order._launch("venn_segmented_rank", seg, keys, ties, out, 7)
    # the staged form: pinned in, device in, bytes, pinned out
    replan_order._launch("venn_segmented_order", None, keys, ties, out, 7,
                         (11, 12, 60, 13))
    assert calls["order"][0] == (None, keys.data_ptr(), ties.data_ptr(),
                                 out.data_ptr(), 5, None, None, 0, None, 7)
    assert calls["order"][1][0] == seg.data_ptr()
    assert calls["order"][2][5:] == (11, 12, 60, 13, 7)
    assert calls["rank"][0] == (seg.data_ptr(), keys.data_ptr(),
                                ties.data_ptr(), out.data_ptr(), 5, 7)
    assert (replan_order.launches, replan_order.launches_order,
            replan_order.launches_rank) == (4, 3, 1)
    monkeypatch.setattr(replan_order, "_fns", {})
    bad = types.SimpleNamespace(venn_segmented_order=lambda *a: 1)
    monkeypatch.setattr(build, "load_library", lambda name: bad)
    with pytest.raises(build.KernelLaunchError, match="segmented_order"):
        replan_order._launch("venn_segmented_order", None, keys, ties, out, 0)
