"""Segmented rank / order — the replan's intra-group ``(demand_key, job_id)``
ordering (Alg. 1 lines 2-3 as a segmented argsort).

    rank[i] = |{ j : seg[j] == seg[i] >= 0,
                 (key[j], tie[j]) <lex (key[i], tie[i]) }|

Replaces the Pallas-TPU kernel ``repro/accel/kernels/replan_order.py::
segmented_rank`` (``_kernel``) with a CUDA C++ kernel for Hopper
(``csrc/segmented_rank.cu``).  The TPU kernel keeps the whole column axis
resident in VMEM, padded to 128 lanes, and ranks **f32** keys, leaning on a
host-side f64 guard for keys that collide after rounding.  Here keys are
**f64** and compared as f64 (the H100 has native f64), so the order is
``np.lexsort``'s and the guard never trips on finite keys; on keys that are
exactly representable in f32 the ranks equal the TPU kernel's.  One thread
owns row ``i`` and keeps its count in a register; the ``j`` axis streams
through shared memory in tiles of 256.

Bound on an H100: operations — ``n * n`` pair compares (two f64 and two i32
compares each) against ``20 n`` bytes moved; at ``n = 2000`` that is 16 M
compares and 40 KB, both far under a launch's latency.

:func:`segmented_order` turns ranks into the sorting permutation
(``perm[seg_start + rank[i]] = i``); its bincount, exclusive cumsum and
scatter are plain tensor ops outside the kernel, as they are outside the
Pallas call in the reference.

The plain PyTorch version (:func:`segmented_rank_ref`) is beside the wrapper.
A wrapper takes it only for a tensor that lies on the CPU; for a CUDA tensor
it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

launches = 0        # kernel launches made by this module's wrapper


def reset_launches() -> None:
    global launches
    launches = 0


def segmented_rank_ref(seg_ids: torch.Tensor, keys: torch.Tensor,
                       ties: torch.Tensor) -> torch.Tensor:
    """The definition, as an ``(n, n)`` masked compare-count."""
    same = (seg_ids[None, :] == seg_ids[:, None]) & (seg_ids[None, :] >= 0)
    less = (keys[None, :] < keys[:, None]) | (
        (keys[None, :] == keys[:, None]) & (ties[None, :] < ties[:, None]))
    return (same & less).sum(dim=1).to(torch.int32)


def _lib() -> ctypes.CDLL:
    lib = build.load_library("segmented_rank")
    fn = lib.venn_segmented_rank
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def ensure_built() -> None:
    """Build and load the kernel now (the replan engine calls this at
    construction, outside any fallback)."""
    _lib()


def segmented_rank(seg_ids: torch.Tensor, keys: torch.Tensor,
                   ties: torch.Tensor) -> torch.Tensor:
    """``(n,)`` int32 ``seg_ids``, ``(n,)`` float64 ``keys``, ``(n,)`` int32
    ``ties`` (unique within a segment) -> ``(n,)`` int32 ranks."""
    global launches
    n = seg_ids.shape[0]
    dev = seg_ids.device
    for name, t, dt in (("seg_ids", seg_ids, torch.int32),
                        ("keys", keys, torch.float64),
                        ("ties", ties, torch.int32)):
        if t.dtype != dt or tuple(t.shape) != (n,) or t.device != dev \
                or not t.is_contiguous():
            raise ValueError(
                f"segmented_rank: {name} must be a contiguous {dt} tensor of "
                f"shape ({n},) on {dev}; got {t.dtype} {tuple(t.shape)} on "
                f"{t.device}")
    if dev.type == "cpu":
        return segmented_rank_ref(seg_ids, keys, ties)
    if dev.type != "cuda":
        raise ValueError(f"segmented_rank: unsupported device {dev}")
    rank = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return rank
    fn = _lib().venn_segmented_rank
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        code = fn(seg_ids.data_ptr(), keys.data_ptr(), ties.data_ptr(),
                  rank.data_ptr(), n, stream)
    launches += 1
    build.check_launch(code, "segmented_rank")
    return rank


def segmented_order(seg_ids: torch.Tensor, keys: torch.Tensor,
                    ties: torch.Tensor) -> torch.Tensor:
    """Ranks -> the sorting permutation, segments laid out contiguously in
    ascending segment id: ``perm[seg_start + rank[i]] = i`` (``(n,)`` int32).
    Equal to ``np.lexsort((ties, keys, seg_ids))`` for sorted ``seg_ids``."""
    n = seg_ids.shape[0]
    dev = seg_ids.device
    if n == 0:
        return torch.empty(0, dtype=torch.int32, device=dev)
    rank = segmented_rank(seg_ids, keys, ties)
    seg = seg_ids.long()
    counts = torch.bincount(seg)
    starts = torch.cumsum(counts, 0) - counts
    slot = starts[seg] + rank
    # zeros, not empty: ranks of NaN keys are no permutation, so some slots
    # are never written and must still be valid indices for the caller's
    # strict-order check
    perm = torch.zeros(n, dtype=torch.int32, device=dev)
    perm[slot] = torch.arange(n, dtype=torch.int32, device=dev)
    return perm
