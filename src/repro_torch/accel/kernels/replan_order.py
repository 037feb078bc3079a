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
exactly representable in f32 the ranks equal the TPU kernel's.  A warp owns
row ``i`` (its key in registers), its lanes stride over the ``j`` axis,
which streams through shared memory in tiles shared by the block's warps,
and ``__reduce_add_sync`` sums the count.

Two entry points, one kernel source, one launch counter each:

* :func:`segmented_rank` — the reference's contract (any ``seg_ids``, a
  negative id never matches), so a parity test can feed both packages the
  same arrays;
* :func:`segmented_order` — the sorting permutation in the same launch:
  ``seg_ids`` sorted ascending (or None for one segment), each row finds its
  segment's ``[lo, hi)`` by binary search, compares only inside it and writes
  ``perm[lo + rank[i]] = i``.  The reference's bincount, cumsum, gather and
  scatter around its kernel are gone.  :func:`segmented_order_staged` is
  the replan's form of it: one group's keys and ties from the host through
  the device's pinned stage, the whole resort one call of the C entry.

Bound on an H100: the rank entry needs ``n * n`` segment compares plus
three more (two f64, one i32) for each pair in the same segment; the order
entry only the three, plus ``log2 n`` compares a row for its binary search
when segment ids are given.  Either against ``16 n`` or ``20 n`` bytes; at
``n = 2000`` all of it is far under a launch's latency.

The plain PyTorch versions (:func:`segmented_rank_ref`,
:func:`segmented_order_ref`) are beside the wrappers.  A wrapper takes them
only for tensors that lie on the CPU; for CUDA tensors it launches the
kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from . import build
from .stage import stage_for

launches = 0        # kernel launches made by this module's wrappers
launches_rank = 0   # of those, by segmented_rank
launches_order = 0  # and by segmented_order


def reset_launches() -> None:
    global launches, launches_rank, launches_order
    launches = launches_rank = launches_order = 0


def segmented_rank_ref(seg_ids: torch.Tensor, keys: torch.Tensor,
                       ties: torch.Tensor) -> torch.Tensor:
    """The definition, as an ``(n, n)`` masked compare-count."""
    same = (seg_ids[None, :] == seg_ids[:, None]) & (seg_ids[None, :] >= 0)
    less = (keys[None, :] < keys[:, None]) | (
        (keys[None, :] == keys[:, None]) & (ties[None, :] < ties[:, None]))
    return (same & less).sum(dim=1).to(torch.int32)


def segmented_order_ref(seg_ids: torch.Tensor, keys: torch.Tensor,
                        ties: torch.Tensor) -> torch.Tensor:
    """Ranks -> permutation the reference's way: bincount, exclusive cumsum,
    ``perm[seg_start + rank[i]] = i``."""
    n = seg_ids.shape[0]
    dev = seg_ids.device
    rank = segmented_rank_ref(seg_ids, keys, ties)
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


_fns = {}           # C entry name -> the entry, argument types set once
_ARGTYPES = {
    "venn_segmented_rank": [ctypes.c_void_p] * 4 + [ctypes.c_int,
                                                    ctypes.c_void_p],
    "venn_segmented_order": [ctypes.c_void_p] * 4 + [ctypes.c_int]
    + [ctypes.c_void_p] * 2 + [ctypes.c_size_t] + [ctypes.c_void_p] * 2,
}


def _entry(name: str):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(build.load_library("segmented_rank"), name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def ensure_built() -> None:
    """Build and load the kernel now (the replan engine calls this at
    construction, outside any fallback)."""
    _entry("venn_segmented_rank")
    _entry("venn_segmented_order")


def _check(seg_ids: Optional[torch.Tensor], keys: torch.Tensor,
           ties: torch.Tensor, what: str) -> None:
    n = keys.shape[0] if keys.dim() == 1 else -1
    dev = keys.device
    for name, t, dt in (("seg_ids", seg_ids, torch.int32),
                        ("keys", keys, torch.float64),
                        ("ties", ties, torch.int32)):
        if t is None:
            continue
        if t.dtype != dt or t.dim() != 1 or t.shape[0] != n \
                or t.device != dev or not t.is_contiguous():
            raise ValueError(
                f"{what}: {name} must be a contiguous {dt} tensor of shape "
                f"({n},) on {dev}; got {t.dtype} {tuple(t.shape)} on "
                f"{t.device}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {dev}")


def _launch(name: str, seg_ids, keys, ties, out, stream: int,
            staged=()) -> None:
    """One call of a C entry; ``staged`` (the order entry only): host_in,
    dev_in, in_bytes, host_out — the copies and the synchronise around the
    launch (nothing staged: the launch alone)."""
    global launches, launches_rank, launches_order
    args = [seg_ids.data_ptr() if seg_ids is not None else None,
            keys.data_ptr(), ties.data_ptr(), out.data_ptr(), keys.shape[0]]
    if name == "venn_segmented_order":
        args += list(staged) if staged else [None, None, 0, None]
    with build.device_context(keys.device):
        code = _entry(name)(*args, stream)
    launches += 1
    if name == "venn_segmented_rank":
        launches_rank += 1
    else:
        launches_order += 1
    build.check_launch(code, name.removeprefix("venn_"))


def segmented_rank(seg_ids: torch.Tensor, keys: torch.Tensor,
                   ties: torch.Tensor) -> torch.Tensor:
    """``(n,)`` int32 ``seg_ids``, ``(n,)`` float64 ``keys``, ``(n,)`` int32
    ``ties`` (unique within a segment) -> ``(n,)`` int32 ranks."""
    if seg_ids is None:
        raise ValueError("segmented_rank: seg_ids must be a tensor")
    _check(seg_ids, keys, ties, "segmented_rank")
    if keys.device.type == "cpu":
        return segmented_rank_ref(seg_ids, keys, ties)
    rank = torch.empty(keys.shape[0], dtype=torch.int32, device=keys.device)
    if keys.shape[0]:
        _launch("venn_segmented_rank", seg_ids, keys, ties, rank,
                torch.cuda.current_stream(keys.device).cuda_stream)
    return rank


def segmented_order(seg_ids: Optional[torch.Tensor], keys: torch.Tensor,
                    ties: torch.Tensor) -> torch.Tensor:
    """The sorting permutation, segments laid out contiguously in ascending
    segment id: ``perm[seg_start + rank[i]] = i`` (``(n,)`` int32); equal to
    ``np.lexsort((ties, keys, seg_ids))``.  ``seg_ids`` must be sorted
    ascending and non-negative — checked on the CPU, trusted on the card —
    or None for one segment."""
    _check(seg_ids, keys, ties, "segmented_order")
    n = keys.shape[0]
    dev = keys.device
    if dev.type == "cpu":
        if seg_ids is None:
            seg_ids = torch.zeros(n, dtype=torch.int32)
        elif n and (bool((seg_ids[1:] < seg_ids[:-1]).any())
                    or int(seg_ids[0]) < 0):
            raise ValueError("segmented_order: seg_ids must be sorted "
                             "ascending and non-negative")
        return segmented_order_ref(seg_ids, keys, ties)
    # the entry zero-fills it (see segmented_order_ref)
    perm = torch.empty(n, dtype=torch.int32, device=dev)
    if n:
        _launch("venn_segmented_order", seg_ids, keys, ties, perm,
                torch.cuda.current_stream(dev).cuda_stream)
    return perm


def segmented_order_staged(keys: np.ndarray, ties: np.ndarray,
                           device) -> np.ndarray:
    """:func:`segmented_order` of one segment, from and to the host: the
    ``(n,)`` float64 ``keys`` and int32 ``ties`` go up in one copy from the
    pinned buffer of ``device``'s stage, and on a card the copy, the launch,
    the permutation's copy down and the synchronise are one call of the C
    entry.  Returns a view of the stage's pinned output buffer, valid until
    the stage's next call: callers copy what they keep."""
    n = len(keys)
    st = stage_for(device)
    nbytes = 12 * n                       # keys, then ties (f64 aligned)
    st.reserve(nbytes, 4 * n)
    st.host_in_np[:8 * n].view(np.float64)[:] = keys
    st.host_in_np[8 * n:nbytes].view(np.int32)[:] = ties
    keys_d = st.dev_in[:8 * n].view(torch.float64)
    ties_d = st.dev_in[8 * n:nbytes].view(torch.int32)
    out = st.host_out_np[:4 * n].view(np.int32)
    if not st.on_card:
        st.dev_in[:nbytes].copy_(st.host_in[:nbytes])
        out[:] = segmented_order(None, keys_d, ties_d).numpy()
    elif n:
        perm = st.dev_out[:4 * n].view(torch.int32)
        _launch("venn_segmented_order", None, keys_d, ties_d, perm,
                st.stream_handle(),
                (st.host_in_ptr, st.dev_in_ptr, nbytes, st.host_out_ptr))
    return out
