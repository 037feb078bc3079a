"""The check-in matcher's whole fixed point for one segment, in one launch.

Replaces, on the matcher's path, the host-driven round loop around the
Pallas-TPU kernel ``repro/accel/kernels/schedule_match.py::masked_first_fit``
— the reference runs that loop as one jitted ``lax.while_loop``
(``repro/accel/_jax_impl.py::_match_jax``) — with one CUDA C++ kernel for
Hopper (``csrc/match_segment.cu``): one CTA owns the segment, computes the
round-invariant eligibility once, and runs first-fit, the stable chooser
ranks and the fill update round after round until the fill positions stop
moving, voting on convergence inside the block.  Nothing returns to the
host between rounds.

A call costs one call from Python into the kernel's C entry, which copies
``rem`` and the live-row indices up from the pinned buffer of the device's
:class:`~repro_torch.accel.kernels.stage.PinnedStage` in one non-blocking
copy, launches the kernel, copies ``choice``, ``granted``, the round count
and the settled flag down into another pinned buffer in one non-blocking
copy, and synchronises the stream current at call time.

Two routes, one launch each, chosen by :func:`plan_layout`:

* one CTA (``n <= GRID_ROWS``): the kernel's state (``4 R`` ints of fill
  positions, counts and ``rem``; ``n (ceil(K / 32) + 2)`` ints of atom ids,
  choices and eligibility words) lies in dynamic shared memory where it
  fits and otherwise in a global scratch buffer; ``launches_scratch``
  counts the launches that kept some of it in global memory;
* a cooperative grid, a CTA a 1024-row tile (``n > GRID_ROWS``; counted in
  ``launches_grid``): one CTA walks a big segment's rows a warp at a time,
  round after round, and falls behind a program that spreads each round
  over the card; the grid spreads them over up to 16 SMs at the engine's
  ``SEG_ROWS``, with three grid barriers a round, its state in global
  scratch.  At 1024 rows one CTA is still the faster, at 2048 the grid.

Bound on an H100: latency — one CTA, a few µs of device time for the
segments the drain sees; the bytes a call moves are a few KB.

The plain version, :func:`match_segment_ref`, is the gather and eligibility
of the former ``match_chunk_torch`` followed by
:func:`repro_torch.accel.match.match_fixed_point`, a torch program with
the first-fit kernel's plain version in it (no kernel of this package).
The wrapper takes it only for tensors that lie on the CPU; for CUDA tensors
it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import build
from .stage import PinnedStage, stage_for

launches = 0            # kernel launches made by this module's wrapper
launches_grid = 0       # of those, on the cooperative grid route
launches_scratch = 0    # and one-CTA launches with state in global scratch

# dynamic shared memory a launch may use (csrc/match_segment.cu kDynSmemMax)
SMEM_BYTES = 220 * 1024
# rows a CTA ranks at once (csrc/match_segment.cu kThreads)
TILE_ROWS = 1024
# segments above this many rows take the grid route (on an H100 the grid
# is the slower at 1024 rows and the faster at 2048: chip_smoke.py's
# route comparison)
GRID_ROWS = 1536


def reset_launches() -> None:
    global launches, launches_grid, launches_scratch
    launches = launches_grid = launches_scratch = 0


class SegmentMatch(NamedTuple):
    """``choice`` (n,) int32 (-1: no slot), ``granted`` (n,) bool, the
    fixed point's round count, and whether it settled within ``R + 2``
    rounds (if not, ``choice`` and ``granted`` mean nothing)."""
    choice: np.ndarray
    granted: np.ndarray
    rounds: int
    settled: bool


class Layout(NamedTuple):
    grid: bool
    smem_bytes: int
    req_in_smem: bool
    row_in_smem: bool
    scratch_bytes: int


def plan_layout(n: int, K: int, R: int) -> Layout:
    """The route and where the kernel keeps its state.  One CTA: the
    request region (``4 R`` ints) in shared memory if it fits, then the row
    region (``n (ceil(K / 32) + 2)`` ints) if it fits beside it; what does
    not fit goes to global scratch.  (The CTA always runs 1024 threads, for
    small segments too: its loops over the ``R`` requests spread over all
    of them, and warps without a row cost little.)  The grid: both regions,
    two buffers of per-tile request counts and three flags in scratch."""
    req = 16 * R
    row = 4 * n * ((K + 31) // 32 + 2)
    if n > GRID_ROWS:
        tiles = -(-n // TILE_ROWS)
        return Layout(True, 0, False, False, req + row + 8 * tiles * R + 12)
    req_in = req <= SMEM_BYTES
    row_in = (req if req_in else 0) + row <= SMEM_BYTES
    smem = (req if req_in else 0) + (row if row_in else 0)
    scratch = (0 if req_in else req) + (0 if row_in else row)
    return Layout(False, smem, req_in, row_in, scratch)


# --------------------------------------------------------------------------- #
# Plain PyTorch version
# --------------------------------------------------------------------------- #

def match_segment_ref(cand_req: torch.Tensor, cand_lo: torch.Tensor,
                      cand_hi: torch.Tensor, ids: torch.Tensor,
                      speeds: torch.Tensor, start: int,
                      live: Optional[torch.Tensor], n: int,
                      rem: torch.Tensor) -> torch.Tensor:
    """The kernel's function as a torch program: gather the segment's rows,
    their candidate rows and the f64 eligibility, run
    :func:`~repro_torch.accel.match.match_fixed_point`; returns the kernel's
    output, ``(2 n + 2,)`` int32: choice, granted, rounds, settled."""
    from ..match import match_fixed_point
    dev = cand_req.device
    if live is None:
        rows = torch.arange(start, start + n, device=dev)
    else:
        rows = live.long() + start
    ids_r = ids.index_select(0, rows).long()
    sp = speeds.index_select(0, rows)[:, None]
    reqix = cand_req.index_select(0, ids_r)
    elig = (reqix >= 0) & (cand_lo.index_select(0, ids_r) <= sp) \
        & (sp < cand_hi.index_select(0, ids_r))
    R = rem.shape[0]
    rem_ext = torch.zeros(R + 1, dtype=torch.int32, device=dev)
    rem_ext[:R] = rem
    choice, granted, rounds = match_fixed_point(reqix, elig, rem_ext)
    out = torch.zeros(2 * n + 2, dtype=torch.int32, device=dev)
    if choice is not None:
        out[:n] = choice
        out[n:2 * n] = granted.to(torch.int32)
        out[2 * n + 1] = 1
    out[2 * n] = rounds
    return out


# --------------------------------------------------------------------------- #
# Kernel wrapper
# --------------------------------------------------------------------------- #

_fn = None          # the C entry, its argument types set once


def _entry():
    global _fn
    if _fn is None:
        fn = build.load_library("match_segment").venn_match_segment
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int]
                       + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def ensure_built() -> None:
    """Build and load the kernel now (the engine calls this at construction
    so a missing compiler surfaces there, not inside a guarded match)."""
    _entry()


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, ndim: int,
           device: torch.device) -> None:
    if t.dtype != dtype or t.dim() != ndim or t.device != device \
            or not t.is_contiguous():
        raise ValueError(
            f"match_segment: {name} must be a contiguous {ndim}-d {dtype} "
            f"tensor on {device}; got {t.dtype} {tuple(t.shape)} on "
            f"{t.device}, contiguous={t.is_contiguous()}")


def _launch(cand_req, cand_lo, cand_hi, ids, speeds, start, n, has_live,
            R, stage: PinnedStage) -> None:
    """One call of the C entry: the staged inputs up, the launch, the
    output down into ``stage.host_out``, the synchronise."""
    global launches, launches_grid, launches_scratch
    K = cand_req.shape[1]
    lay = plan_layout(n, K, R)
    scratch = stage.scratch(lay.scratch_bytes).data_ptr() \
        if lay.scratch_bytes else None
    with build.device_context(cand_req.device):
        code = _entry()(
            cand_req.data_ptr(), cand_lo.data_ptr(), cand_hi.data_ptr(), K,
            ids.data_ptr(), speeds.data_ptr(), start, n, int(has_live), R,
            stage.host_in_ptr, stage.dev_in_ptr, stage.dev_out_ptr,
            stage.host_out_ptr, scratch, lay.smem_bytes,
            int(lay.req_in_smem), int(lay.row_in_smem), int(lay.grid),
            stage.stream_handle())
    launches += 1
    if lay.grid:
        launches_grid += 1
    elif lay.scratch_bytes:
        launches_scratch += 1
    build.check_launch(code, "match_segment")


def match_segment(cand_req: torch.Tensor, cand_lo: torch.Tensor,
                  cand_hi: torch.Tensor, ids: torch.Tensor,
                  speeds: torch.Tensor, rem: np.ndarray, *, n: int,
                  start: int = 0, live: Optional[np.ndarray] = None
                  ) -> SegmentMatch:
    """Match rows ``start + live[i]`` (or ``start + i``), ``i < n``, of the
    bound chunk ``ids`` ``(N,)`` int32 / ``speeds`` ``(N,)`` float64 against
    the mirror's tables ``cand_req`` ``(A, K)`` int32, ``cand_lo`` /
    ``cand_hi`` ``(A, K)`` float64 and the host's ``rem`` ``(R,)`` remaining
    demands, through the pinned buffers of the device's stage.  Nothing is
    launched when ``n``, ``R`` or ``K`` is 0."""
    dev = cand_req.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"match_segment: unsupported device {dev}")
    _check("cand_req", cand_req, torch.int32, 2, dev)
    _check("cand_lo", cand_lo, torch.float64, 2, dev)
    _check("cand_hi", cand_hi, torch.float64, 2, dev)
    _check("ids", ids, torch.int32, 1, dev)
    _check("speeds", speeds, torch.float64, 1, dev)
    if cand_lo.shape != cand_req.shape or cand_hi.shape != cand_req.shape \
            or speeds.shape != ids.shape:
        raise ValueError("match_segment: table or chunk shapes disagree")
    span = int(live.max()) + 1 if live is not None and len(live) else n
    if live is not None and len(live) != n:
        raise ValueError("match_segment: live must hold n row indices")
    if start < 0 or start + span > ids.shape[0]:
        raise ValueError(f"match_segment: rows [{start}, {start + span}) "
                         f"outside the chunk of {ids.shape[0]}")
    R = len(rem)
    K = cand_req.shape[1]
    if n == 0 or R == 0 or K == 0:
        return SegmentMatch(np.full(n, -1, dtype=np.int32),
                            np.zeros(n, dtype=bool), int(n > 0 and R > 0),
                            True)
    stage = stage_for(dev)
    m = R + (n if live is not None else 0)
    stage.reserve(4 * m, 4 * (2 * n + 2))
    staged = stage.host_in_np[:4 * m].view(np.int32)
    staged[:R] = rem
    if live is not None:
        staged[R:] = live
    if dev.type == "cpu":
        inputs = stage.dev_in[:4 * m].view(torch.int32)
        inputs.copy_(stage.host_in[:4 * m].view(torch.int32))
        out = match_segment_ref(
            cand_req, cand_lo, cand_hi, ids, speeds, start,
            inputs[R:] if live is not None else None, n, inputs[:R]).numpy()
    else:
        _launch(cand_req, cand_lo, cand_hi, ids, speeds, start, n,
                live is not None, R, stage)
        out = stage.host_out_np[:4 * (2 * n + 2)].view(np.int32)
    return SegmentMatch(out[:n].copy(), out[n:2 * n] != 0, int(out[2 * n]),
                        bool(out[2 * n + 1]))
