"""Masked first-fit — the inner step of the batched check-in matcher.

    kidx[i] = min { k : elig[i, k] != 0 and fillcand[i, k] >= pos[i] }, else K

Replaces the Pallas-TPU kernel ``repro/accel/kernels/schedule_match.py::
masked_first_fit`` (``_kernel``) with a CUDA C++ kernel for Hopper
(``csrc/masked_first_fit.cu``).  The TPU kernel pads the candidate axis to
128 lanes and has its caller pre-gather ``fillcand = fill[safe_req]`` because
it cannot gather; neither carries over.  Here a warp takes a row, walks the
candidate axis 32 columns at a time for any run-time ``K``, stops at the first
group with a hit, and — in the form the matcher launches,
:func:`first_fit_choice` — gathers ``fill[reqix[i, k]]`` itself and also
writes the chosen request index, so the ``(n, K)`` ``fillcand`` matrix and
three follow-up elementwise passes never exist.

Bound on an H100: bytes.  At ``n = 16384, K = 32`` the gather form moves about
2.7 MB (0.5 MB ``elig`` uint8, 2 MB ``reqix``, ``pos``, ``fill``, two outputs)
— under a microsecond at 3.35 TB/s — so what a caller sees is launch latency.

Two entry points, one kernel source, one launch counter:

* :func:`masked_first_fit` ``(elig, fillcand, pos)`` — the reference's
  contract, so a parity test can feed both packages the same three arrays;
* :func:`first_fit_choice` ``(elig, reqix, fill, pos)`` — the fused form.

Each has its plain PyTorch version beside it (``*_ref``).  A wrapper takes the
plain version only for a tensor that lies on the CPU; for a CUDA tensor it
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import build

launches = 0        # kernel launches made by this module's wrappers


def reset_launches() -> None:
    global launches
    launches = 0


# --------------------------------------------------------------------------- #
# Plain PyTorch versions
# --------------------------------------------------------------------------- #

def masked_first_fit_ref(elig: torch.Tensor, fillcand: torch.Tensor,
                         pos: torch.Tensor) -> torch.Tensor:
    """The definition: first available candidate index per row, ``K`` when
    the row has none.  ``(n, K)``, ``(n, K)``, ``(n,)`` -> ``(n,)`` int32."""
    n, K = elig.shape
    if n == 0 or K == 0:
        return torch.full((n,), K, dtype=torch.int32, device=elig.device)
    avail = (elig != 0) & (fillcand >= pos[:, None])
    iota = torch.arange(K, dtype=torch.int32, device=elig.device)
    cols = torch.where(avail, iota, torch.tensor(K, dtype=torch.int32,
                                                 device=elig.device))
    return cols.min(dim=1).values


def first_fit_choice_ref(elig: torch.Tensor, reqix: torch.Tensor,
                         fill: torch.Tensor, pos: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the fused form: ``fillcand = fill[reqix]`` (entries
    with ``reqix < 0`` are never eligible), then ``choice[i] =
    reqix[i, kidx[i]]`` or ``-1``."""
    n, K = reqix.shape
    if n == 0 or K == 0 or fill.shape[0] == 0:
        return (torch.full((n,), K, dtype=torch.int32, device=reqix.device),
                torch.full((n,), -1, dtype=torch.int32, device=reqix.device))
    safe = reqix.clamp(min=0).long()
    kidx = masked_first_fit_ref(elig, fill[safe], pos)
    has = kidx < K
    kcl = kidx.clamp(max=K - 1).long()[:, None]
    picked = torch.gather(reqix, 1, kcl)[:, 0]
    choice = torch.where(has, picked, torch.full_like(picked, -1))
    return kidx, choice


# --------------------------------------------------------------------------- #
# Kernel wrappers
# --------------------------------------------------------------------------- #

def _lib() -> ctypes.CDLL:
    lib = build.load_library("masked_first_fit")
    fn = lib.venn_masked_first_fit
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def ensure_built() -> None:
    """Build and load the kernel now (engines call this at construction so a
    missing compiler surfaces there, not inside a guarded match)."""
    _lib()


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple,
           device: torch.device) -> None:
    if t.dtype != dtype or tuple(t.shape) != shape or t.device != device \
            or not t.is_contiguous():
        raise ValueError(
            f"masked_first_fit: {name} must be a contiguous {dtype} tensor of "
            f"shape {shape} on {device}; got {t.dtype} {tuple(t.shape)} on "
            f"{t.device}, contiguous={t.is_contiguous()}")


def _as_mask_u8(elig: torch.Tensor) -> torch.Tensor:
    """bool -> uint8 is a reinterpretation; any other dtype is compared."""
    if elig.dtype == torch.uint8:
        return elig
    if elig.dtype == torch.bool:
        return elig.view(torch.uint8)
    return (elig != 0).view(torch.uint8)


def _launch(elig_u8: torch.Tensor, cand: torch.Tensor, fill, pos: torch.Tensor,
            want_choice: bool):
    global launches
    n, K = cand.shape
    dev = cand.device
    kidx = torch.empty(n, dtype=torch.int32, device=dev)
    choice = torch.empty(n, dtype=torch.int32, device=dev) \
        if want_choice else None
    fn = _lib().venn_masked_first_fit
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        code = fn(elig_u8.data_ptr(), cand.data_ptr(),
                  fill.data_ptr() if fill is not None else None,
                  pos.data_ptr(), kidx.data_ptr(),
                  choice.data_ptr() if choice is not None else None,
                  n, K, fill.shape[0] if fill is not None else 0,
                  1 if fill is not None else 0, stream)
    launches += 1
    build.check_launch(code, "masked_first_fit")
    return kidx, choice


def masked_first_fit(elig: torch.Tensor, fillcand: torch.Tensor,
                     pos: torch.Tensor) -> torch.Tensor:
    """``(n, K)`` ``elig`` (bool, uint8 or int32; nonzero = eligible),
    ``(n, K)`` int32 ``fillcand``, ``(n,)`` int32 ``pos`` -> ``(n,)`` int32."""
    if elig.dim() != 2 or elig.shape != fillcand.shape:
        raise ValueError("masked_first_fit: elig and fillcand must be (n, K)")
    n, K = elig.shape
    dev = elig.device
    if dev.type == "cpu":
        return masked_first_fit_ref(elig, fillcand, pos)
    if dev.type != "cuda":
        raise ValueError(f"masked_first_fit: unsupported device {dev}")
    if n == 0 or K == 0:
        return torch.full((n,), K, dtype=torch.int32, device=dev)
    elig_u8 = _as_mask_u8(elig)
    _check("elig", elig_u8, torch.uint8, (n, K), dev)
    _check("fillcand", fillcand, torch.int32, (n, K), dev)
    _check("pos", pos, torch.int32, (n,), dev)
    return _launch(elig_u8, fillcand, None, pos, want_choice=False)[0]


def first_fit_choice(elig: torch.Tensor, reqix: torch.Tensor,
                     fill: torch.Tensor, pos: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused form: ``elig`` ``(n, K)`` bool/uint8 (true only where ``0 <=
    reqix < R``), ``reqix`` ``(n, K)`` int32, ``fill`` ``(R,)`` int32,
    ``pos`` ``(n,)`` int32 -> ``(kidx, choice)``, both ``(n,)`` int32."""
    if reqix.dim() != 2 or elig.shape != reqix.shape:
        raise ValueError("first_fit_choice: elig and reqix must be (n, K)")
    n, K = reqix.shape
    dev = reqix.device
    if dev.type == "cpu":
        return first_fit_choice_ref(elig, reqix, fill, pos)
    if dev.type != "cuda":
        raise ValueError(f"first_fit_choice: unsupported device {dev}")
    if n == 0 or K == 0 or fill.shape[0] == 0:
        return (torch.full((n,), K, dtype=torch.int32, device=dev),
                torch.full((n,), -1, dtype=torch.int32, device=dev))
    elig_u8 = _as_mask_u8(elig)
    _check("elig", elig_u8, torch.uint8, (n, K), dev)
    _check("reqix", reqix, torch.int32, (n, K), dev)
    _check("fill", fill, torch.int32, (fill.shape[0],), dev)
    _check("pos", pos, torch.int32, (n,), dev)
    return _launch(elig_u8, reqix, fill, pos, want_choice=True)
