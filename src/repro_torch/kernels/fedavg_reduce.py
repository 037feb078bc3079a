"""FedAvg server reduction — the normalised weighted sum of client updates.

    out = Σ_k (w_k / max(Σw, 1e-12)) · u_k        u (K, N), w (K,) -> (N,)

Replaces the Pallas-TPU kernel ``repro/kernels/fedavg_reduce.py::
fedavg_reduce`` with a CUDA C++ kernel for Hopper (``csrc/fedavg_reduce.cu``):
a thread owns four columns and walks the clients in order, accumulating in
f32 in registers, one sweep of ``u`` and one write of the result, no padding.
The weights are normalised once here, in f32, as the reference does ("exact
match with ref"); the kernel's arithmetic is the plain version's
(:func:`~repro_torch.kernels.ref.fedavg_reduce_ref`), rounding for rounding.

Bound on an H100: bytes, ``(K + 1) · N`` elements — 9.66 GB and 2.9 ms at
``K = 8, N = 2^28`` f32, the largest leaf of llama3.2-1b.

A wrapper takes the plain version only for a tensor that lies on the CPU; for
a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from ..accel.kernels import build
from .ref import fedavg_reduce_ref, normalized_weights

launches = 0        # kernel launches made by this module's wrapper

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    global launches
    launches = 0


def _lib() -> ctypes.CDLL:
    lib = build.load_library("fedavg_reduce")
    fn = lib.venn_fedavg_reduce
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_longlong,
                                               ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def ensure_built() -> None:
    _lib()


def fedavg_reduce(updates: torch.Tensor, weights: torch.Tensor
                  ) -> torch.Tensor:
    """``(K, N)`` f32 or bf16 updates, ``(K,)`` weights -> ``(N,)`` in the
    updates' dtype."""
    global launches
    if updates.dim() != 2 or weights.dim() != 1 \
            or weights.shape[0] != updates.shape[0]:
        raise ValueError(f"fedavg_reduce: updates (K, N) and weights (K,); "
                         f"got {tuple(updates.shape)}, {tuple(weights.shape)}")
    K, N = updates.shape
    if K == 0:
        raise ValueError("fedavg_reduce: no updates (K == 0)")
    dev = updates.device
    if dev.type == "cpu":
        return fedavg_reduce_ref(updates, weights)
    if dev.type != "cuda":
        raise ValueError(f"fedavg_reduce: unsupported device {dev}")
    if updates.dtype not in _DTYPES or not updates.is_contiguous() \
            or weights.device != dev:
        raise ValueError(
            f"fedavg_reduce: updates must be a contiguous float32 or bfloat16 "
            f"tensor with weights on the same device; got {updates.dtype}, "
            f"contiguous={updates.is_contiguous()}, updates on {dev}, "
            f"weights on {weights.device}")
    out = torch.empty(N, dtype=updates.dtype, device=dev)
    if N == 0:
        return out
    w = normalized_weights(weights).contiguous()
    fn = _lib().venn_fedavg_reduce
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        code = fn(updates.data_ptr(), w.data_ptr(), out.data_ptr(), K, N,
                  _DTYPES[updates.dtype], stream)
    launches += 1
    build.check_launch(code, "fedavg_reduce")
    return out
