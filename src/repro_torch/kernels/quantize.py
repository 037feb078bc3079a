"""Int8 symmetric block quantisation of client updates, both directions.

    quantize:    x (N,) f32 -> q (N,) int8, scales (N/block,) f32
                 scale = max(absmax / 127, 1e-12), q = clip(rint(x / scale), ±127)
    dequantize:  q (N,) int8, scales -> q · scale[block] in f32 or bf16

Replaces the Pallas-TPU kernels ``repro/kernels/quantize.py::quantize`` and
``::dequantize`` with one CUDA C++ source for Hopper (``csrc/quantize.cu``):
a warp per quantisation block for ``quantize`` (``block`` any multiple of 32
on the card), four elements a thread for ``dequantize``.  Codes, scales and
dequantised values are bit-equal to the plain versions
(:mod:`repro_torch.kernels.ref`) and to the reference — true division,
round half to even, NaN propagated into the scale and NaN quotients coded 0.

Bound on an H100: bytes — 5 bytes an element and 4 a block, 1.346 GB and
0.40 ms at ``N = 2^28, block = 256``, in either direction.

Each direction has its own launch counter.  A wrapper takes the plain
version only for a tensor that lies on the CPU; for a CUDA tensor it launches
the kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ..accel.kernels import build
from .ref import dequantize_ref, quantize_ref

quantize_launches = 0        # launches of the quantize kernel
dequantize_launches = 0      # launches of the dequantize kernel

_OUT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    global quantize_launches, dequantize_launches
    quantize_launches = dequantize_launches = 0


def _lib() -> ctypes.CDLL:
    lib = build.load_library("quantize")
    if lib.venn_quantize.argtypes is None:
        lib.venn_quantize.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
        lib.venn_quantize.restype = ctypes.c_int
        lib.venn_dequantize.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.venn_dequantize.restype = ctypes.c_int
    return lib


def ensure_built() -> None:
    _lib()


def _on_card(name: str, t: torch.Tensor) -> bool:
    """False for a CPU tensor (the plain version serves it), True for a
    CUDA tensor; raises for any other device."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")
    return True


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple,
           device: torch.device) -> None:
    if t.dtype != dtype or tuple(t.shape) != shape or t.device != device \
            or not t.is_contiguous():
        raise ValueError(
            f"{name}: expected a contiguous {dtype} tensor of shape {shape} on "
            f"{device}; got {t.dtype} {tuple(t.shape)} on {t.device}, "
            f"contiguous={t.is_contiguous()}")


def quantize(x: torch.Tensor, block: int = 256
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x`` ``(N,)`` f32 with ``N % block == 0`` -> ``(q int8 (N,),
    scales f32 (N/block,))``."""
    global quantize_launches
    if x.dim() != 1 or block <= 0 or x.shape[0] % block:
        raise ValueError(f"quantize: x must be (N,) with N % block == 0; got "
                         f"{tuple(x.shape)}, block={block}")
    if not _on_card("quantize", x):
        return quantize_ref(x, block)
    if block % 32:
        raise ValueError(f"quantize: block must be a multiple of 32 on the "
                         f"card; got {block}")
    N = x.shape[0]
    _check("quantize", x, torch.float32, (N,), x.device)
    q = torch.empty(N, dtype=torch.int8, device=x.device)
    s = torch.empty(N // block, dtype=torch.float32, device=x.device)
    if N == 0:
        return q, s
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        code = _lib().venn_quantize(x.data_ptr(), q.data_ptr(), s.data_ptr(),
                                    N, block, stream)
    quantize_launches += 1
    build.check_launch(code, "quantize")
    return q, s


def dequantize(q: torch.Tensor, scales: torch.Tensor, block: int = 256,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``q`` ``(N,)`` int8, ``scales`` ``(N/block,)`` f32 -> ``(N,)`` in
    ``dtype`` (f32 or bf16 on the card)."""
    global dequantize_launches
    if q.dim() != 1 or block <= 0 or q.shape[0] % block:
        raise ValueError(f"dequantize: q must be (N,) with N % block == 0; "
                         f"got {tuple(q.shape)}, block={block}")
    N = q.shape[0]
    if tuple(scales.shape) != (N // block,):
        raise ValueError(f"dequantize: scales must be ({N // block},); got "
                         f"{tuple(scales.shape)}")
    if not _on_card("dequantize", q):
        return dequantize_ref(q, scales, block, dtype)
    if dtype not in _OUT_DTYPES:
        raise ValueError(f"dequantize: dtype must be float32 or bfloat16 on "
                         f"the card; got {dtype}")
    _check("dequantize", q, torch.int8, (N,), q.device)
    _check("dequantize", scales, torch.float32, (N // block,), q.device)
    out = torch.empty(N, dtype=dtype, device=q.device)
    if N == 0:
        return out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        code = _lib().venn_dequantize(q.data_ptr(), scales.data_ptr(),
                                      out.data_ptr(), N, block,
                                      _OUT_DTYPES[dtype], stream)
    dequantize_launches += 1
    build.check_launch(code, "dequantize")
    return out
