"""Public wrappers of the federated-learning kernels, with the reference's
signatures (``repro/kernels/ops.py``) minus ``interpret``.

The tiling arguments (``block_n``, ``block_k``, ``rows_per_tile``) shaped
the TPU kernels' grids; the CUDA kernels choose their own launch shape, so
here they are accepted and checked as the reference checks them — ``N %
block == 0`` and ``rows % min(rows_per_tile, rows) == 0`` — and a call that
fails there fails here.  On a CPU tensor each runs its plain version; on a
CUDA tensor it launches its kernel or raises.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import fedavg_reduce as _fedavg
from . import quantize as _quant


def _check_tiles(name: str, n: int, block: int, rows_per_tile: int) -> None:
    if block <= 0 or n % block:
        raise ValueError(f"{name}: N = {n} is not a multiple of block {block}")
    rows = n // block
    rt = min(rows_per_tile, rows)
    if rows and (rt <= 0 or rows % rt):
        raise ValueError(f"{name}: {rows} rows do not split into tiles of "
                         f"{rt}")


def fedavg_reduce(updates: torch.Tensor, weights: torch.Tensor, *,
                  block_n: int = 2048, block_k: int = 8) -> torch.Tensor:
    """updates: (K, N); weights: (K,) -> (N,) normalized weighted mean."""
    if block_n <= 0 or block_k <= 0:
        raise ValueError(f"fedavg_reduce: block_n={block_n}, "
                         f"block_k={block_k} must be positive")
    return _fedavg.fedavg_reduce(updates, weights)


def quantize(x: torch.Tensor, *, block: int = 256, rows_per_tile: int = 64
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (N,) with N % block == 0 -> (q int8 (N,), scales f32 (N/block,))."""
    _check_tiles("quantize", x.shape[0], block, rows_per_tile)
    return _quant.quantize(x, block)


def dequantize(q: torch.Tensor, scales: torch.Tensor, *, block: int = 256,
               rows_per_tile: int = 64, dtype: torch.dtype = torch.float32
               ) -> torch.Tensor:
    _check_tiles("dequantize", q.shape[0], block, rows_per_tile)
    return _quant.dequantize(q, scales, block, dtype)
