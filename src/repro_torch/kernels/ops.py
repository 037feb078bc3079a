"""Public wrappers of the kernels, with the reference's signatures
(``repro/kernels/ops.py``) minus ``interpret``.

The tiling arguments (``block_q``, ``block_k``, ``block_n``,
``rows_per_tile``) shaped the TPU kernels' grids; the CUDA kernels choose
their own launch shape, so here they are accepted and checked as the
reference checks them — ``T % min(block_q, T) == 0``, ``N % block == 0``,
``rows % min(rows_per_tile, rows) == 0`` — and a call that fails there fails
here.  On a CPU tensor each runs its plain version; on a CUDA tensor it
launches its kernel or raises.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import fedavg_reduce as _fedavg
from . import flash_attention as _flash
from . import quantize as _quant


def _check_tiles(name: str, n: int, block: int, rows_per_tile: int) -> None:
    if block <= 0 or n % block:
        raise ValueError(f"{name}: N = {n} is not a multiple of block {block}")
    rows = n // block
    rt = min(rows_per_tile, rows)
    if rows and (rt <= 0 or rows % rt):
        raise ValueError(f"{name}: {rows} rows do not split into tiles of "
                         f"{rt}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, block_q: int = 128,
                    block_k: int = 128) -> torch.Tensor:
    """q: (B, T, H, D); k/v: (B, S, Hkv, D) -> (B, T, H, D)."""
    _flash._check_shapes(q, k, v)
    T, S = q.shape[1], k.shape[1]
    bq, bk = min(block_q, T), min(block_k, S)
    if bq <= 0 or bk <= 0 or T % bq or S % bk:
        raise ValueError(f"flash_attention: T = {T} and S = {S} must be "
                         f"multiples of the blocks {bq}, {bk}")
    return _flash.flash_attention(q, k, v, causal=causal, window=window)


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
