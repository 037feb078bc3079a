"""Plain PyTorch versions of the federated-learning kernels — the
definitions.

Each is the function with no tiling or layout: the CPU tests hold it against
the JAX reference's oracles (``repro/kernels/ref.py``) and Pallas kernels,
and ``chip_smoke.py`` holds each CUDA kernel against it on the card.  On the
card they run nowhere else on the path (the one exception is
``aggregate_deltas``'s own ``min_kernel_size`` rule).  Flash attention's
oracle is here too; the plain version ``chip_smoke.py`` times beside its
kernel, the same online softmax, is in :mod:`.flash_attention`.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B, T, H, D); k/v: (B, S, Hkv, D).  GQA by head repetition; a
    ``-inf`` mask, a softmax, fully masked rows (NaN) set to 0."""
    B, T, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    if Hkv != H:
        k = k.repeat_interleave(H // Hkv, dim=2)
        v = v.repeat_interleave(H // Hkv, dim=2)
    s = torch.einsum("bthd,bshd->bhts", q.to(torch.float32),
                     k.to(torch.float32))
    s = s / torch.full((), math.sqrt(D), dtype=torch.float32,
                       device=s.device)
    rel = (torch.arange(T, device=q.device)[:, None]
           - torch.arange(S, device=q.device)[None, :])
    mask = torch.ones((T, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= rel >= 0
    if window > 0:
        mask &= rel < window
    s = torch.where(mask[None, None], s, torch.full_like(s, -math.inf))
    p = torch.softmax(s, dim=-1)
    p = torch.where(torch.isnan(p), torch.zeros_like(p), p)
    o = torch.einsum("bhts,bshd->bthd", p, v.to(torch.float32))
    return o.to(q.dtype)


def normalized_weights(weights: torch.Tensor) -> torch.Tensor:
    """``w / max(sum(w), 1e-12)`` in f32 — once, outside any kernel."""
    w = weights.to(torch.float32)
    return w / torch.clamp_min(w.sum(), 1e-12)


def fedavg_reduce_ref(updates: torch.Tensor, weights: torch.Tensor
                      ) -> torch.Tensor:
    """``(K, N)`` updates, ``(K,)`` weights -> ``(N,)``
    ``Σ_k (w_k / max(Σw, 1e-12)) · u_k``, accumulated in f32 in client order
    (a rounded product, then a rounded sum, for ``k = 0..K-1``), returned in
    the updates' dtype."""
    w = normalized_weights(weights)
    K, N = updates.shape
    acc = torch.zeros(N, dtype=torch.float32, device=updates.device)
    for k in range(K):
        acc = acc + w[k] * updates[k].to(torch.float32)
    return acc.to(updates.dtype)


def quantize_ref(x: torch.Tensor, block: int = 256
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-block int8 quantisation.  ``x`` ``(N,)`` with ``N %
    block == 0`` -> ``(q int8 (N,), scales f32 (N/block,))``:
    ``scale = max(absmax / 127, 1e-12)``, ``q = clip(round_half_even(x /
    scale), -127, 127)``.  A block that holds a NaN has scale NaN (the max
    and the clamp propagate it) and codes 0: a NaN quotient is code 0,
    explicitly, since a cast of NaN to int8 is undefined.  Both divisions
    are true IEEE divisions, as in the reference's oracle."""
    xb = x.to(torch.float32).reshape(-1, block)
    absmax = xb.abs().amax(dim=1)
    # a tensor divisor: torch's CUDA division by a Python scalar multiplies
    # by its reciprocal, which is one ulp off a true division in some blocks
    scale = torch.clamp_min(absmax / torch.full_like(absmax, 127.0), 1e-12)
    q = torch.clamp(torch.round(xb / scale[:, None]), -127, 127)
    q = torch.where(torch.isnan(q), torch.zeros_like(q), q)
    return q.to(torch.int8).reshape(-1), scale


def dequantize_ref(q: torch.Tensor, scales: torch.Tensor, block: int = 256,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``q[i] · scales[i // block]`` in f32, cast to ``dtype``."""
    xb = q.to(torch.float32).reshape(-1, block) * scales[:, None]
    return xb.reshape(-1).to(dtype)
