"""Attention: chunked (flash-style) softmax attention for prefill and the
single-position attention of decode, with GQA, causal / bidirectional masks,
sliding windows and logit soft-capping (gemma2).

``chunked_attention`` is where the model meets the hand-written flash kernel
(:mod:`repro_torch.kernels.flash_attention`): a call without an attention
softcap and with ``Dv == D`` goes to the kernel's wrapper, which launches the
CUDA kernel on a card (or raises: a head_dim the kernel is not built for, a
dtype other than f32 / bf16, a failed build or launch) and runs its plain
version on the CPU; a call where some query row has no valid key is outside
the kernel's contract and refused on both devices.  Where a gradient is
wanted (grad mode on, and q, k or v requiring one) the same forward runs
through ``FlashAttentionFn``, whose backward recomputes the attention in the
plain version; otherwise the wrapper is called directly, so a forward with
no gradient (serving) is unchanged.  The two calls outside
the kernel's function — gemma2's softcap, and MLA's ``Dv != D`` (not ported
yet) — run the plain version, the reference's online softmax over KV chunks,
on either device, and count themselves in :data:`attention_plain_calls`.

``decode_attention`` is plain torch: the reference has no kernel for it.
MLA (``mla_attention``, ``mla_decode``) is not ported yet (ROADMAP 1.11).
"""
from __future__ import annotations

import math
from typing import Union

import torch

from ..kernels import flash_attention as flash
# the reference's names, kept once beside the plain version that uses them
from ..kernels.flash_attention import NEG_INF, kv_repeat
from ..kernels.flash_attention import position_mask as _mask
from .common import softcap

attention_plain_calls = 0   # chunked_attention calls outside the kernel


def reset_counts() -> None:
    global attention_plain_calls
    attention_plain_calls = 0


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: int = 0,
                      attn_softcap: float = 0.0, kv_chunk: int = 2048,
                      q_offset: int = 0) -> torch.Tensor:
    """Online-softmax attention over KV chunks.

    q: (B, Tq, H, D); k/v: (B, Tk, Hkv, D).  Returns (B, Tq, H, D).
    ``q_offset``: absolute position of q[0] (prefill continuation).
    ``kv_chunk`` shapes the plain route's loop only; the function does not
    depend on it beyond rounding.
    """
    global attention_plain_calls
    if attn_softcap == 0 and v.shape[-1] == q.shape[-1]:
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            return flash.FlashAttentionFn.apply(q, k, v, causal, window,
                                                q_offset)
        return flash.flash_attention(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset)
    attention_plain_calls += 1
    return flash.flash_attention_plain(q, k, v, causal=causal, window=window,
                                       q_offset=q_offset,
                                       attn_softcap=attn_softcap,
                                       kv_chunk=kv_chunk)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, *,
                     cache_len: Union[int, torch.Tensor], window: int = 0,
                     attn_softcap: float = 0.0) -> torch.Tensor:
    """Single-position attention against a (possibly ring) KV cache.

    q: (B, 1, H, D); k/v_cache: (B, S, Hkv, D); cache_len: an int, or a ()
    or (B,) tensor — number of valid entries.  For sliding-window caches
    (S == window) the ring layout is position-agnostic because softmax is
    permutation-invariant over keys.  GQA by a grouped contraction: the
    cache is not expanded to H heads.
    """
    B, _, H, D = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    g = H // Hkv
    scale = 1.0 / math.sqrt(D)
    qf = (q.to(torch.float32) * scale).reshape(B, Hkv, g, D)
    s = torch.einsum("bkgd,bskd->bkgs", qf, k_cache.to(torch.float32))
    if attn_softcap > 0:
        s = softcap(s, attn_softcap)
    pos = torch.arange(S, device=q.device)
    if isinstance(cache_len, torch.Tensor):
        valid = pos[None, :] < cache_len.to(q.device).reshape(-1, 1)
    else:                        # an int: no copy to the device
        valid = (pos < int(cache_len))[None, :]               # (B or 1, S)
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, v_cache.to(torch.float32))
    return out.reshape(B, 1, H, D).to(q.dtype)
