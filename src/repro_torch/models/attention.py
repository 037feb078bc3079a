"""Attention: chunked (flash-style) softmax attention for prefill and the
single-position attention of decode, with GQA, causal / bidirectional masks,
sliding windows and logit soft-capping (gemma2), and DeepSeek-V3's
Multi-head Latent Attention (latent KV cache).

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
the kernel's function — gemma2's softcap, and MLA's ``Dv != D`` — run the
plain version, the reference's online softmax over KV chunks, on either
device, and count themselves in :data:`attention_plain_calls` (the
reference's TPU kernel has no ``Dv != D`` form either).

``decode_attention`` and MLA's absorbed-projection decode (``mla_decode``)
are plain torch: the reference has no kernel for them.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple, Union

import torch

from ..kernels import flash_attention as flash
# the reference's names, kept once beside the plain version that uses them
from ..kernels.flash_attention import NEG_INF, kv_repeat
from ..kernels.flash_attention import position_mask as _mask
from .common import apply_rope, rms_norm, softcap

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


# ----------------------------------------------------------------------- MLA

class MLAWeights(NamedTuple):
    """DeepSeek-V3 Multi-head Latent Attention projection set (a shape
    contract over one layer's ``attn`` parameters)."""
    w_dq: torch.Tensor      # (d_model, q_lora)
    q_norm: torch.Tensor    # (q_lora,)
    w_uq: torch.Tensor      # (q_lora, H * (nope + rope))
    w_dkv: torch.Tensor     # (d_model, kv_lora)
    kv_norm: torch.Tensor   # (kv_lora,)
    w_kr: torch.Tensor      # (d_model, rope)
    w_uk: torch.Tensor      # (kv_lora, H * nope)
    w_uv: torch.Tensor      # (kv_lora, H * v_dim)
    w_o: torch.Tensor       # (H * v_dim, d_model)


def mla_attention(x: torch.Tensor, w: MLAWeights, *, n_heads: int, nope: int,
                  rope_dim: int, v_dim: int, rope_theta: float,
                  q_offset: int = 0, kv_chunk: int = 2048,
                  norm_eps: float = 1e-6
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """MLA for train/prefill.  Returns (output, latent_cache) where the cache
    is the concatenated (kv_latent, k_rope) of shape (B, T, kv_lora + rope).
    The attention has ``D = nope + rope`` and ``Dv = v_dim``: the plain
    route of :func:`chunked_attention`."""
    B, T, _ = x.shape
    H = n_heads
    pos = (q_offset + torch.arange(T, device=x.device))[None, :]

    cq = rms_norm(x @ w.w_dq, w.q_norm, norm_eps)
    q = (cq @ w.w_uq).reshape(B, T, H, nope + rope_dim)
    qn, qr = q[..., :nope], q[..., nope:]
    qr = apply_rope(qr, pos, rope_theta)

    latent = rms_norm(x @ w.w_dkv, w.kv_norm, norm_eps)        # (B, T, r)
    kr = apply_rope((x @ w.w_kr).reshape(B, T, 1, rope_dim), pos, rope_theta)
    kn = (latent @ w.w_uk).reshape(B, T, H, nope)
    v = (latent @ w.w_uv).reshape(B, T, H, v_dim)

    q_full = torch.cat([qn, qr], dim=-1)
    k_full = torch.cat([kn, kr.expand(B, T, H, rope_dim)], dim=-1)
    out = chunked_attention(q_full, k_full, v, causal=True, kv_chunk=kv_chunk,
                            q_offset=q_offset)
    y = out.reshape(B, T, H * v_dim) @ w.w_o
    cache = torch.cat([latent, kr[:, :, 0, :]], dim=-1)
    return y, cache


def mla_decode(x: torch.Tensor, w: MLAWeights, cache: torch.Tensor, *,
               cache_len: int, n_heads: int, nope: int, rope_dim: int,
               v_dim: int, rope_theta: float, norm_eps: float = 1e-6
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Absorbed-projection MLA decode: score/value computed directly against
    the latent cache (no per-head K/V materialises).  x: (B, 1, d); cache:
    (B, S, r + rope); cache_len: int, the position of this token.  The new
    entry (latent, k_rope) is written into ``cache`` at ``cache_len`` in
    place — for finite values what the reference's one-hot blend
    ``_place_entry`` computes — and positions ``<= cache_len`` attend.
    Returns (y, cache)."""
    B = x.shape[0]
    H = n_heads
    S = cache.shape[1]
    r = cache.shape[-1] - rope_dim
    if not 0 <= cache_len < S:
        raise ValueError(f"mla_decode: position {cache_len} is outside the "
                         f"cache's {S} slots")
    scale = 1.0 / math.sqrt(nope + rope_dim)
    pos = torch.full((1, 1), cache_len, device=x.device)

    cq = rms_norm(x @ w.w_dq, w.q_norm, norm_eps)
    q = (cq @ w.w_uq).reshape(B, 1, H, nope + rope_dim)
    qn, qr = q[..., :nope], q[..., nope:]
    qr = apply_rope(qr, pos, rope_theta)

    latent = rms_norm(x @ w.w_dkv, w.kv_norm, norm_eps)        # (B, 1, r)
    kr_new = apply_rope((x @ w.w_kr).reshape(B, 1, 1, rope_dim), pos,
                        rope_theta)[:, 0, 0, :]                # (B, rope)
    cache[:, cache_len, :r] = latent[:, 0, :]
    cache[:, cache_len, r:] = kr_new

    lat_c = cache[..., :r].to(torch.float32)
    kr_c = cache[..., r:].to(torch.float32)
    # absorb W_uk into q:  q_abs (B, H, r)
    w_uk = w.w_uk.reshape(r, H, nope)
    q_abs = torch.einsum("bhn,rhn->bhr", qn[:, 0], w_uk)
    s = torch.einsum("bhr,bsr->bhs", q_abs.to(torch.float32), lat_c)
    s = s + torch.einsum("bhn,bsn->bhs", qr[:, 0].to(torch.float32), kr_c)
    valid = torch.arange(S, device=x.device) <= cache_len
    s = torch.where(valid, s * scale, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    ctx = torch.einsum("bhs,bsr->bhr", p, lat_c)
    w_uv = w.w_uv.reshape(r, H, v_dim)
    o = torch.einsum("bhr,rhv->bhv", ctx.to(x.dtype), w_uv)
    y = o.reshape(B, 1, H * v_dim) @ w.w_o
    return y, cache
