"""Flash attention for prefill: causal, sliding-window or bidirectional, GQA.

    q (B, T, H, D), k / v (B, S, Hkv, D) -> (B, T, H, D)

with query positions ``q_offset + t`` and key positions ``s``: causal masks
``rel = qpos - kpos < 0``, a window masks ``rel >= window``; masked scores are
``NEG_INF = -2**30``; the softmax is the online one in f32; the output is
``acc / max(l, 1e-30)`` in the input's dtype.

Replaces the Pallas-TPU kernel ``repro/kernels/flash_attention.py::
flash_attention`` with two CUDA C++ kernels for Hopper, one a route, chosen
by :func:`flash_route` from the dtype:

- ``"wgmma"`` (``csrc/flash_attention_wgmma.cu``), bf16: tensor cores.  A
  CTA owns a ``(b, h, 64-query tile)``: one consumer warpgroup runs
  ``wgmma`` (bf16 in, f32 accumulate) on 64-key K and V tiles that a
  producer warp loads by TMA into an ``mbarrier`` ring; P is rounded to bf16
  for the ``P·V`` product (``l`` sums it unrounded).
- ``"fma"`` (``csrc/flash_attention.cu``), f32: FMA units, a CTA a
  ``(b, h, 64-query tile)``, f32 tiles in shared memory; exact to ``2e-6``.

Both take every head_dim of :data:`HEAD_DIMS`, skip the KV tiles masked for
the whole query tile, read GQA by index (no expansion of K and V), take
ragged ``T`` and ``S`` without a padding copy and 64-bit offsets.
:func:`flash_attention_plain` beside them is the
reference's ``chunked_attention`` (the same online softmax, over KV chunks)
in plain torch ops: the CPU path, the model's route for the calls outside
the kernels' function (gemma2's softcap, ``Dv != D``), and
``chip_smoke.py``'s yardstick for both kernels on the card.

**Contract**: every query row has at least one valid key.  On the serving
path (``T == S``, ``q_offset == 0``) the diagonal always is; a call where some
row would have none (a window that ends before the keys start, ``S == 0``,
``q_offset < 0``) is refused with ``ValueError`` on both devices, since the
kernels (which skip fully masked tiles) and the reference's kernel (which
visits them) would give such a row different, meaningless values.

Bound on an H100: operations, ``4·B·H·D`` a valid (query, key) pair — at the
serve shape (``B 4, T = S = 1024, H 32, Hkv 8, D 64``, causal, bf16) 17.2
GFLOP, 17.4 µs at 989 TFLOP/s, against 42 MB (12.5 µs) of bytes.

A wrapper takes the plain version only for a tensor that lies on the CPU; for
a CUDA tensor it launches the routed kernel or raises: no route gives way to
the other or to the plain version.  Off the CPU the wrapper calls the op
``repro_torch::flash_attention`` (``torch.library``): its one (CUDA)
implementation is the routed launch, and its fake implementation (the same
contract checks, an empty output) with the FLOP formula registered beside it
lets :func:`repro_torch.launch.roofline.trace_cost` trace a model on fake
tensors and count ``4·D`` a valid pair and head, launching nothing.

**Gradient.** The kernels write their result through ``ctypes`` into a fresh
tensor: called directly on a card, the wrapper's output (the op's, on
detached inputs) carries no gradient to ``q``, ``k`` or ``v``.
:class:`FlashAttentionFn` is the differentiable form: its forward is the
wrapper (the routed kernel on a card), its backward recomputes the
attention of the saved ``q, k, v`` through :func:`flash_attention_plain`
and differentiates that.  The
reference has no backward kernel either: its models train through the
plain ``chunked_attention``.  Each backward counts itself in
:data:`backward_plain_calls`.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch
from torch.utils.flop_counter import register_flop_formula

from ..accel.kernels import build

NEG_INF = -2.0 ** 30  # large-negative in f32; avoids nan from (-inf) - (-inf)
HEAD_DIMS = (16, 32, 64, 80, 128)   # both kernels' head_dim instantiations

# kernel launches made by this module's wrapper, by route; ``launches`` is
# their sum; ``backward_plain_calls``: backwards of FlashAttentionFn (each a
# plain recompute)
launches_wgmma = 0
launches_fma = 0
launches = 0
backward_plain_calls = 0

_BF16 = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    global launches, launches_wgmma, launches_fma, backward_plain_calls
    launches = launches_wgmma = launches_fma = backward_plain_calls = 0


def flash_route(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel a CUDA call of this dtype and head_dim launches:
    ``"wgmma"`` (tensor cores) for bf16, ``"fma"`` for f32.  Raises
    ``ValueError`` for a dtype or head_dim neither kernel is built for."""
    if dtype not in _BF16:
        raise ValueError(f"flash_attention: dtype must be float32 or bfloat16 "
                         f"on the card; got {dtype}")
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {head_dim} is not one of "
                         f"the kernels' {HEAD_DIMS}")
    return "wgmma" if dtype == torch.bfloat16 else "fma"


_ENTRY = {  # route -> (library, C entry, its arguments after the pointers)
    "fma": ("flash_attention", "venn_flash_attention",
            [ctypes.c_int] * 8 + [ctypes.c_longlong, ctypes.c_float,
                                  ctypes.c_int, ctypes.c_void_p]),
    "wgmma": ("flash_attention_wgmma", "venn_flash_attention_wgmma",
              [ctypes.c_int] * 8 + [ctypes.c_longlong, ctypes.c_float,
                                    ctypes.c_void_p]),
}


def entry(route: str):
    """The C entry point of a route's kernel (building every kernel source
    at first use)."""
    lib_name, fn_name, args = _ENTRY[route]
    fn = getattr(build.load_library(lib_name), fn_name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + args
        fn.restype = ctypes.c_int
    return fn


def ensure_built() -> None:
    for route in _ENTRY:
        entry(route)


def kv_repeat(kv: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, T, Hkv, D) -> (B, T, H, D) by repeating each kv head H/Hkv times."""
    hkv = kv.shape[2]
    if hkv == n_heads:
        return kv
    return kv.repeat_interleave(n_heads // hkv, dim=2)


def position_mask(qpos: torch.Tensor, kpos: torch.Tensor, causal: bool,
                  window: int) -> torch.Tensor:
    """(Tq, Ck) validity mask from absolute positions."""
    rel = qpos[:, None] - kpos[None, :]
    m = torch.ones(rel.shape, dtype=torch.bool, device=rel.device)
    if causal:
        m &= rel >= 0
    if window > 0:
        m &= rel < window
    return m


def rows_without_key(T: int, S: int, q_offset: int, causal: bool,
                     window: int) -> bool:
    """Whether some query row of a ``(T, S)`` call has no valid key.  Row
    ``t`` sees keys ``max(0, qpos - window + 1)`` (with a window) to
    ``min(S - 1, qpos)`` (causal); the last row has the latest first key,
    the first row the earliest last one."""
    if T == 0:
        return False
    if S == 0 or q_offset < 0:
        return True
    first = q_offset + T - window if window > 0 else 0
    last = min(S - 1, q_offset) if causal else S - 1
    return first > S - 1 or last < 0


def _check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape \
            or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3] \
            or k.shape[2] == 0 or q.shape[2] % k.shape[2]:
        raise ValueError(
            f"flash_attention: q (B, T, H, D) and k, v (B, S, Hkv, D) with "
            f"H % Hkv == 0; got {tuple(q.shape)}, {tuple(k.shape)}, "
            f"{tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"flash_attention: q, k, v differ in dtype: "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int = 0,
                          q_offset: int = 0, attn_softcap: float = 0.0,
                          kv_chunk: int = 2048) -> torch.Tensor:
    """The reference's ``chunked_attention`` step for step, in plain torch
    ops: keys padded to a multiple of the chunk and masked by position, one
    online-softmax update a chunk, every chunk visited, f32 throughout.
    Beyond the kernel's function it takes gemma2's ``attn_softcap`` and a
    ``v`` of another head_dim (MLA's ``Dv``)."""
    B, Tq, H, D = q.shape
    Tk, Dv = k.shape[1], v.shape[-1]
    k = kv_repeat(k, H)
    v = kv_repeat(v, H)
    scale = 1.0 / math.sqrt(D)
    nchunk = max(1, math.ceil(Tk / kv_chunk))
    c = Tk // nchunk if Tk % nchunk == 0 else kv_chunk
    dev = q.device
    if attn_softcap > 0:   # cap * tanh(s / cap): a true division on any device
        cap = torch.full((), attn_softcap, dtype=torch.float32, device=dev)
    qpos = q_offset + torch.arange(Tq, device=dev)
    qf = q.to(torch.float32) * scale
    m = torch.full((B, H, Tq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, H, Tq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, H, Tq, Dv), dtype=torch.float32, device=dev)
    for idx in range((Tk + c - 1) // c):
        kb = k[:, idx * c:(idx + 1) * c].to(torch.float32)
        vb = v[:, idx * c:(idx + 1) * c].to(torch.float32)
        pad = c - kb.shape[1]
        if pad:      # the padded keys: zeros, masked by position below
            kb = torch.cat([kb, kb.new_zeros((B, pad, H, D))], dim=1)
            vb = torch.cat([vb, vb.new_zeros((B, pad, H, Dv))], dim=1)
        kpos = idx * c + torch.arange(c, device=dev)
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kb)
        if attn_softcap > 0:
            s = cap * torch.tanh(s / cap)
        valid = position_mask(qpos, kpos, causal, window) & (kpos < Tk)[None]
        s = torch.where(valid[None, None], s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vb)
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.permute(0, 2, 1, 3).to(q.dtype)               # (B, Tq, H, Dv)


def _check_contract(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool, window: int, q_offset: int) -> None:
    _check_shapes(q, k, v)
    T, S = q.shape[1], k.shape[1]
    if rows_without_key(T, S, q_offset, causal, window):
        raise ValueError(
            f"flash_attention: some query row has no valid key (T={T}, S={S}, "
            f"q_offset={q_offset}, causal={causal}, window={window}); the "
            f"kernel's contract needs at least one")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, q_offset: int = 0
                    ) -> torch.Tensor:
    """``q`` ``(B, T, H, D)``, ``k`` / ``v`` ``(B, S, Hkv, D)`` ->
    ``(B, T, H, D)`` in ``q``'s dtype (f32 or bf16 on the card).  On the CPU
    the plain version (differentiable, as it always was there); on any
    other device the op ``repro_torch::flash_attention``, whose output
    carries no gradient (:class:`FlashAttentionFn` is the differentiable
    form)."""
    if q.device.type == "cpu":
        _check_contract(q, k, v, causal, window, q_offset)
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset)
    return flash_attention_op(q.detach(), k.detach(), v.detach(), causal,
                              window, q_offset)


def _flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool, window: int, q_offset: int
                          ) -> torch.Tensor:
    """The op's CUDA implementation: the checks and the routed launch."""
    _check_contract(q, k, v, causal, window, q_offset)
    dev = q.device
    route = flash_route(q.dtype, q.shape[3])
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != dev or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(
                f"flash_attention: {name} must be contiguous, 16-byte aligned "
                f"and on {dev}; got {t.device}, contiguous="
                f"{t.is_contiguous()}, data_ptr % 16 = {t.data_ptr() % 16}")
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        launch(route, q, k, v, out, causal=causal, window=window,
               q_offset=q_offset, stream=stream)
    return out


# The wrapper's op, so that a trace on fake tensors (``launch.roofline``)
# can run it: a card launches the routed kernel, a fake (or ``meta``) tensor
# gets an empty output of q's shape after the same contract checks, and a
# FLOP counter counts 4·D a valid pair.  It has no CPU implementation: the
# wrapper takes the plain version there before it reaches the op.
flash_attention_op = torch.library.custom_op(
    "repro_torch::flash_attention", _flash_attention_cuda, mutates_args=(),
    device_types="cuda")


@flash_attention_op.register_fake
def _flash_attention_fake(q, k, v, causal, window, q_offset):
    _check_contract(q, k, v, causal, window, q_offset)
    return torch.empty_like(q)


def valid_pairs(T: int, S: int, causal: bool, window: int,
                q_offset: int) -> int:
    """(query, key) pairs the mask lets through, per batch row and head."""
    qpos = q_offset + np.arange(T)
    last = np.minimum(S - 1, qpos) if causal else np.full(T, S - 1)
    first = np.maximum(0, qpos - window + 1) if window > 0 else np.zeros(T)
    return int(np.clip(last - first + 1, 0, None).sum())


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _flash_attention_flops(q_shape, k_shape, v_shape, causal, window,
                           q_offset, *args, out_shape=None, **kwargs) -> int:
    """``4·D`` a valid pair and head: ``Q·Kᵀ`` and ``P·V``, two FLOPs a
    multiply-add each."""
    B, T, H, D = q_shape
    return 4 * D * B * H * valid_pairs(T, k_shape[1], causal, window,
                                       q_offset)


def launch(route: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           out: torch.Tensor, *, causal: bool, window: int, q_offset: int,
           stream: int) -> None:
    """Launch ``route``'s kernel on checked tensors, count the launch under
    its route, and raise ``KernelError`` if the launch was refused."""
    global launches, launches_wgmma, launches_fma
    B, T, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, T, S, H, Hkv, D, int(causal), int(window), int(q_offset),
            1.0 / math.sqrt(D)]
    if route == "fma":
        code = entry(route)(*args, _BF16[q.dtype], stream)
        launches_fma += 1
    else:
        code = entry(route)(*args, stream)
        launches_wgmma += 1
    launches = launches_wgmma + launches_fma
    build.check_launch(code, f"flash_attention ({route})")


class FlashAttentionFn(torch.autograd.Function):
    """:func:`flash_attention` with a gradient: ``apply(q, k, v, causal,
    window, q_offset)``.  Forward: the wrapper (the routed kernel on a CUDA
    tensor, the plain version on the CPU).  Backward: autograd through
    :func:`flash_attention_plain` recomputed on the saved inputs."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset):
        ctx.save_for_backward(q, k, v)
        ctx.mask = (causal, window, q_offset)
        return flash_attention(q, k, v, causal=causal, window=window,
                               q_offset=q_offset)

    @staticmethod
    def backward(ctx, grad_out):
        global backward_plain_calls
        causal, window, q_offset = ctx.mask
        inputs = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = flash_attention_plain(*inputs, causal=causal, window=window,
                                        q_offset=q_offset)
        grads = torch.autograd.grad(out, inputs, grad_out)
        backward_plain_calls += 1
        return (*(g if need else None
                  for g, need in zip(grads, ctx.needs_input_grad)),
                None, None, None)
