"""Mamba2 — State Space Duality (SSD) block, chunked parallel form + O(1)
recurrent decode (arXiv:2405.21060), the reference's ``repro/models/
mamba.py`` in torch.

Discretization: h_t = exp(dt_t·A) h_{t-1} + dt_t B_t x_t ;  y_t = C_t h_t + D x_t
with scalar A per head (A = -exp(a_log) < 0).

The chunked dual form splits T into chunks of length Q (right-padded with
``dt = 0`` steps, which leave the state unchanged): within a chunk the
contribution is an attention-like (Q, Q) contraction with a causal decay
mask, computed for every chunk at once; across chunks a (B, H, N, P) state
is carried by a short loop over the chunks.  The grouped B and C (G groups)
serve ``H / G`` heads each, as the reference's ``jnp.repeat`` over heads.

One departure, in the gradient only: the reference takes the intra-chunk
decay as ``where(causal, exp(diff), 0)``.  Above the diagonal ``diff`` is
positive and grows with the chunk; at a published chunk of 256 ``exp(diff)``
overflows to ``inf``, the forward masks it to 0, and the gradient is ``0 ·
inf = NaN``.  Here the mask comes before the exponential, ``exp(where(causal,
diff, -inf))``: the same forward values, a finite gradient.

Decode is the exact recurrence on the (B, H, N, P) state plus a width-4
causal conv tail — no KV cache.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .common import rms_norm, spec


def mamba_specs(d_model: int, n_heads: int, head_dim: int, d_state: int,
                n_groups: int = 1, conv_width: int = 4,
                dtype: torch.dtype = torch.bfloat16) -> Dict[str, Any]:
    d_inner = n_heads * head_dim
    gn = n_groups * d_state
    return {
        "w_z": spec((d_model, d_inner), ("embed", "heads_mlp"), dtype=dtype),
        "w_x": spec((d_model, d_inner), ("embed", "heads_mlp"), dtype=dtype),
        "w_b": spec((d_model, gn), ("embed", None), dtype=dtype),
        "w_c": spec((d_model, gn), ("embed", None), dtype=dtype),
        "w_dt": spec((d_model, n_heads), ("embed", None), dtype=dtype),
        "conv_x": spec((conv_width, d_inner), (None, "heads_mlp"), dtype=dtype,
                       init="normal", scale=0.5),
        "conv_b": spec((conv_width, gn), (None, None), dtype=dtype, scale=0.5),
        "conv_c": spec((conv_width, gn), (None, None), dtype=dtype, scale=0.5),
        "a_log": spec((n_heads,), (None,), dtype=torch.float32, init="zeros"),
        "dt_bias": spec((n_heads,), (None,), dtype=torch.float32, init="zeros"),
        "d_skip": spec((n_heads,), (None,), dtype=torch.float32, init="ones"),
        "norm": spec((d_inner,), ("heads_mlp",), dtype=dtype, init="ones"),
        "w_out": spec((d_inner, d_model), ("heads_mlp", "embed"), dtype=dtype),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 tail: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv: x (B, T, C), w (W, C).  `tail` (B, W-1, C)
    prepends decode/prefill-continuation context.  The taps are summed in
    the reference's order, starting from 0."""
    W = w.shape[0]
    if tail is None:
        tail = x.new_zeros((x.shape[0], W - 1, x.shape[2]))
    xp = torch.cat([tail, x], dim=1)
    y = sum(xp[:, i:i + x.shape[1], :] * w[i] for i in range(W))
    return F.silu(y)


class MambaState(NamedTuple):
    ssm: torch.Tensor        # (B, H, N, P) recurrent state
    conv_x: torch.Tensor     # (B, W-1, d_inner) conv tails
    conv_b: torch.Tensor     # (B, W-1, G*N)
    conv_c: torch.Tensor     # (B, W-1, G*N)


def init_state(batch: int, n_heads: int, head_dim: int, d_state: int,
               n_groups: int, conv_width: int = 4,
               dtype: torch.dtype = torch.float32,
               device: Optional[torch.device] = None) -> MambaState:
    def z(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)
    return MambaState(
        ssm=z(batch, n_heads, d_state, head_dim),
        conv_x=z(batch, conv_width - 1, n_heads * head_dim),
        conv_b=z(batch, conv_width - 1, n_groups * d_state),
        conv_c=z(batch, conv_width - 1, n_groups * d_state))


def mamba_block(p: Dict[str, Any], x: torch.Tensor, *, n_heads: int,
                head_dim: int, d_state: int, n_groups: int = 1,
                chunk: int = 256, norm_eps: float = 1e-6,
                return_state: bool = False):
    """Chunked SSD forward for train/prefill.  x: (B, T, D).
    With ``return_state`` also returns the MambaState for decode handoff.

    Where a gradient is wanted the SSD core (:func:`_ssd`) is checkpointed:
    its f32 (Q, Q) intra-chunk tensors, about two thirds of what the layer
    would keep for the backward at mamba2-1.3b's width, are recomputed
    there instead (the same values and gradient)."""
    B, T, D = x.shape
    z = x @ p["w_z"]                                            # (B,T,HP)
    xt, bt, ct = x @ p["w_x"], x @ p["w_b"], x @ p["w_c"]
    xs = _causal_conv(xt, p["conv_x"])
    bs = _causal_conv(bt, p["conv_b"])
    cs = _causal_conv(ct, p["conv_c"])
    dt = F.softplus((x @ p["w_dt"]).to(torch.float32) + p["dt_bias"])
    args = (xs, bs, cs, dt, p["a_log"], p["d_skip"], n_heads, head_dim,
            d_state, n_groups, chunk)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args[:6]):
        y, h = checkpoint(_ssd, *args, use_reentrant=False)
    else:
        y, h = _ssd(*args)
    y = y.to(x.dtype) * F.silu(z)
    y = rms_norm(y, p["norm"], norm_eps)
    out = y @ p["w_out"]
    if not return_state:
        return out
    W = p["conv_x"].shape[0]
    state = MambaState(ssm=h, conv_x=xt[:, T - (W - 1):, :],
                       conv_b=bt[:, T - (W - 1):, :],
                       conv_c=ct[:, T - (W - 1):, :])
    return out, state


def _ssd(xs: torch.Tensor, bs: torch.Tensor, cs: torch.Tensor,
         dt: torch.Tensor, a_log: torch.Tensor, d_skip: torch.Tensor,
         H: int, P: int, N: int, G: int, chunk: int
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked scan: conv outputs xs (B, T, H·P), bs / cs (B, T, G·N)
    and dt (B, T, H) -> y (B, T, H·P) in f32 (the ``d_skip`` term
    included) and the final state (B, H, N, P)."""
    B, T, _ = xs.shape
    rep = H // G
    Q = min(chunk, T)
    T_orig = T
    if T % Q:                     # right-pad to a chunk multiple; sliced off.
        # padded steps carry dt=0 -> log-decay 0 (state unchanged) and zero
        # additive term, so even the returned state stays exact.
        pad = Q - T % Q
        xs, bs, cs, dt = (F.pad(v, (0, 0, 0, pad)) for v in (xs, bs, cs, dt))
        T = T + pad
    nc = T // Q
    xc = xs.reshape(B, nc, Q, H, P).to(torch.float32)
    bc = bs.reshape(B, nc, Q, G, N).to(torch.float32)
    cc = cs.reshape(B, nc, Q, G, N).to(torch.float32)
    dtc = dt.reshape(B, nc, Q, H)
    a = -torch.exp(a_log)                                       # (H,)
    lcum = torch.cumsum(dtc * a, dim=2)                         # (B,nc,Q,H)
    # heads split as (G, rep): head g·rep + r reads group g's B and C (the
    # reference's jnp.repeat over heads); B and C are never expanded to
    # heads: a group's heads ride in the columns of one product
    lt = lcum.transpose(2, 3)                                   # (B,nc,H,Q)
    bg = bc.permute(0, 1, 3, 2, 4)                              # (B,nc,G,Q,N)
    cg = cc.permute(0, 1, 3, 2, 4)
    dtx = dtc[..., None] * xc                                   # (B,nc,Q,H,P)

    def cols(t):      # (B,nc,X,H,P) -> (B,nc,G,X,rep·P)
        return t.reshape(B, nc, t.shape[2], G, rep * P).transpose(2, 3)

    def heads(t):     # (B,nc,G,X,rep·P) -> (B,nc,X,H,P)
        return t.transpose(2, 3).reshape(B, t.shape[1], t.shape[3], H, P)

    # intra-chunk: decay(t, s) = exp(lcum_t - lcum_s) for s <= t, else 0;
    # masked before the exponential (finite gradient)
    diff = lt[..., :, None] - lt[..., None, :]                  # (B,nc,H,Qt,Qs)
    causal = torch.ones((Q, Q), dtype=torch.bool, device=xs.device).tril()
    decay = torch.exp(diff.masked_fill(~causal, float("-inf")))
    cb = cg @ bg.transpose(-1, -2)                              # (B,nc,G,Qt,Qs)
    w_qs = cb[:, :, :, None] * decay.reshape(B, nc, G, rep, Q, Q)
    y_intra = (w_qs.reshape(B, nc, H, Q, Q)
               @ dtx.transpose(2, 3)).transpose(2, 3)           # (B,nc,Q,H,P)

    # each chunk's own contribution to the state at its end, then the
    # carried state: h_c = exp(lcum_Q) h_{c-1} + contribution_c
    tail = torch.exp(lcum[:, :, -1:, :] - lcum)                 # (B,nc,Q,H)
    contrib = bg.transpose(-1, -2) @ cols(tail[..., None] * dtx)  # (..,N,rep·P)
    chunk_decay = torch.exp(lcum[:, :, -1, :])                  # (B,nc,H)
    h = torch.zeros((B, N, H, P), dtype=torch.float32, device=xs.device)
    h_prev = []
    for c in range(nc):
        h_prev.append(h)
        h = (h * chunk_decay[:, c, None, :, None]
             + heads(contrib[:, c:c + 1])[:, 0])                # (B,N,H,P)
    h_prev = torch.stack(h_prev, dim=1)                         # (B,nc,N,H,P)
    y_inter = heads(cg @ cols(h_prev)) * torch.exp(lcum)[..., None]

    y = (y_intra + y_inter).reshape(B, T, H, P)
    y = y + d_skip[None, None, :, None] * xc.reshape(B, T, H, P)
    y = y[:, :T_orig].reshape(B, T_orig, H * P)
    return y, h.transpose(1, 2).contiguous()


def mamba_decode(p: Dict[str, Any], x: torch.Tensor, state: MambaState, *,
                 n_heads: int, head_dim: int, d_state: int, n_groups: int = 1,
                 norm_eps: float = 1e-6) -> Tuple[torch.Tensor, MambaState]:
    """Exact single-token recurrence.  x: (B, 1, D).  Returns the output and
    the new state (new tensors; the caller decides where they live)."""
    B, _, D = x.shape
    H, P, N, G = n_heads, head_dim, d_state, n_groups
    rep = H // G

    z = x @ p["w_z"]
    xt, bt, ct = x @ p["w_x"], x @ p["w_b"], x @ p["w_c"]

    def conv1(v, w, tail):                                      # cached tails
        buf = torch.cat([tail, v], dim=1)                       # (B, W, C)
        y = torch.einsum("bwc,wc->bc", buf, w)[:, None, :]
        return F.silu(y), buf[:, 1:, :]
    xs, tx = conv1(xt, p["conv_x"], state.conv_x)
    bs, tb = conv1(bt, p["conv_b"], state.conv_b)
    cs, tc = conv1(ct, p["conv_c"], state.conv_c)

    dt = F.softplus((x @ p["w_dt"]).to(torch.float32) + p["dt_bias"])[:, 0]
    a = -torch.exp(p["a_log"])
    decay = torch.exp(dt * a)                                   # (B,H)
    xh = xs.reshape(B, H, P).to(torch.float32)
    # head g·rep + r reads group g's B and C
    bg = bs.reshape(B, G, 1, N, 1).to(torch.float32)
    cg = cs.reshape(B, G, 1, 1, N).to(torch.float32)
    h = state.ssm * decay[..., None, None] + (
        bg * (dt[..., None] * xh).reshape(B, G, rep, 1, P)).reshape(B, H, N, P)
    y = (cg @ h.reshape(B, G, rep, N, P)).reshape(B, H, P) \
        + p["d_skip"][None, :, None] * xh
    y = y.reshape(B, 1, H * P).to(x.dtype)
    y = y * F.silu(z)
    y = rms_norm(y, p["norm"], norm_eps)
    return y @ p["w_out"], MambaState(h, tx, tb, tc)
