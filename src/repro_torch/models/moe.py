"""Mixture-of-Experts with top-k routing and capacity-based token dispatch,
the reference's ``repro/models/moe.py`` on one device.

Tokens go into fixed per-expert **capacity** buffers of ``cap`` slots:
a token-slot's position in its expert is the exclusive running count of the
``(tokens·K, E)`` one-hot in token-major order, and a slot at ``pos >= cap``
is dropped (its residual passes through upstream).  Routing picks the top
``K`` of the routing scores — the router logits plus ``router_bias``
(DeepSeek-V3's aux-loss-free balancing) — breaking ties toward the lower
expert index as ``jax.lax.top_k`` does (a stable descending sort; ``torch.
topk`` orders ties otherwise).  Gates are the softmax of the **un-biased**
logits at the chosen experts, renormalised, times ``routed_scale``.  A
Switch-style auxiliary load-balance loss ``E · Σ_e f_e p_e`` comes back with
the output, and DeepSeek-V3's always-active shared expert is added.

**Grouped dispatch** (the reference's ``_moe_grouped``): the ``N`` tokens
are cut into ``G`` groups of ``S = N / G`` (``auto_groups``: about 2048
tokens a group) and positions and capacity are counted within each group.
The reference's ungrouped path is the same function at ``G = 1`` (its
capacity counted over ``N``), and runs as that here.  The reference's
sharding constraints are the identity on one device and are left out; its
custom-VJP dispatch and combine become plain gathers, whose autograd
backward (a scatter-add) is the same gradient.  The expert MLPs run as one
batched product an expert over the group-major capacity buffers, and the
combine is in the activation dtype, as in the reference.  A capacity far
above the load (a factor of ``E / K``, where nothing can be dropped) would
leave most buffer rows empty: past :data:`PAD_ROWS` empty rows the buffers
are cut to the largest load, which costs one read of it to the host.  A
trace on fake tensors (``launch.dryrun``) has no load to read and keeps the
static capacity: the reference's shape, and an upper bound on the buffers a
card allocates.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import is_fake

from .common import ACTIVATIONS, _const, spec
from .ffn import gated_mlp, gated_mlp_specs


def moe_specs(d_model: int, d_ff: int, n_experts: int, n_shared: int = 0,
              dtype: torch.dtype = torch.bfloat16,
              expert_parallel: bool = True) -> Dict[str, Any]:
    """``expert_parallel=False`` labels the expert axis unshardable (``None``)
    so that the per-expert ``d_ff`` carries the tensor parallelism."""
    e_ax = "experts" if expert_parallel else None
    specs: Dict[str, Any] = {
        "router": spec((d_model, n_experts), ("embed", "experts"),
                       dtype=torch.float32, scale=0.02),
        "w_gate": spec((n_experts, d_model, d_ff), (e_ax, "embed", "moe_mlp"), dtype=dtype),
        "w_up": spec((n_experts, d_model, d_ff), (e_ax, "embed", "moe_mlp"), dtype=dtype),
        "w_down": spec((n_experts, d_ff, d_model), (e_ax, "moe_mlp", "embed"), dtype=dtype),
    }
    if n_shared > 0:
        specs["shared"] = gated_mlp_specs(d_model, d_ff * n_shared, dtype)
    return specs


# empty buffer rows above which the capacity buffers are cut to the load
PAD_ROWS = 1 << 16


def auto_groups(n_tokens: int, target_group: int = 2048,
                max_groups: int = 512) -> int:
    """Dispatch-group count: ~target_group tokens per group, divisor of N."""
    g = max(1, min(max_groups, n_tokens // target_group))
    while n_tokens % g:
        g -= 1
    return g


def top_k_lower_first(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` largest entries of the last axis, largest
    first, equal scores in ascending index order (``jax.lax.top_k``'s
    order)."""
    return torch.sort(scores, dim=-1, descending=True,
                      stable=True).indices[..., :k]


def moe_ffn(p: Dict[str, Any], x: torch.Tensor, *, top_k: int,
            capacity_factor: float = 1.25, act: str = "silu",
            router_bias: Optional[torch.Tensor] = None,
            routed_scale: float = 1.0, groups: int = 0
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, T, D) -> (y, aux_loss).  ``groups``: 0 picks
    :func:`auto_groups` of the token count; 1 is the reference's ungrouped
    path."""
    B, T, D = x.shape
    N = B * T
    if groups == 0:
        groups = auto_groups(N)
    return _moe_grouped(p, x, top_k=top_k, capacity_factor=capacity_factor,
                        act=act, router_bias=router_bias,
                        routed_scale=routed_scale, groups=groups)


def _moe_grouped(p: Dict[str, Any], x: torch.Tensor, *, top_k: int,
                 capacity_factor: float, act: str,
                 router_bias: Optional[torch.Tensor], routed_scale: float,
                 groups: int) -> Tuple[torch.Tensor, torch.Tensor]:
    B, T, D = x.shape
    E = p["router"].shape[-1]
    N, K, G = B * T, top_k, groups
    if N % G:
        raise ValueError(f"moe_ffn: {G} groups do not divide {N} tokens")
    S = N // G
    cap = max(1, int(capacity_factor * K * S / E))
    xg = x.reshape(G, S, D)
    dev = x.device

    logits = xg.to(torch.float32) @ p["router"]                # (G, S, E)
    route_scores = logits if router_bias is None else logits + router_bias
    gates_all = torch.softmax(logits, dim=-1)
    top_idx = top_k_lower_first(route_scores, K)                # (G, S, K)
    top_gate = torch.gather(gates_all, -1, top_idx)
    top_gate = top_gate / torch.clamp_min(top_gate.sum(-1, keepdim=True),
                                          1e-9)
    top_gate = top_gate * routed_scale

    # ---- aux load-balance loss (Switch-style): E * Σ_e f_e p_e
    sel_onehot = F.one_hot(top_idx, E).to(torch.float32)        # (G, S, K, E)
    f = sel_onehot.sum(dim=(0, 1, 2)) / _const(sel_onehot, N * K)
    aux = E * torch.sum(f * gates_all.mean(dim=(0, 1)))

    # ---- per-group exclusive rank of each slot within its expert
    flat_one = sel_onehot.reshape(G, S * K, E)
    pos = torch.cumsum(flat_one, dim=1) - flat_one
    pos_k = torch.gather(pos.reshape(G, S, K, E), -1,
                         top_idx[..., None])[..., 0].to(torch.int64)
    keep = pos_k < cap
    # a buffer holds cap rows an expert — or, where that would leave more
    # than PAD_ROWS rows of the (G, E, cap) buffers empty (a capacity far
    # above the load), as many as the largest kept load, read back once:
    # the same slots, the same output
    if G * E * cap - N * K > PAD_ROWS and not is_fake(pos_k):
        cap = max(1, min(cap, int(pos_k.max()) + 1))
    dest = torch.where(keep, top_idx * cap + pos_k,
                       torch.full_like(pos_k, E * cap)).reshape(G, S * K)

    # ---- dispatch: the token of every buffer slot (sentinel S: a zero row),
    # gathered expert-major, (E, G·cap) rows
    inv = torch.full((G, E * cap + 1), S * K, dtype=torch.int64, device=dev)
    inv.scatter_(1, dest, torch.arange(S * K, device=dev).expand(G, S * K))
    tok = torch.clamp_max(inv[:, :E * cap] // K, S)             # (G, E*cap)
    rows = tok + (S + 1) * torch.arange(G, device=dev)[:, None]
    rows = rows.reshape(G, E, cap).transpose(0, 1).reshape(-1)
    xg_pad = torch.cat([xg, x.new_zeros((G, 1, D))], dim=1)
    xe = xg_pad.reshape(G * (S + 1), D)[rows].reshape(E, G * cap, D)
    a = ACTIVATIONS[act]
    h = a(torch.bmm(xe, p["w_gate"])) * torch.bmm(xe, p["w_up"])
    del xe
    ye = torch.bmm(h, p["w_down"]).reshape(E * G * cap, D)
    del h

    # ---- combine: each token-slot's row of ye (dropped: a zero row), in
    # the activation dtype
    e_of, c_of = dest // cap, dest % cap
    src = e_of * (G * cap) + torch.arange(G, device=dev)[:, None] * cap + c_of
    src = torch.where(dest == E * cap, torch.full_like(src, E * G * cap), src)
    ye_pad = torch.cat([ye, ye.new_zeros((1, D))], dim=0)
    gathered = ye_pad[src.reshape(-1)].reshape(G * S, K, D)
    gates = (top_gate * keep).to(x.dtype).reshape(G * S, 1, K)
    y = torch.bmm(gates, gathered).reshape(G, S, D)

    if "shared" in p:
        y = y + gated_mlp(p["shared"], xg, act)
    return y.reshape(B, T, D), aux
