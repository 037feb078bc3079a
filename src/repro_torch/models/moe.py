"""Mixture-of-Experts parameter declarations (routed experts on the
"experts" logical axis, optional shared expert).  Routing and dispatch come
with the model slice."""
from __future__ import annotations

from typing import Any, Dict

import torch

from .common import spec
from .ffn import gated_mlp_specs


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
