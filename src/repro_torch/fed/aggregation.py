"""Server-side aggregation: FedAvg and FedAdam over collected client deltas.

As in the JAX reference (``repro/fed/aggregation.py``): each parameter
leaf's ``K`` client deltas are stacked to ``(K, N)`` and reduced by the
``fedavg_reduce`` kernel — one sweep of the stack instead of ``K`` AXPYs.  A
leaf with fewer than ``min_kernel_size`` elements, or any leaf with
``use_kernel=False``, takes the plain version: that is the reference's own
rule, not a fallback; :data:`plain_leaves` counts those leaves.

The stack is a copy of all ``K`` deltas of a leaf each round, as in the
reference (``jnp.stack``); one leaf's stack lives at a time.

FedAdam (Reddi et al.) feeds the aggregated delta to a server Adam as a
pseudo-gradient.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Sequence, Tuple

import torch

from .. import tree as tree_util
from ..kernels import ops as kernel_ops
from ..kernels.ref import fedavg_reduce_ref
from ..train.optimizer import AdamW, AdamWState

plain_leaves = 0      # leaves aggregated by the plain version


def reset_counts() -> None:
    global plain_leaves
    plain_leaves = 0


def aggregate_deltas(deltas: Sequence[Any], weights: Sequence[float], *,
                     use_kernel: bool = True, min_kernel_size: int = 1024
                     ) -> Any:
    """Weighted, normalised mean of client delta trees (leaves in
    ``jax.tree`` order, each reduced on the device it lies on)."""
    global plain_leaves
    if len(deltas) != len(weights) or not deltas:
        raise ValueError(f"aggregate_deltas: {len(deltas)} deltas, "
                         f"{len(weights)} weights")
    leaves_list = [tree_util.leaves(d) for d in deltas]
    treedef = tree_util.structure(deltas[0])
    w = None
    out_leaves = []
    for i, first in enumerate(leaves_list[0]):
        if w is None or w.device != first.device:
            w = torch.tensor(weights, dtype=torch.float32, device=first.device)
        stack = torch.stack([ls[i].reshape(-1) for ls in leaves_list])
        if use_kernel and stack.shape[1] >= min_kernel_size:
            flat = kernel_ops.fedavg_reduce(stack, w)
        else:
            flat = fedavg_reduce_ref(stack, w)
            plain_leaves += 1
        del stack
        out_leaves.append(flat.reshape(first.shape))
    return tree_util.unflatten(treedef, out_leaves)


@dataclass
class FedAvg:
    """params <- params + server_lr * aggregate(deltas)."""
    server_lr: float = 1.0

    def init(self, params: Any) -> Any:
        return None

    def apply(self, params: Any, agg_delta: Any, state: Any
              ) -> Tuple[Any, Any]:
        new = tree_util.map(
            lambda p, d: (p.to(torch.float32)
                          + self.server_lr * d).to(p.dtype),
            params, agg_delta)
        return new, state


@dataclass
class FedAdam:
    """Server Adam on the aggregated delta as pseudo-gradient."""
    lr: float = 1e-2
    b1: float = 0.9
    b2: float = 0.99
    eps: float = 1e-4

    def _opt(self) -> AdamW:
        return AdamW(lr=self.lr, b1=self.b1, b2=self.b2, eps=self.eps,
                     weight_decay=0.0, grad_clip=0.0)

    def init(self, params: Any) -> AdamWState:
        return self._opt().init(params)

    def apply(self, params: Any, agg_delta: Any, state: AdamWState
              ) -> Tuple[Any, AdamWState]:
        pseudo_grad = tree_util.map(lambda d: -d, agg_delta)
        return self._opt().update(pseudo_grad, state, params)
