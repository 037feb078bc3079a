"""Optimizers as pure transforms of parameter trees (dicts, lists, tuples of
tensors; :mod:`repro_torch.tree`).

AdamW keeps f32 first and second moments whatever the parameter dtype (bf16
weights + f32 optimizer state); SGD with momentum is the FL client's local
optimizer.  Both expose ``init`` / ``update`` and return new trees, as the
JAX reference (``repro/train/optimizer.py``) does.

Numbers follow JAX's typing: the bias corrections are f32 tensors from an
int32 ``step`` (``b1 ** step`` in f32, not a Python double), and Python
scalars enter the moment and parameter updates as f32, as JAX's weak types
do.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple, Tuple

import torch

from .. import tree as tree_util


class AdamWState(NamedTuple):
    step: torch.Tensor       # () int32
    mu: Any                  # f32 tree
    nu: Any                  # f32 tree


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32)


def _zeros_f32(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


@dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0

    def init(self, params: Any) -> AdamWState:
        leaves = tree_util.leaves(params)
        dev = leaves[0].device if leaves else torch.device("cpu")
        return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                          mu=tree_util.map(_zeros_f32, params),
                          nu=tree_util.map(_zeros_f32, params))

    def abstract_state(self, abstract_params: Any) -> AdamWState:
        """The state's shapes and dtypes as ``meta`` tensors, from ``meta``
        (or any) parameters: no storage is allocated."""
        def f32(p):
            return torch.empty(p.shape, dtype=torch.float32, device="meta")
        return AdamWState(step=torch.empty((), dtype=torch.int32,
                                           device="meta"),
                          mu=tree_util.map(f32, abstract_params),
                          nu=tree_util.map(f32, abstract_params))

    def update(self, grads: Any, state: AdamWState, params: Any
               ) -> Tuple[Any, AdamWState]:
        g32 = tree_util.map(_f32, grads)
        if self.grad_clip > 0:
            gn = global_norm(g32)
            clip = torch.full_like(gn, self.grad_clip)    # a true division
            scale = torch.clamp_max(clip / (gn + 1e-9), 1.0)
            g32 = tree_util.map(lambda g: g * scale, g32)
        step = state.step + 1
        stepf = step.to(torch.float32)
        c1 = 1.0 - torch.pow(torch.tensor(self.b1, dtype=torch.float32,
                                          device=step.device), stepf)
        c2 = 1.0 - torch.pow(torch.tensor(self.b2, dtype=torch.float32,
                                          device=step.device), stepf)
        mu = tree_util.map(lambda m, g: self.b1 * m + (1 - self.b1) * g,
                           state.mu, g32)
        nu = tree_util.map(lambda v, g: self.b2 * v + (1 - self.b2) * g * g,
                           state.nu, g32)

        def upd(p, m, v):
            mh, vh = m / c1, v / c2
            delta = mh / (torch.sqrt(vh) + self.eps) \
                + self.weight_decay * _f32(p)
            return (_f32(p) - self.lr * delta).to(p.dtype)

        new_params = tree_util.map(upd, params, mu, nu)
        return new_params, AdamWState(step, mu, nu)


@dataclass(frozen=True)
class SGD:
    lr: float = 0.01
    momentum: float = 0.0

    def init(self, params: Any) -> Any:
        if self.momentum == 0.0:
            return None
        return tree_util.map(_zeros_f32, params)

    def update(self, grads: Any, state: Any, params: Any) -> Tuple[Any, Any]:
        g32 = tree_util.map(_f32, grads)
        if self.momentum == 0.0:
            new = tree_util.map(
                lambda p, g: (_f32(p) - self.lr * g).to(p.dtype), params, g32)
            return new, None
        vel = tree_util.map(lambda v, g: self.momentum * v + g, state, g32)
        new = tree_util.map(
            lambda p, v: (_f32(p) - self.lr * v).to(p.dtype), params, vel)
        return new, vel


def global_norm(tree: Any) -> torch.Tensor:
    """``sqrt(Σ_leaves Σ x²)`` in f32, the leaves summed in ``jax.tree``
    order."""
    total = None
    for x in tree_util.leaves(tree):
        s = torch.sum(torch.square(_f32(x)))
        total = s if total is None else total + s
    return torch.sqrt(total) if total is not None else torch.zeros(())
