"""Parameter declarations: specs with logical axis names, and their
materialisation into tensors.

Parameters are declared as :class:`ParamSpec` trees carrying **logical axis
names** per dimension ("embed", "heads", "mlp", "experts", ...), as in the
JAX reference (``repro/models/common.py``).  :func:`materialize` turns a spec
tree into real tensors on a device from a ``torch.Generator``, with the
reference's init kinds and std rule; the numbers differ from
``jax.random``'s, the distributions do not.

Norms, RoPE, ``softcap`` and the activations come with the model forwards.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Any, Callable, Optional, Tuple

import torch

from .. import tree as tree_util

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}


@dataclass(frozen=True)
class ParamSpec:
    """Declaration of one parameter tensor."""

    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]          # logical axis name per dim
    dtype: torch.dtype = torch.bfloat16
    init: str = "normal"                     # normal | zeros | ones
    scale: Optional[float] = None            # stddev; default fan-in

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"ParamSpec: shape {self.shape} and axes "
                             f"{self.axes} differ in rank")

    def stacked(self, n: int, axis_name: str = "layers") -> "ParamSpec":
        return replace(self, shape=(n, *self.shape), axes=(axis_name, *self.axes))


def spec(shape: Tuple[int, ...], axes: Tuple[Optional[str], ...], *,
         dtype: torch.dtype = torch.bfloat16, init: str = "normal",
         scale: Optional[float] = None) -> ParamSpec:
    return ParamSpec(tuple(shape), tuple(axes), dtype, init, scale)


# ----------------------------------------------------------------- tree ops

def is_spec(x: Any) -> bool:
    return isinstance(x, ParamSpec)


def tree_map_specs(fn: Callable[[ParamSpec], Any], tree: Any) -> Any:
    return tree_util.map(fn, tree, is_leaf=is_spec)


def stack_specs(tree: Any, n: int) -> Any:
    """Prepend a scanned 'layers' dimension to every spec in the tree."""
    return tree_map_specs(lambda s: s.stacked(n), tree)


def materialize(tree: Any, generator: torch.Generator,
                device: torch.device) -> Any:
    """Real parameters on ``device``: zeros, ones, or f32 normals times the
    spec's std (``scale``, else ``1/sqrt(fan_in)`` with ``fan_in =
    shape[-2]``) cast to the spec's dtype.  One draw per normal leaf, in
    tree order, from ``generator`` (which must live on ``device``)."""
    def one(s: ParamSpec) -> torch.Tensor:
        if s.init == "zeros":
            return torch.zeros(s.shape, dtype=s.dtype, device=device)
        if s.init == "ones":
            return torch.ones(s.shape, dtype=s.dtype, device=device)
        fan_in = s.shape[-2] if len(s.shape) >= 2 else max(s.shape[-1], 1)
        std = s.scale if s.scale is not None else 1.0 / math.sqrt(fan_in)
        x = torch.randn(s.shape, generator=generator, dtype=torch.float32,
                        device=device)
        return x.mul_(std).to(s.dtype)
    return tree_map_specs(one, tree)


def count_params(tree: Any) -> int:
    return sum(math.prod(s.shape)
               for s in tree_util.leaves(tree, is_leaf=is_spec)
               if isinstance(s, ParamSpec))
