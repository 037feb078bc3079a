"""Parameter declarations: specs with logical axis names, and their
materialisation into tensors.

Parameters are declared as :class:`ParamSpec` trees carrying **logical axis
names** per dimension ("embed", "heads", "mlp", "experts", ...), as in the
JAX reference (``repro/models/common.py``).  :func:`materialize` turns a spec
tree into real tensors on a device from a ``torch.Generator``, with the
reference's init kinds and std rule; the numbers differ from
``jax.random``'s, the distributions do not.  :func:`abstract_params` gives
the same tree as ``meta`` tensors, the counterpart of the reference's
``ShapeDtypeStruct`` objects.

The layers the forwards share follow: RMSNorm and LayerNorm with f32
accumulation, RoPE (partial rotary too), gemma-2's ``softcap`` and the
activations.  A plain path that divides by a Python scalar on the card gets
a reciprocal multiply from torch, one ulp off a true division in places; the
divisions here are by tensors.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

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


def abstract_params(tree: Any) -> Any:
    """The spec tree as ``meta`` tensors: shapes and dtypes, no storage."""
    return tree_map_specs(
        lambda s: torch.empty(s.shape, dtype=s.dtype, device="meta"), tree)


def count_params(tree: Any) -> int:
    return sum(math.prod(s.shape)
               for s in tree_util.leaves(tree, is_leaf=is_spec)
               if isinstance(s, ParamSpec))


# -------------------------------------------------------------------- layers

def _const(x: torch.Tensor, value: float,
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``value`` as a 0-d tensor on ``x``'s device: a divisor that torch
    divides by truly on the card (a Python scalar becomes a reciprocal
    multiply there).  Made by a fill on the device, not copied from the
    host: ``torch.tensor(value, device=...)`` is a blocking copy that
    waits for the device's queue, once a layer."""
    return torch.full((), value, dtype=dtype, device=x.device)


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6,
             plus_one: bool = False) -> torch.Tensor:
    """RMSNorm in fp32 accumulation (gemma-style optional (1+g) scaling)."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    g = gamma.to(torch.float32)
    y = y * (1.0 + g) if plus_one else y * g
    return y.to(x.dtype)


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * gamma.to(torch.float32)
            + beta.to(torch.float32)).to(x.dtype)


def rope_freqs(head_dim: int, theta: float,
               device: Optional[torch.device] = None) -> torch.Tensor:
    idx = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (idx / _const(idx, head_dim)))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 1e4,
               rotary_dim: Optional[int] = None) -> torch.Tensor:
    """Rotary embedding on the last dim; supports partial rotary (stablelm).

    x: (..., T, H, D) or (..., T, D); positions: broadcastable to (..., T).
    """
    d = x.shape[-1]
    rd = rotary_dim or d
    xr, xp = x[..., :rd], x[..., rd:]
    freqs = rope_freqs(rd, theta, x.device)                   # (rd/2,)
    ang = positions[..., None].to(torch.float32) * freqs      # (..., T, rd/2)
    while ang.dim() < x.dim():                                # add head dim
        ang = ang[..., None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1 = xr[..., 0::2].to(torch.float32)
    x2 = xr[..., 1::2].to(torch.float32)
    o1, o2 = x1 * cos - x2 * sin, x2 * cos + x1 * sin
    rot = torch.stack([o1, o2], dim=-1).reshape(xr.shape).to(x.dtype)
    return torch.cat([rot, xp], dim=-1) if rd < d else rot


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """Gemma-2 logit soft-capping: cap * tanh(x / cap), ``x / cap`` a true
    division (by a tensor, on any device)."""
    if cap <= 0:
        return x
    c = _const(x, cap, x.dtype)
    return c * torch.tanh(x / c)


ACTIVATIONS: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "silu": F.silu,
    # the reference's jax.nn.gelu(approximate=True)
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
}
