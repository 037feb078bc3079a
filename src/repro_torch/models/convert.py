"""Parameter trees carried across between the JAX reference and the port.

The reference hands its parameters over as NumPy arrays
(``jax.tree.map(np.asarray, params)``).  bf16 leaves then have the
``ml_dtypes.bfloat16`` dtype, which ``torch.from_numpy`` refuses, so they go
through their 16-bit patterns: ``.view(np.uint16)`` -> ``torch.int16`` ->
``.view(torch.bfloat16)``, bit for bit.  Every other dtype goes through
``torch.from_numpy`` as it is.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .. import tree as tree_util
from ..device import DeviceLike, resolve_device


def _from_numpy(a: np.ndarray, device: torch.device) -> torch.Tensor:
    # a copy: JAX hands out read-only arrays, which torch will not wrap
    a = np.array(a, order="C", copy=True)
    if a.dtype.name == "bfloat16":
        bits = torch.from_numpy(a.view(np.uint16).view(np.int16))
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_jax(tree: Any, device: DeviceLike = None) -> Any:
    """A tree of NumPy arrays (the reference's parameters) -> the same tree
    of tensors on ``device`` (``None``: ``cuda:0``), with the same bits."""
    dev = resolve_device(device)
    return tree_util.map(lambda a: _from_numpy(np.asarray(a), dev), tree)


def params_to_numpy(tree: Any) -> Any:
    """A tree of tensors -> a tree of NumPy arrays on the host.  bf16 leaves
    come back widened to float32, which is exact: every bf16 value is a
    float32 value with the low 16 bits zero."""
    def one(t: torch.Tensor) -> np.ndarray:
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    return tree_util.map(one, tree)
