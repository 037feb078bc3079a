"""Update compression for the client-to-server uplink.

Two schemes, as in the JAX reference (``repro/fed/compression.py``):

* int8 block quantisation (FedPAQ-style) on the ``quantize`` /
  ``dequantize`` kernels — about 4x less uplink;
* top-k sparsification — keep the k largest-|.| entries of each tensor.

``compress`` / ``decompress`` round-trip trees (:mod:`repro_torch.tree`);
codes, scales and reconstructions are bit-equal to the reference's.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
import torch.nn.functional as F

from .. import tree as tree_util
from ..kernels import ops as kernel_ops

_PACKED = {"q", "scales", "shape", "pad"}
_SPARSE = {"idx", "val", "shape"}


@dataclass(frozen=True)
class QuantizeConfig:
    block: int = 256
    enabled: bool = True


def _is_packed(x: Any) -> bool:
    return isinstance(x, dict) and set(x) == _PACKED


def _is_sparse(x: Any) -> bool:
    return isinstance(x, dict) and set(x) == _SPARSE


def compress(tree: Any, cfg: QuantizeConfig = QuantizeConfig()) -> Any:
    """tree of f32 tensors -> tree of ``{"q", "scales", "shape", "pad"}``
    (each leaf flattened, zero-padded to a multiple of ``cfg.block``)."""
    if not cfg.enabled:
        return tree

    def one(x: torch.Tensor):
        flat = x.reshape(-1).to(torch.float32)
        pad = (-flat.shape[0]) % cfg.block
        if pad:
            flat = F.pad(flat, (0, pad))
        q, s = kernel_ops.quantize(flat, block=cfg.block, rows_per_tile=1)
        return {"q": q, "scales": s, "shape": tuple(x.shape), "pad": pad}

    return tree_util.map(one, tree)


def decompress(tree: Any, cfg: QuantizeConfig = QuantizeConfig()) -> Any:
    if not cfg.enabled:
        return tree

    def one(x):
        flat = kernel_ops.dequantize(x["q"], x["scales"], block=cfg.block,
                                     rows_per_tile=1)
        n = 1
        for d in x["shape"]:
            n *= d
        return flat[:n].reshape(x["shape"])

    return tree_util.map(one, tree, is_leaf=_is_packed)


def compressed_bytes(tree: Any) -> int:
    total = 0
    for leaf in tree_util.leaves(tree, is_leaf=_is_packed):
        if _is_packed(leaf):
            total += leaf["q"].numel() + leaf["scales"].numel() * 4
        else:
            total += leaf.numel() * leaf.element_size()
    return total


def topk_sparsify(tree: Any, frac: float = 0.01) -> Any:
    """Keep the top-``frac`` |values| of each tensor: ``{"idx", "val",
    "shape"}``.  Ties may be kept in another order than ``jax.lax.top_k``
    keeps them."""
    def one(x: torch.Tensor):
        flat = x.reshape(-1)
        k = max(1, int(frac * flat.shape[0]))
        _, idx = torch.topk(torch.abs(flat), k)
        return {"idx": idx, "val": flat[idx], "shape": tuple(x.shape)}
    return tree_util.map(one, tree)


def topk_densify(tree: Any) -> Any:
    def one(x):
        n = 1
        for d in x["shape"]:
            n *= d
        flat = torch.zeros(n, dtype=x["val"].dtype, device=x["val"].device)
        flat[x["idx"]] = x["val"]
        return flat.reshape(x["shape"])
    return tree_util.map(one, tree, is_leaf=_is_sparse)
