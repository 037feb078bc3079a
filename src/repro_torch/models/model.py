"""Model: embeds + stacked block groups + head — the parameter half.

``param_specs`` declares the same tree as the JAX reference
(``repro/models/model.py``): the same keys, shapes, dtypes, logical axes and
init rules, so one configuration counts the same parameters in both
packages and a parameter tree carries across (:mod:`.convert`).
``init_params`` materialises it on a device.  The forward, prefill and
decode entry points come with the model slice.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List

import torch

from ..configs.base import ModelConfig
from ..device import DeviceLike, resolve_device
from .blocks import BlockGroup, block_groups, layer_specs
from .common import count_params, is_spec, materialize, spec, stack_specs


class Model:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.groups: List[BlockGroup] = block_groups(cfg)
        n = sum(g.count * len(g.descs) for g in self.groups)
        if n != cfg.n_layers:
            raise ValueError(f"{cfg.name}: block groups hold {n} layers, "
                             f"config says {cfg.n_layers}")

    # ------------------------------------------------------------ params

    def param_specs(self) -> Dict[str, Any]:
        cfg = self.cfg
        specs: Dict[str, Any] = {}
        if cfg.family == "audio":
            specs["frontend"] = {
                "w": spec((cfg.frontend_dim, cfg.d_model), (None, "embed")),
                "b": spec((cfg.d_model,), ("embed",), init="zeros"),
            }
        else:
            specs["embed"] = spec((cfg.vocab, cfg.d_model), ("vocab", "embed"),
                                  scale=cfg.d_model ** -0.5)
        if cfg.family == "vlm":
            specs["vision_proj"] = spec((cfg.vision_dim, cfg.d_model),
                                        (None, "embed"))
        for gi, g in enumerate(self.groups):
            block = {f"l{i}": layer_specs(d, cfg) for i, d in enumerate(g.descs)}
            specs[f"blocks{gi}"] = stack_specs(block, g.count)
        specs["ln_f"] = ({"g": spec((cfg.d_model,), ("embed",), init="ones"),
                          "b": spec((cfg.d_model,), ("embed",), init="zeros")}
                         if cfg.norm == "layernorm" else
                         {"g": spec((cfg.d_model,), ("embed",),
                                    init="zeros" if cfg.rms_plus_one else "ones")})
        if not cfg.tie_embeddings:
            specs["head"] = spec((cfg.d_model, cfg.vocab), ("embed", "vocab"))
        return specs

    def init_params(self, generator: torch.Generator,
                    device: DeviceLike = None) -> Any:
        """Materialised parameters on ``device`` (``None``: ``cuda:0``, or
        an error without one); ``generator`` must live on that device."""
        return materialize(self.param_specs(), generator,
                           resolve_device(device))

    def n_params(self) -> int:
        return count_params(self.param_specs())

    def n_active_params(self) -> int:
        """Parameters touched per token (MoE: top_k of routed experts)."""
        cfg = self.cfg
        total = 0
        for leaf_path, s in _iter_with_path(self.param_specs()):
            n = 1
            for d in s.shape:
                n *= d
            if "moe" in leaf_path and any(k in leaf_path for k in
                                          ("w_gate", "w_up", "w_down")):
                n = n * cfg.top_k // max(cfg.n_experts, 1)
            total += n
        return total


def _iter_with_path(tree, prefix=""):
    if is_spec(tree):
        yield prefix, tree
        return
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _iter_with_path(v, prefix + "/" + str(k))


@functools.lru_cache(maxsize=64)
def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
