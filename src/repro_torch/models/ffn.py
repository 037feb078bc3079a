"""Feed-forward blocks: gated (SwiGLU/GeGLU) and plain MLPs."""
from __future__ import annotations

from typing import Dict

import torch

from .common import ACTIVATIONS, ParamSpec, spec


def gated_mlp_specs(d_model: int, d_ff: int, dtype: torch.dtype = torch.bfloat16
                    ) -> Dict[str, ParamSpec]:
    return {
        "w_gate": spec((d_model, d_ff), ("embed", "mlp"), dtype=dtype),
        "w_up": spec((d_model, d_ff), ("embed", "mlp"), dtype=dtype),
        "w_down": spec((d_ff, d_model), ("mlp", "embed"), dtype=dtype),
    }


def gated_mlp(p: Dict[str, torch.Tensor], x: torch.Tensor, act: str = "silu"
              ) -> torch.Tensor:
    a = ACTIVATIONS[act]
    h = a(x @ p["w_gate"]) * (x @ p["w_up"])
    return h @ p["w_down"]


def mlp_specs(d_model: int, d_ff: int, dtype: torch.dtype = torch.bfloat16
              ) -> Dict[str, ParamSpec]:
    return {
        "w_in": spec((d_model, d_ff), ("embed", "mlp"), dtype=dtype),
        "b_in": spec((d_ff,), ("mlp",), dtype=dtype, init="zeros"),
        "w_out": spec((d_ff, d_model), ("mlp", "embed"), dtype=dtype),
        "b_out": spec((d_model,), ("embed",), dtype=dtype, init="zeros"),
    }


def mlp(p: Dict[str, torch.Tensor], x: torch.Tensor, act: str = "gelu"
        ) -> torch.Tensor:
    a = ACTIVATIONS[act]
    return a(x @ p["w_in"] + p["b_in"]) @ p["w_out"] + p["b_out"]
