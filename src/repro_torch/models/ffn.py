"""Feed-forward parameter declarations: gated (SwiGLU/GeGLU) and plain MLPs.
The forwards come with the model slice."""
from __future__ import annotations

from typing import Dict

import torch

from .common import ParamSpec, spec


def gated_mlp_specs(d_model: int, d_ff: int, dtype: torch.dtype = torch.bfloat16
                    ) -> Dict[str, ParamSpec]:
    return {
        "w_gate": spec((d_model, d_ff), ("embed", "mlp"), dtype=dtype),
        "w_up": spec((d_model, d_ff), ("embed", "mlp"), dtype=dtype),
        "w_down": spec((d_ff, d_model), ("mlp", "embed"), dtype=dtype),
    }


def mlp_specs(d_model: int, d_ff: int, dtype: torch.dtype = torch.bfloat16
              ) -> Dict[str, ParamSpec]:
    return {
        "w_in": spec((d_model, d_ff), ("embed", "mlp"), dtype=dtype),
        "b_in": spec((d_ff,), ("mlp",), dtype=dtype, init="zeros"),
        "w_out": spec((d_ff, d_model), ("mlp", "embed"), dtype=dtype),
        "b_out": spec((d_model,), ("embed",), dtype=dtype, init="zeros"),
    }
