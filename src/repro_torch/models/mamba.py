"""Mamba2 (SSD) block parameter declarations.  The chunked scan and the
recurrent decode come with the model slice."""
from __future__ import annotations

from typing import Any, Dict

import torch

from .common import spec


def mamba_specs(d_model: int, n_heads: int, head_dim: int, d_state: int,
                n_groups: int = 1, conv_width: int = 4,
                dtype: torch.dtype = torch.bfloat16) -> Dict[str, Any]:
    d_inner = n_heads * head_dim
    gn = n_groups * d_state
    return {
        "w_z": spec((d_model, d_inner), ("embed", "heads_mlp"), dtype=dtype),
        "w_x": spec((d_model, d_inner), ("embed", "heads_mlp"), dtype=dtype),
        "w_b": spec((d_model, gn), ("embed", None), dtype=dtype),
        "w_c": spec((d_model, gn), ("embed", None), dtype=dtype),
        "w_dt": spec((d_model, n_heads), ("embed", None), dtype=dtype),
        "conv_x": spec((conv_width, d_inner), (None, "heads_mlp"), dtype=dtype,
                       init="normal", scale=0.5),
        "conv_b": spec((conv_width, gn), (None, None), dtype=dtype, scale=0.5),
        "conv_c": spec((conv_width, gn), (None, None), dtype=dtype, scale=0.5),
        "a_log": spec((n_heads,), (None,), dtype=torch.float32, init="zeros"),
        "dt_bias": spec((n_heads,), (None,), dtype=torch.float32, init="zeros"),
        "d_skip": spec((n_heads,), (None,), dtype=torch.float32, init="ones"),
        "norm": spec((d_inner,), ("heads_mlp",), dtype=dtype, init="ones"),
        "w_out": spec((d_inner, d_model), ("heads_mlp", "embed"), dtype=dtype),
    }
