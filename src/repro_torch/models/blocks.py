"""Block programs: every architecture as a composition of layer descriptors
over stacked parameters, and the parameter declarations of each layer.

A model is a sequence of :class:`BlockGroup`\\ s; each group is ``count``
repetitions of a **period** of heterogeneous layers (descriptors).
Homogeneous stacks (llama, qwen, mixtral, mamba2, hubert) have period 1;
gemma2 repeats (local, global) pairs; llama-vision 5-layer periods with one
cross-attention layer; jamba 8-layer periods (1 attention : 7 mamba, MoE
every 2nd); deepseek has a 3-layer dense prefix group before the MoE group.
The layer forwards come with the model slice.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Tuple

import torch

from ..configs.base import ModelConfig
from .common import ParamSpec, spec
from .ffn import gated_mlp_specs, mlp_specs
from .mamba import mamba_specs
from .moe import moe_specs


@dataclass(frozen=True)
class LayerDesc:
    mixer: str                  # attn | mamba | cross | none
    ffn: str                    # mlp | moe | none
    window: int = 0             # sliding window for this attention layer
    causal: bool = True


@dataclass(frozen=True)
class BlockGroup:
    descs: Tuple[LayerDesc, ...]
    count: int


def block_groups(cfg: ModelConfig) -> List[BlockGroup]:
    fam = cfg.family
    if fam in ("dense", "audio"):
        causal = not cfg.is_encoder
        if cfg.attention == "local_global":
            local = LayerDesc("attn", "mlp", window=cfg.window, causal=causal)
            glob = LayerDesc("attn", "mlp", window=0, causal=causal)
            if cfg.n_layers % 2:
                raise ValueError(f"{cfg.name}: local/global needs even layers")
            return [BlockGroup((local, glob), cfg.n_layers // 2)]
        w = cfg.window if cfg.attention == "swa" else 0
        return [BlockGroup((LayerDesc("attn", "mlp", window=w, causal=causal),),
                           cfg.n_layers)]
    if fam == "moe":
        w = cfg.window if cfg.attention == "swa" else 0
        groups = []
        if cfg.n_dense_layers:
            groups.append(BlockGroup((LayerDesc("attn", "mlp", window=w),),
                                     cfg.n_dense_layers))
        groups.append(BlockGroup((LayerDesc("attn", "moe", window=w),),
                                 cfg.n_layers - cfg.n_dense_layers))
        return groups
    if fam == "hybrid":
        period = cfg.attn_every
        descs = []
        for i in range(period):
            mixer = "attn" if i == period // 2 else "mamba"
            ffn = "moe" if (i % cfg.moe_every == cfg.moe_every - 1) else "mlp"
            descs.append(LayerDesc(mixer, ffn))
        if cfg.n_layers % period:
            raise ValueError(f"{cfg.name}: layers not a multiple of {period}")
        return [BlockGroup(tuple(descs), cfg.n_layers // period)]
    if fam == "vlm":
        period = cfg.cross_attn_every
        descs = [LayerDesc("attn", "mlp") for _ in range(period - 1)]
        descs.insert(period - 2, LayerDesc("cross", "mlp", causal=False))
        if cfg.n_layers % period:
            raise ValueError(f"{cfg.name}: layers not a multiple of {period}")
        return [BlockGroup(tuple(descs), cfg.n_layers // period)]
    if fam == "ssm":
        return [BlockGroup((LayerDesc("mamba", "none"),), cfg.n_layers)]
    raise ValueError(f"unknown family {fam}")


# ----------------------------------------------------------------- specs

def _norm_specs(d: int, cfg: ModelConfig) -> Dict[str, ParamSpec]:
    if cfg.norm == "layernorm":
        return {"g": spec((d,), ("embed",), init="ones"),
                "b": spec((d,), ("embed",), init="zeros")}
    return {"g": spec((d,), ("embed",),
                      init="zeros" if cfg.rms_plus_one else "ones")}


def attn_specs(cfg: ModelConfig) -> Dict[str, Any]:
    d, h, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    s: Dict[str, Any] = {
        "wq": spec((d, h * dh), ("embed", "heads_mlp")),
        "wk": spec((d, hkv * dh), ("embed", "heads_mlp")),
        "wv": spec((d, hkv * dh), ("embed", "heads_mlp")),
        "wo": spec((h * dh, d), ("heads_mlp", "embed")),
    }
    if cfg.qk_norm:
        s["q_norm"] = spec((dh,), (None,), init="ones")
        s["k_norm"] = spec((dh,), (None,), init="ones")
    return s


def mla_specs(cfg: ModelConfig) -> Dict[str, Any]:
    d, h = cfg.d_model, cfg.n_heads
    qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
    nope, rope, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    return {
        "w_dq": spec((d, qr), ("embed", "mla_rank")),
        "q_norm": spec((qr,), ("mla_rank",), init="ones"),
        "w_uq": spec((qr, h * (nope + rope)), ("mla_rank", "heads_mlp")),
        "w_dkv": spec((d, kvr), ("embed", "mla_rank")),
        "kv_norm": spec((kvr,), ("mla_rank",), init="ones"),
        "w_kr": spec((d, rope), ("embed", None)),
        "w_uk": spec((kvr, h * nope), ("mla_rank", "heads_mlp")),
        "w_uv": spec((kvr, h * vd), ("mla_rank", "heads_mlp")),
        "w_o": spec((h * vd, d), ("heads_mlp", "embed")),
    }


def cross_attn_specs(cfg: ModelConfig) -> Dict[str, Any]:
    d, h, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {
        "wq": spec((d, h * dh), ("embed", "heads_mlp")),
        "wk": spec((d, hkv * dh), ("embed", "heads_mlp")),
        "wv": spec((d, hkv * dh), ("embed", "heads_mlp")),
        "wo": spec((h * dh, d), ("heads_mlp", "embed")),
        "gate_attn": spec((1,), (None,), init="zeros"),
        "q_norm": spec((dh,), (None,), init="ones"),
        "k_norm": spec((dh,), (None,), init="ones"),
    }


def layer_specs(desc: LayerDesc, cfg: ModelConfig) -> Dict[str, Any]:
    s: Dict[str, Any] = {}
    if desc.mixer == "attn":
        s["ln_attn"] = _norm_specs(cfg.d_model, cfg)
        s["attn"] = mla_specs(cfg) if cfg.use_mla else attn_specs(cfg)
        if cfg.post_norm:
            s["ln_attn_post"] = _norm_specs(cfg.d_model, cfg)
    elif desc.mixer == "cross":
        s["ln_attn"] = _norm_specs(cfg.d_model, cfg)
        s["attn"] = cross_attn_specs(cfg)
    elif desc.mixer == "mamba":
        s["ln_attn"] = _norm_specs(cfg.d_model, cfg)
        s["mamba"] = mamba_specs(cfg.d_model, cfg.ssm_heads, cfg.ssm_head_dim,
                                 cfg.ssm_state, cfg.ssm_groups)
    if desc.ffn == "mlp":
        s["ln_mlp"] = _norm_specs(cfg.d_model, cfg)
        d_ff = cfg.d_ff
        s["mlp"] = (mlp_specs(cfg.d_model, d_ff) if cfg.norm == "layernorm"
                    else gated_mlp_specs(cfg.d_model, d_ff))
        if cfg.post_norm:
            s["ln_mlp_post"] = _norm_specs(cfg.d_model, cfg)
    elif desc.ffn == "moe":
        s["ln_mlp"] = _norm_specs(cfg.d_model, cfg)
        s["moe"] = moe_specs(cfg.d_model, cfg.moe_d_ff or cfg.d_ff,
                             cfg.n_experts, cfg.n_shared_experts,
                             expert_parallel=cfg.moe_expert_parallel)
        s["router_bias"] = spec((cfg.n_experts,), (None,), dtype=torch.float32,
                                init="zeros")
    return s
