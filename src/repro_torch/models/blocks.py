"""Block programs: every architecture as a composition of layer descriptors
over stacked parameters, and the parameter declarations of each layer.

A model is a sequence of :class:`BlockGroup`\\ s; each group is ``count``
repetitions of a **period** of heterogeneous layers (descriptors).
Homogeneous stacks (llama, qwen, mixtral, mamba2, hubert) have period 1;
gemma2 repeats (local, global) pairs; llama-vision 5-layer periods with one
cross-attention layer; jamba 8-layer periods (1 attention : 7 mamba, MoE
every 2nd); deepseek has a 3-layer dense prefix group before the MoE group.

The layer forwards — full sequence (:func:`apply_layer`), prefill with its
decode cache (:func:`apply_layer_prefill`) and one decode step
(:func:`apply_layer_decode`) — cover every mixer (GQA attention, MLA,
gated cross-attention to the projected vision embeddings, Mamba-2) and
every feed-forward (gated / plain MLP, MoE with its aux loss): all ten
registered configurations.  Decode writes each layer's cache — KV, MLA's
latent entry, Mamba's state and conv tails — into the given tensors in
place.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from .attention import (MLAWeights, chunked_attention, decode_attention,
                        mla_attention, mla_decode)
from .common import ParamSpec, apply_rope, layer_norm, rms_norm, spec
from .ffn import gated_mlp, gated_mlp_specs, mlp, mlp_specs
from .mamba import MambaState, mamba_block, mamba_decode, mamba_specs
from .moe import moe_ffn, moe_specs


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


# --------------------------------------------------------------- forward

def _apply_norm(p: Dict[str, torch.Tensor], x: torch.Tensor,
                cfg: ModelConfig) -> torch.Tensor:
    if cfg.norm == "layernorm":
        return layer_norm(x, p["g"], p["b"], cfg.norm_eps)
    return rms_norm(x, p["g"], cfg.norm_eps, plus_one=cfg.rms_plus_one)


def _positions(start: int, n: int, device: torch.device) -> torch.Tensor:
    return (start + torch.arange(n, device=device))[None, :]


def _gqa_attention(p: Dict[str, Any], x: torch.Tensor, cfg: ModelConfig,
                   desc: LayerDesc, q_offset: int) -> torch.Tensor:
    B, T, _ = x.shape
    q, k, v = _qkv(p, x, cfg, _positions(q_offset, T, x.device))
    o = chunked_attention(q, k, v, causal=desc.causal, window=desc.window,
                          attn_softcap=cfg.attn_softcap, kv_chunk=cfg.kv_chunk)
    return o.reshape(B, T, cfg.n_heads * cfg.head_dim) @ p["wo"]


# a Mamba layer's cache keys, in MambaState's field order
MAMBA_CACHE = ("ssm", "cx", "cb", "cc")


def _mla(lp: Dict[str, Any]) -> MLAWeights:
    return MLAWeights(**{k: lp["attn"][k] for k in MLAWeights._fields})


def _mla_kw(cfg: ModelConfig) -> Dict[str, Any]:
    return dict(n_heads=cfg.n_heads, nope=cfg.qk_nope_dim,
                rope_dim=cfg.qk_rope_dim, v_dim=cfg.v_head_dim,
                rope_theta=cfg.rope_theta, norm_eps=cfg.norm_eps)


def _mamba_kw(cfg: ModelConfig) -> Dict[str, Any]:
    return dict(n_heads=cfg.ssm_heads, head_dim=cfg.ssm_head_dim,
                d_state=cfg.ssm_state, n_groups=cfg.ssm_groups,
                norm_eps=cfg.norm_eps)


def _cross_kv(p: Dict[str, Any], vis: torch.Tensor, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-attention keys (k-normed) and values of the projected vision
    embeddings ``vis`` (B, Nv, d_model): the layer's decode cache."""
    B = vis.shape[0]
    hkv, dh = cfg.n_kv_heads, cfg.head_dim
    k = rms_norm((vis @ p["wk"]).reshape(B, -1, hkv, dh), p["k_norm"],
                 cfg.norm_eps)
    v = (vis @ p["wv"]).reshape(B, -1, hkv, dh)
    return k, v


def _cross_q(p: Dict[str, Any], x: torch.Tensor, cfg: ModelConfig
             ) -> torch.Tensor:
    B, T, _ = x.shape
    return rms_norm((x @ p["wq"]).reshape(B, T, cfg.n_heads, cfg.head_dim),
                    p["q_norm"], cfg.norm_eps)


def _cross_out(p: Dict[str, Any], o: torch.Tensor) -> torch.Tensor:
    """The gated output: ``tanh(gate_attn)`` times the projected heads."""
    B, T = o.shape[:2]
    return torch.tanh(p["gate_attn"]) * (o.reshape(B, T, -1) @ p["wo"])


def _cross_attention(p: Dict[str, Any], x: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Gated cross-attention of ``x`` (B, T, d) to the vision keys and
    values: bidirectional."""
    o = chunked_attention(_cross_q(p, x, cfg), k, v, causal=False,
                          kv_chunk=cfg.kv_chunk)
    return _cross_out(p, o)


def apply_layer(lp: Dict[str, Any], x: torch.Tensor, desc: LayerDesc,
                cfg: ModelConfig, *, vis: Optional[torch.Tensor] = None,
                q_offset: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence (train/prefill) layer.  Returns (x, aux_loss).
    ``vis``: the projected vision embeddings (cross-attention layers)."""
    if desc.mixer == "attn":
        x = x + _gqa_mixer(lp, x, cfg, desc, q_offset)
    elif desc.mixer == "cross":
        h = _apply_norm(lp["ln_attn"], x, cfg)
        x = x + _cross_attention(lp["attn"], h, *_cross_kv(lp["attn"], vis,
                                                           cfg), cfg)
    elif desc.mixer == "mamba":
        h = _apply_norm(lp["ln_attn"], x, cfg)
        x = x + mamba_block(lp["mamba"], h, chunk=cfg.ssm_chunk,
                            **_mamba_kw(cfg))
    return _apply_ffn(lp, x, desc, cfg)


def _gqa_mixer(lp, x, cfg, desc, q_offset):
    h = _apply_norm(lp["ln_attn"], x, cfg)
    if cfg.use_mla:
        o, _ = mla_attention(h, _mla(lp), q_offset=q_offset,
                             kv_chunk=cfg.kv_chunk, **_mla_kw(cfg))
    else:
        o = _gqa_attention(lp["attn"], h, cfg, desc, q_offset)
    if cfg.post_norm:
        o = _apply_norm(lp["ln_attn_post"], o, cfg)
    return o


# ------------------------------------------------------- prefill (w/ caches)

def _qkv(p, x, cfg, rope_pos):
    B, T, _ = x.shape
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ p["wq"]).reshape(B, T, h, dh)
    k = (x @ p["wk"]).reshape(B, T, hkv, dh)
    v = (x @ p["wv"]).reshape(B, T, hkv, dh)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    rd = int(cfg.rotary_pct * dh)
    q = apply_rope(q, rope_pos, cfg.rope_theta, rotary_dim=rd)
    k = apply_rope(k, rope_pos, cfg.rope_theta, rotary_dim=rd)
    return q, k, v


def _window_tail(k: torch.Tensor, window: int) -> torch.Tensor:
    """Seed a ring cache from prefill: absolute position p lives at slot
    p % window, matching decode's ``cache_len % window`` write index.  For
    T < window, positions sit at their own index (pad right); otherwise the
    last `window` tokens are rolled so slot alignment is preserved for any
    T (not just multiples of the window)."""
    T = k.shape[1]
    if T < window:
        pad = k.new_zeros((k.shape[0], window - T, *k.shape[2:]))
        return torch.cat([k, pad], dim=1)
    tail = k[:, T - window:]
    return torch.roll(tail, T % window, dims=1)


def apply_layer_prefill(lp: Dict[str, Any], x: torch.Tensor, desc: LayerDesc,
                        cfg: ModelConfig, *, vis: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Like apply_layer but also emits this layer's decode cache."""
    cache: Dict[str, Any] = {}
    if desc.mixer == "attn":
        h = _apply_norm(lp["ln_attn"], x, cfg)
        if cfg.use_mla:
            o, lat = mla_attention(h, _mla(lp), kv_chunk=cfg.kv_chunk,
                                   **_mla_kw(cfg))
            cache = {"lat": lat}
        else:
            B, T, _ = x.shape
            q, k, v = _qkv(lp["attn"], h, cfg, _positions(0, T, x.device))
            o = chunked_attention(q, k, v, causal=desc.causal,
                                  window=desc.window,
                                  attn_softcap=cfg.attn_softcap,
                                  kv_chunk=cfg.kv_chunk)
            o = o.reshape(B, T, -1) @ lp["attn"]["wo"]
            if desc.window > 0:
                cache = {"k": _window_tail(k, desc.window),
                         "v": _window_tail(v, desc.window)}
            else:
                cache = {"k": k, "v": v}
        if cfg.post_norm:
            o = _apply_norm(lp["ln_attn_post"], o, cfg)
        x = x + o
    elif desc.mixer == "cross":
        h = _apply_norm(lp["ln_attn"], x, cfg)
        k, v = _cross_kv(lp["attn"], vis, cfg)
        x = x + _cross_attention(lp["attn"], h, k, v, cfg)
        cache = {"k": k, "v": v}
    elif desc.mixer == "mamba":
        h = _apply_norm(lp["ln_attn"], x, cfg)
        o, st = mamba_block(lp["mamba"], h, chunk=cfg.ssm_chunk,
                            return_state=True, **_mamba_kw(cfg))
        x = x + o
        cache = dict(zip(MAMBA_CACHE, st))
    x, _ = _apply_ffn(lp, x, desc, cfg)
    return x, cache


def _apply_ffn(lp, x, desc, cfg):
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if desc.ffn == "mlp":
        h = _apply_norm(lp["ln_mlp"], x, cfg)
        h = (mlp(lp["mlp"], h, "gelu") if cfg.norm == "layernorm"
             else gated_mlp(lp["mlp"], h, cfg.act))
        if cfg.post_norm:
            h = _apply_norm(lp["ln_mlp_post"], h, cfg)
        x = x + h
    elif desc.ffn == "moe":
        h = _apply_norm(lp["ln_mlp"], x, cfg)
        h, aux = moe_ffn(lp["moe"], h, top_k=cfg.top_k,
                         capacity_factor=cfg.capacity_factor, act=cfg.act,
                         router_bias=lp.get("router_bias"),
                         groups=cfg.moe_groups)
        x = x + h
    return x, aux


# ---------------------------------------------------------------- decode

def cache_specs(desc: LayerDesc, cfg: ModelConfig, batch: int, seq: int
                ) -> Dict[str, Any]:
    """ParamSpec-style declaration of one layer's decode cache (the same
    shapes, axes and dtypes as the reference's, every mixer included)."""
    hkv, dh = cfg.n_kv_heads, cfg.head_dim
    dt = torch.bfloat16
    if desc.mixer == "attn":
        if cfg.use_mla:
            return {"lat": spec((batch, seq, cfg.kv_lora_rank + cfg.qk_rope_dim),
                                ("batch", "kv_seq", None), dtype=dt)}
        s = min(seq, desc.window) if desc.window > 0 else seq
        return {"k": spec((batch, s, hkv, dh), ("batch", "kv_seq", "kv_heads", None), dtype=dt),
                "v": spec((batch, s, hkv, dh), ("batch", "kv_seq", "kv_heads", None), dtype=dt)}
    if desc.mixer == "cross":
        return {"k": spec((batch, cfg.vision_seq, hkv, dh), ("batch", None, "kv_heads", None), dtype=dt),
                "v": spec((batch, cfg.vision_seq, hkv, dh), ("batch", None, "kv_heads", None), dtype=dt)}
    if desc.mixer == "mamba":
        H, P, N, G = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_groups
        W = 4
        return {"ssm": spec((batch, H, N, P), ("batch", "kv_heads", None, None), dtype=torch.float32),
                "cx": spec((batch, W - 1, H * P), ("batch", None, "heads_mlp"), dtype=dt),
                "cb": spec((batch, W - 1, G * N), ("batch", None, None), dtype=dt),
                "cc": spec((batch, W - 1, G * N), ("batch", None, None), dtype=dt)}
    return {}


def apply_layer_decode(lp: Dict[str, Any], x: torch.Tensor, desc: LayerDesc,
                       cfg: ModelConfig, cache: Dict[str, Any],
                       cache_len: int
                       ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Single-token decode.  x: (B, 1, D); cache_len: int = #tokens so far.

    What the step adds to the cache is written into ``cache``'s tensors in
    place (the reference returns new arrays): the new key and value, MLA's
    latent entry, Mamba's state and conv tails; a cross-attention cache is
    only read.  The returned cache holds the same tensors."""
    B = x.shape[0]
    cache_len = int(cache_len)
    if desc.mixer == "attn":
        h = _apply_norm(lp["ln_attn"], x, cfg)
        if cfg.use_mla:
            o, _ = mla_decode(h, _mla(lp), cache["lat"], cache_len=cache_len,
                              **_mla_kw(cfg))
        else:
            q, k, v = _qkv(lp["attn"], h, cfg,
                           _positions(cache_len, 1, x.device))
            kc, vc = cache["k"], cache["v"]
            S = kc.shape[1]
            idx = cache_len % S if desc.window > 0 else cache_len
            if not 0 <= idx < S:
                raise ValueError(f"apply_layer_decode: position {idx} is "
                                 f"outside the cache's {S} slots")
            kc[:, idx] = k[:, 0]
            vc[:, idx] = v[:, 0]
            n_valid = min(cache_len + 1, S)
            o = decode_attention(q, kc, vc, cache_len=n_valid,
                                 attn_softcap=cfg.attn_softcap)
            o = o.reshape(B, 1, -1) @ lp["attn"]["wo"]
        if cfg.post_norm:
            o = _apply_norm(lp["ln_attn_post"], o, cfg)
        x = x + o
    elif desc.mixer == "cross":
        h = _apply_norm(lp["ln_attn"], x, cfg)
        o = decode_attention(_cross_q(lp["attn"], h, cfg), cache["k"],
                             cache["v"], cache_len=cache["k"].shape[1])
        x = x + _cross_out(lp["attn"], o)
    elif desc.mixer == "mamba":
        h = _apply_norm(lp["ln_attn"], x, cfg)
        st = MambaState(*(cache[name] for name in MAMBA_CACHE))
        o, st = mamba_decode(lp["mamba"], h, st, **_mamba_kw(cfg))
        for name, t in zip(MAMBA_CACHE, st):
            cache[name].copy_(t)
        x = x + o
    x, _ = _apply_ffn(lp, x, desc, cfg)
    return x, cache
