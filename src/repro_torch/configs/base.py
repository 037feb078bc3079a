"""Model/shape configuration system.

Every assigned architecture is one :class:`ModelConfig` in this package (exact
published dimensions) plus a ``reduced()`` variant for CPU smoke tests.  The
input-shape grid (train_4k / prefill_32k / decode_32k / long_500k) is shared
by all LM archs; cells inapplicable to a family are skipped with a reason
(DESIGN.md §Arch-applicability).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Dict, Optional, Tuple


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


@dataclass(frozen=True)
class ModelConfig:
    # identity
    name: str
    family: str                    # dense | moe | hybrid | vlm | ssm | audio
    source: str = ""               # provenance note
    # core dims
    n_layers: int = 0
    d_model: int = 0
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    vocab: int = 0
    # attention variant
    attention: str = "full"        # full | local_global | swa | none
    window: int = 0                # sliding window size (swa / local layers)
    logit_softcap: float = 0.0     # gemma2 final-logit cap
    attn_softcap: float = 0.0      # gemma2 attention cap
    qk_norm: bool = False          # qwen3
    rope_theta: float = 1e4
    rotary_pct: float = 1.0        # stablelm partial rotary
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    post_norm: bool = False        # gemma2 sandwich norms
    rms_plus_one: bool = False     # gemma-style (1+g)
    act: str = "silu"
    # MLA (deepseek)
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    n_dense_layers: int = 0        # deepseek: dense FFN in first k layers
    moe_every: int = 1             # jamba: MoE replaces MLP every k-th layer
    capacity_factor: float = 1.25
    use_mtp: bool = False          # deepseek multi-token-prediction head
    moe_groups: int = 0            # 0 = auto grouped dispatch (§Perf H1);
    #                                1 = global dispatch (pre-hillclimb)
    moe_expert_parallel: bool = True   # constrain experts onto model axis
    # hybrid / ssm
    attn_every: int = 0            # jamba: one attention layer per k layers
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    ssm_chunk: int = 256
    # vlm
    cross_attn_every: int = 0      # cross-attn layer period
    vision_seq: int = 0            # stub frontend: #patch embeddings
    vision_dim: int = 0
    # audio / encoder
    is_encoder: bool = False
    frontend_dim: int = 0          # stub frontend: frame-embedding dim
    # misc
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    kv_chunk: int = 2048           # attention kv-chunking (flash-style scan)
    # scan super-block period (layers per scan step); 1 for homogeneous stacks
    block_period: int = 1

    # ------------------------------------------------------------ utilities

    def with_(self, **kw) -> "ModelConfig":
        return replace(self, **kw)

    @property
    def d_inner(self) -> int:
        return self.ssm_heads * self.ssm_head_dim

    @property
    def n_blocks(self) -> int:
        assert self.n_layers % self.block_period == 0, (self.name,)
        return self.n_layers // self.block_period

    def supports(self, shape: str) -> Tuple[bool, str]:
        """Dry-run cell applicability (reasons recorded in DESIGN.md)."""
        s = SHAPES[shape]
        if self.is_encoder and s.kind == "decode":
            return False, "encoder-only arch has no decode step"
        if shape == "long_500k":
            subquad = (self.family in ("ssm", "hybrid")
                       or self.attention in ("swa", "local_global"))
            if not subquad:
                return False, "pure full attention: 500k decode cache infeasible"
        return True, ""

    def reduced(self) -> "ModelConfig":
        """Smoke-test scale: same family/topology, tiny dims."""
        period = self.block_period
        kw = dict(
            n_layers=max(2 * period, period),
            d_model=64,
            d_ff=128 if self.d_ff else 0,
            vocab=256,
            window=min(self.window, 32) if self.window else 0,
            kv_chunk=64,
            ssm_chunk=16,
        )
        if self.n_heads:
            kw.update(n_heads=4, n_kv_heads=min(self.n_kv_heads, 2) or 2,
                      head_dim=16)
        if self.use_mla:
            kw.update(q_lora_rank=32, kv_lora_rank=32, qk_nope_dim=16,
                      qk_rope_dim=8, v_head_dim=16)
        if self.n_experts:
            # ample capacity: smoke tests assert exact parity across shapes,
            # which requires no capacity drops (cap >= N tokens per expert)
            kw.update(n_experts=8, top_k=min(self.top_k, 2), moe_d_ff=64,
                      n_shared_experts=min(self.n_shared_experts, 1),
                      capacity_factor=4.0)
        if self.n_dense_layers:
            kw.update(n_dense_layers=1, n_layers=1 + period)
        if self.ssm_heads:
            kw.update(ssm_heads=4, ssm_head_dim=16, ssm_state=16)
        if self.vision_seq:
            kw.update(vision_seq=16, vision_dim=64)
        if self.frontend_dim:
            kw.update(frontend_dim=32)
        return self.with_(name=self.name + "-smoke", **kw)


# global registry, populated by the sibling config modules
_REGISTRY: Dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    from . import _load_all  # late import: populate registry
    _load_all()
    if name.endswith("-smoke"):
        return get_config(name[: -len("-smoke")]).reduced()
    return _REGISTRY[name]


def list_configs() -> Tuple[str, ...]:
    from . import _load_all
    _load_all()
    return tuple(sorted(_REGISTRY))
