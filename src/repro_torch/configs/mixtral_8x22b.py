"""mixtral-8x22b — [arXiv:2401.04088; hf].
56L d_model=6144 48H (GQA kv=8) expert d_ff=16384, vocab=32768,
8 experts top-2, SWA window 4096 (per assignment spec)."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="mixtral-8x22b", family="moe", source="arXiv:2401.04088",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=16384, vocab=32_768,
    attention="swa", window=4096,
    n_experts=8, top_k=2, moe_d_ff=16384,
    moe_expert_parallel=False,   # 8 experts cannot shard 16-way; TP inside experts
    rope_theta=1_000_000.0,
))
