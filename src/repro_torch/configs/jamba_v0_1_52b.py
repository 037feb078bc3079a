"""jamba-v0.1-52b — [arXiv:2403.19887; hf].
32L d_model=4096, attention every 8th layer (1:7 attn:mamba, GQA 32H kv=8),
MoE every 2nd layer (16 experts top-2, d_ff=14336).  The SSM layers use the
Mamba2/SSD block (DESIGN.md: documented substitution for Jamba's Mamba-1 —
same state-space recurrence, TPU-friendly chunked dual form), d_state=16,
d_inner=8192 (128 heads x 64)."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="jamba-v0.1-52b", family="hybrid", source="arXiv:2403.19887",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab=65_536,
    n_experts=16, top_k=2, moe_d_ff=14336, moe_every=2,
    attn_every=8, ssm_state=16, ssm_heads=128, ssm_head_dim=64,
    rope_theta=1_000_000.0, block_period=8,
))
