"""stablelm-2-1.6b — [hf:stabilityai/stablelm-2-1_6b; unverified].
24L d_model=2048 32H (MHA, kv=32) d_ff=5632 vocab=100352.
LayerNorm, partial rotary (25%), gated SiLU MLP."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="stablelm-1.6b", family="dense",
    source="hf:stabilityai/stablelm-2-1_6b",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=5632, vocab=100352,
    attention="full", norm="layernorm", act="silu",
    rope_theta=10_000.0, rotary_pct=0.25, norm_eps=1e-5,
))
