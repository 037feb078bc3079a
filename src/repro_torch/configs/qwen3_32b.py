"""qwen3-32b — [hf:Qwen/Qwen3-8B-family spec; hf].
64L d_model=5120 64H (GQA kv=8) d_ff=25600 vocab=151936, qk-norm."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen3-32b", family="dense", source="hf:Qwen/Qwen3-32B",
    n_layers=64, d_model=5120, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=25600, vocab=151_936,
    attention="full", qk_norm=True, rope_theta=1_000_000.0,
))
