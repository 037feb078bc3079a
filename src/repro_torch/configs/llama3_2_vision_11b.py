"""llama-3.2-vision-11b — [hf:meta-llama/Llama-3.2-11B-Vision; unverified].
Text decoder backbone: 40L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256, gated cross-attention every 5th layer.  Vision frontend is a
STUB per the assignment: input_specs() provides precomputed patch embeddings
(B, 1601, 7680) which the model projects to d_model."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="llama-3.2-vision-11b", family="vlm",
    source="hf:meta-llama/Llama-3.2-11B-Vision",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab=128_256,
    cross_attn_every=5, vision_seq=1601, vision_dim=7680,
    rope_theta=500_000.0, block_period=5,
))
