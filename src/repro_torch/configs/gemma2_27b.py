"""gemma2-27b — [arXiv:2408.00118; hf].
46L d_model=4608 32H (GQA kv=16) d_ff=36864 vocab=256000.
Local(4096)/global alternating attention, attn softcap 50, final softcap 30,
sandwich RMSNorm with (1+g), GeGLU, tied embeddings, sqrt(d) embed scale."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="gemma2-27b", family="dense", source="arXiv:2408.00118",
    n_layers=46, d_model=4608, n_heads=32, n_kv_heads=16, head_dim=128,
    d_ff=36864, vocab=256_000,
    attention="local_global", window=4096,
    attn_softcap=50.0, logit_softcap=30.0,
    post_norm=True, rms_plus_one=True, act="gelu",
    tie_embeddings=True, rope_theta=10_000.0, block_period=2,
))
