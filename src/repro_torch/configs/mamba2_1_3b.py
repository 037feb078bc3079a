"""mamba2-1.3b — [arXiv:2405.21060; unverified].
48L d_model=2048, attention-free SSD blocks: d_inner=4096 (64 heads x 64),
d_state=128, n_groups=1, chunked dual form (chunk 256), vocab=50280."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="mamba2-1.3b", family="ssm", source="arXiv:2405.21060",
    n_layers=48, d_model=2048, d_ff=0, vocab=50_280,
    attention="none",
    ssm_state=128, ssm_heads=64, ssm_head_dim=64, ssm_chunk=256,
    tie_embeddings=True,
))
