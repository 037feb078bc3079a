"""hubert-xlarge — [arXiv:2106.07447; unverified].
Encoder-only transformer backbone: 48L d_model=1280 16H (MHA) d_ff=5120,
vocab=504 (masked-unit prediction targets).  The conv waveform frontend is a
STUB per the assignment: input_specs() provides precomputed 512-d frame
embeddings; the model applies the feature projection 512 -> 1280."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="hubert-xlarge", family="audio", source="arXiv:2106.07447",
    n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16, head_dim=80,
    d_ff=5120, vocab=504,
    attention="full", norm="layernorm", act="gelu",
    is_encoder=True, frontend_dim=512, rotary_pct=1.0, norm_eps=1e-5,
))
