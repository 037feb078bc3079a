"""deepseek-v3-671b — [arXiv:2412.19437; hf].
61L d_model=7168, MLA 128H (q_lora 1536, kv_lora 512, nope 128, rope 64,
v 128), MoE: 256 routed experts top-8 + 1 shared, expert d_ff=2048, first 3
layers dense (d_ff=18432), vocab=129280.  MTP head available via use_mtp
(off in dry-run cells so HLO FLOPs match 6*N_active*D accounting)."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="deepseek-v3-671b", family="moe", source="arXiv:2412.19437",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128, head_dim=128,
    d_ff=18432, vocab=129_280,
    use_mla=True, q_lora_rank=1536, kv_lora_rank=512,
    qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
    n_experts=256, n_shared_experts=1, top_k=8, moe_d_ff=2048,
    n_dense_layers=3, capacity_factor=1.25,
    moe_expert_parallel=True,   # §Perf iter 5 refuted TP-within-expert;
    #                             EP + scatter-free dispatch is the best
    #                             GSPMD layout (see EXPERIMENTS.md §Perf)

    rope_theta=10_000.0,
))
