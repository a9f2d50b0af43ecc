"""phi3.5-moe-42b-a6.6b [moe]: 32L d=4096 32H (GQA kv=8) expert_ff=6400,
vocab=32064, MoE 16e top-2 (hf:microsoft/Phi-3.5-MoE-instruct).

Field-for-field copy of ``src/repro/configs/phi35_moe_42b.py``.
"""
from repro_torch.models.model import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b",
    d_model=4096, n_layers=32, d_ff=6400, vocab_size=32064,
    n_heads=32, n_kv_heads=8, head_dim=128,
    pattern=("attn_moe",),
    n_experts=16, experts_per_token=2, moe_d_ff=6400,
)

SMOKE = ModelConfig(
    name="phi3.5-moe-smoke",
    d_model=64, n_layers=3, d_ff=96, vocab_size=256,
    n_heads=4, n_kv_heads=2, head_dim=16,
    pattern=("attn_moe",),
    n_experts=4, experts_per_token=2, moe_d_ff=96, kv_chunk=32,
)
