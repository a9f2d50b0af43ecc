"""jamba-v0.1-52b [hybrid]: 32L d=4096 32H (GQA kv=8) d_ff=14336,
vocab=65536, MoE 16e top-2; Mamba:attn 7:1 interleave [arXiv:2403.19887].

Period-8 pattern (1 attn per 8 layers, MoE every other layer), 4 repeats.
Mamba blocks use the SSD machinery (d_state=128; Jamba's original uses
Mamba-1 d_state=16).  Field-for-field copy of
``src/repro/configs/jamba_v01_52b.py``.
"""
from repro_torch.models.model import ModelConfig

_PATTERN = ("mamba", "mamba_moe", "mamba", "mamba_moe",
            "attn", "mamba_moe", "mamba", "mamba_moe")

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    d_model=4096, n_layers=32, d_ff=14336, vocab_size=65536,
    n_heads=32, n_kv_heads=8, head_dim=128,
    pattern=_PATTERN,
    n_experts=16, experts_per_token=2, moe_d_ff=14336,
    ssm_state=128, ssm_heads=128, ssm_head_dim=64,
    sub_quadratic=True,
)

SMOKE = ModelConfig(
    name="jamba-smoke",
    d_model=64, n_layers=8, d_ff=96, vocab_size=256,
    n_heads=4, n_kv_heads=2, head_dim=16,
    pattern=_PATTERN,
    n_experts=4, experts_per_token=2, moe_d_ff=96,
    ssm_state=16, ssm_heads=4, ssm_head_dim=16,
    ssd_chunk=16, kv_chunk=32, sub_quadratic=True,
)
