"""deepseek-moe-16b [moe]: 28L d=2048 16H (kv=16: MHA) expert_ff=1408,
vocab=102400, 2 shared + 64 routed top-6 fine-grained [arXiv:2401.06066].

Field-for-field copy of ``src/repro/configs/deepseek_moe_16b.py``.  The
published checkpoint's first layer is a dense MLP; the reference makes
every layer ``attn_moe``, and so does the port.
"""
from repro_torch.models.model import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    d_model=2048, n_layers=28, d_ff=1408, vocab_size=102400,
    n_heads=16, n_kv_heads=16, head_dim=128,
    pattern=("attn_moe",),
    n_experts=64, experts_per_token=6, n_shared_experts=2, moe_d_ff=1408,
)

SMOKE = ModelConfig(
    name="deepseek-moe-smoke",
    d_model=64, n_layers=3, d_ff=48, vocab_size=256,
    n_heads=4, n_kv_heads=4, head_dim=16,
    pattern=("attn_moe",),
    n_experts=8, experts_per_token=3, n_shared_experts=2, moe_d_ff=48,
    kv_chunk=32,
)
