"""qwen3-32b [dense]: 64L d=5120 64H (GQA kv=8) d_ff=25600 vocab=151936.

qk_norm + GQA, SwiGLU, RoPE (config family per hf:Qwen/Qwen3 series);
field-for-field copy of ``src/repro/configs/qwen3_32b.py``.
"""
from repro_torch.models.model import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b",
    d_model=5120, n_layers=64, d_ff=25600, vocab_size=151936,
    n_heads=64, n_kv_heads=8, head_dim=128,
    qk_norm=True, rope_theta=1e6,
)

SMOKE = ModelConfig(
    name="qwen3-32b-smoke",
    d_model=64, n_layers=4, d_ff=160, vocab_size=256,
    n_heads=4, n_kv_heads=2, head_dim=16,
    qk_norm=True, rope_theta=1e6, kv_chunk=32,
)
