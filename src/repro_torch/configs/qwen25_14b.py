"""qwen2.5-14b [dense]: 48L d=5120 40H (GQA kv=8) d_ff=13824 vocab=152064.

GQA + QKV bias (hf:Qwen/Qwen2.5 series); field-for-field copy of
``src/repro/configs/qwen25_14b.py``.
"""
from repro_torch.models.model import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-14b",
    d_model=5120, n_layers=48, d_ff=13824, vocab_size=152064,
    n_heads=40, n_kv_heads=8, head_dim=128,
    qkv_bias=True, rope_theta=1e6,
)

SMOKE = ModelConfig(
    name="qwen2.5-14b-smoke",
    d_model=64, n_layers=4, d_ff=128, vocab_size=256,
    n_heads=4, n_kv_heads=2, head_dim=16,
    qkv_bias=True, kv_chunk=32,
)
