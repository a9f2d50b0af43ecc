"""phi4-mini-3.8b [dense]: 32L d=3072 24H (GQA kv=8) d_ff=8192 vocab=200064.

RoPE + SwiGLU + GQA [arXiv:2412.08905]; field-for-field copy of
``src/repro/configs/phi4_mini_3p8b.py``.
"""
from repro_torch.models.model import ModelConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b",
    d_model=3072, n_layers=32, d_ff=8192, vocab_size=200064,
    n_heads=24, n_kv_heads=8, head_dim=128,
)

SMOKE = ModelConfig(
    name="phi4-mini-smoke",
    d_model=64, n_layers=4, d_ff=160, vocab_size=512,
    n_heads=4, n_kv_heads=2, head_dim=16, kv_chunk=32,
)
