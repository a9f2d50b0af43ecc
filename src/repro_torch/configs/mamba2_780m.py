"""mamba2-780m [ssm]: 48L d=1536 attn-free, vocab=50280, ssm_state=128.

SSD (state-space duality) [arXiv:2405.21060]; d_inner = 2*d, headdim 64
-> 48 SSD heads; no MLP (the mamba mixer is the whole layer).
Field-for-field copy of ``src/repro/configs/mamba2_780m.py``.
"""
from repro_torch.models.model import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    d_model=1536, n_layers=48, d_ff=0, vocab_size=50280,
    pattern=("mamba",),
    ssm_state=128, ssm_heads=48, ssm_head_dim=64,
    tie_embeddings=True,
    sub_quadratic=True,
)

SMOKE = ModelConfig(
    name="mamba2-smoke",
    d_model=64, n_layers=4, d_ff=0, vocab_size=256,
    pattern=("mamba",),
    ssm_state=16, ssm_heads=4, ssm_head_dim=32,
    ssd_chunk=16, tie_embeddings=True, sub_quadratic=True,
)
