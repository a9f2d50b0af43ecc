"""internvl2-26b [vlm]: 48L d=6144 48H (GQA kv=8) d_ff=16384 vocab=92553.

InternViT + InternLM2 [arXiv:2404.16821].  The InternViT frontend is a
stub: the caller supplies 256 precomputed patch embeddings (B, 256, d),
projected by ``img_proj`` and prepended to the text tokens.  Field-for-field
copy of ``src/repro/configs/internvl2_26b.py``.
"""
from repro_torch.models.model import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    d_model=6144, n_layers=48, d_ff=16384, vocab_size=92553,
    n_heads=48, n_kv_heads=8, head_dim=128,
    frontend="vision_stub", n_image_tokens=256,
)

SMOKE = ModelConfig(
    name="internvl2-smoke",
    d_model=64, n_layers=3, d_ff=128, vocab_size=256,
    n_heads=4, n_kv_heads=2, head_dim=16,
    frontend="vision_stub", n_image_tokens=8, kv_chunk=32,
)
