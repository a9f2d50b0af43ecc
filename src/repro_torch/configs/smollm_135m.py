"""smollm-135m [dense]: 30L d=576 9H (GQA kv=3) d_ff=1536 vocab=49152.

Llama-architecture small model (hf:HuggingFaceTB/SmolLM-135M), tied
embeddings; field-for-field copy of ``src/repro/configs/smollm_135m.py``.
"""
from repro_torch.models.model import ModelConfig

CONFIG = ModelConfig(
    name="smollm-135m",
    d_model=576, n_layers=30, d_ff=1536, vocab_size=49152,
    n_heads=9, n_kv_heads=3, head_dim=64,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="smollm-135m-smoke",
    d_model=48, n_layers=3, d_ff=128, vocab_size=256,
    n_heads=3, n_kv_heads=1, head_dim=16,
    tie_embeddings=True, kv_chunk=32,
)
