"""musicgen-medium [audio]: 48L d=1536 24H (kv=24: MHA) d_ff=6144 vocab=2048.

Decoder-only over EnCodec tokens [arXiv:2306.05284].  The EnCodec frontend
is a stub: the caller supplies precomputed frame embeddings (B, S, d); a
single flattened-codebook head (vocab 2048).  Field-for-field copy of
``src/repro/configs/musicgen_medium.py``.
"""
from repro_torch.models.model import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    d_model=1536, n_layers=48, d_ff=6144, vocab_size=2048,
    n_heads=24, n_kv_heads=24, head_dim=64,
    frontend="audio_stub",
)

SMOKE = ModelConfig(
    name="musicgen-smoke",
    d_model=48, n_layers=3, d_ff=96, vocab_size=64,
    n_heads=3, n_kv_heads=3, head_dim=16,
    frontend="audio_stub", kv_chunk=32,
)
