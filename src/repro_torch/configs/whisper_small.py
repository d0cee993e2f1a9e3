"""whisper-small — enc-dec, conv frontend STUB [arXiv:2212.04356; unverified].

input_specs() provides precomputed frame embeddings (B, seq//2, d_model) for
the encoder; shapes drive the decoder at the stated seq_len (DESIGN.md §7 —
its 448-position trained limit is irrelevant to the shape-level dry-run).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small", family="encdec",
    n_layers=12, enc_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
    d_ff=3072, vocab=51865, head_dim=64,
    frontend="audio",
    source="[arXiv:2212.04356; unverified]",
)
