"""internvl2-26b — InternViT + InternLM2 backbone [arXiv:2404.16821; hf].

VLM: the ViT frontend is a STUB — input_specs() supplies precomputed patch
embeddings (B, 256, d_model) prepended to the token stream (DESIGN.md §7).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b", family="dense",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=16384, vocab=92553, head_dim=128,
    frontend="vision",
    source="[arXiv:2404.16821; hf]",
)
