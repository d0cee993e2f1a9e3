"""qwen2-7b — GQA kv=4 with QKV bias [arXiv:2407.10671; hf]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-7b", family="dense",
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4,
    d_ff=18944, vocab=152064, head_dim=128, qkv_bias=True,
    source="[arXiv:2407.10671; hf]",
)
