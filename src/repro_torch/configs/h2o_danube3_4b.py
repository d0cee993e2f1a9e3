"""h2o-danube-3-4b — llama+mistral mix with sliding-window attention
[arXiv:2401.16818; unverified].  SWA makes it sub-quadratic: long_500k runs
with a windowed (ring-buffer) KV cache."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b", family="dense",
    n_layers=24, d_model=3840, n_heads=32, n_kv_heads=8,
    d_ff=10240, vocab=32000, head_dim=120,
    swa_window=4096, sub_quadratic=True,
    source="[arXiv:2401.16818; unverified]",
)
