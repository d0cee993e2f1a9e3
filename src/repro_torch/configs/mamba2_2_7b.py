"""mamba2-2.7b — SSD (state-space duality), attention-free
[arXiv:2405.21060; unverified].  ssm_state=128; long_500k decodes with O(1)
recurrent state."""
from .base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b", family="ssm",
    n_layers=64, d_model=2560, n_heads=1, n_kv_heads=1,
    d_ff=0, vocab=50280,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, n_groups=1,
                  chunk=256),
    sub_quadratic=True, tie_embeddings=True,
    source="[arXiv:2405.21060; unverified]",
)
