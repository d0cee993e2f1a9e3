"""jamba-v0.1-52b — Mamba+attention 1:7 interleave, MoE 16e top-2
[arXiv:2403.19887; hf].  Jamba's SSM layers are Mamba-1; this framework
substitutes the Mamba2 SSD block as the uniform TPU-efficient SSM primitive
(DESIGN.md §2.1).  Hybrid => long_500k runs (4 attention layers' KV sharded,
28 SSM layers carry O(1) state)."""
from .base import ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b", family="hybrid",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=65536, head_dim=128,
    attn_period=8, attn_offset=4, moe_period=2,
    moe=MoEConfig(n_experts=16, top_k=2, d_expert=14336),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=64, n_groups=1,
                  chunk=256),
    sub_quadratic=True,
    source="[arXiv:2403.19887; hf]",
)
