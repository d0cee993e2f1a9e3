"""deepseek-v2-236b — MLA (kv_lora=512) + 2 shared / 160 routed top-6 MoE
[arXiv:2405.04434; hf].  d_ff=1536 per the assignment (the expert width);
layer 0 is dense per DeepSeek-V2 (first_dense=1).  MLA decode uses the
absorbed-matrix latent cache — 576 cached dims/token (models/layers.py)."""
from .base import ModelConfig, MLAConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b", family="moe",
    n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128,
    d_ff=1536, vocab=102400,
    mla=MLAConfig(q_lora=1536, kv_lora=512, qk_nope=128, qk_rope=64,
                  v_dim=128),
    moe=MoEConfig(n_experts=160, top_k=6, d_expert=1536, n_shared=2,
                  first_dense=1),
    mla_absorbed_prefill=True,  # latent-chunked prefill (§Perf A6: 8.4x peak)
    source="[arXiv:2405.04434; hf]",
)
