"""Model + shape configuration schema for the assigned architectures."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int
    n_shared: int = 0            # always-on shared experts (DeepSeek-V2)
    dense_residual: bool = False  # parallel dense MLP (Arctic)
    first_dense: int = 0         # leading layers with dense FFN (DeepSeek-V2)
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora: int = 1536
    kv_lora: int = 512
    qk_nope: int = 128
    qk_rope: int = 64
    v_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 256


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    qkv_bias: bool = False
    swa_window: int = 0          # sliding-window attention; 0 = full
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    attn_period: int = 0         # hybrid: one attn layer per period (Jamba 8)
    attn_offset: int = 4         # position of the attn layer inside a period
    moe_period: int = 0          # MoE cadence within layers (Jamba 2)
    enc_layers: int = 0          # encdec only
    frontend: str = "none"       # none | audio | vision (stubbed)
    sub_quadratic: bool = False  # eligible for long_500k
    remat: bool = True
    remat_policy: str = "none"   # none | dots (checkpoint_policies knob)
    moe_capacity_override: float = 0.0  # hillclimb knob; 0 = use moe config
    mla_absorbed_prefill: bool = False  # hillclimb knob (DeepSeek prefill)
    source: str = ""             # provenance note [source; verified-tier]

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    def padded_vocab(self, mult: int = 32) -> int:
        """Embedding/head rows padded so the vocab dim shards over the model
        axis (e.g. InternVL's 92553).  Padded logits are masked to -inf;
        param_count() stays the logical count."""
        return -(-self.vocab // mult) * mult

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, ff, v = self.d_model, self.d_ff, self.vocab
        n = v * d  # embedding
        if not self.tie_embeddings:
            n += v * d
        for i in range(self.n_layers):
            n += self._block_params(i)
        if self.family == "encdec":
            for _ in range(self.enc_layers):
                n += self._attn_params() + self._mlp_params(ff) + 2 * d
            n += self.n_layers * self._attn_params()  # cross attention
        return n

    def active_param_count(self) -> int:
        """Active (per-token) parameters — the MoE-aware 6·N·D basis."""
        d, ff, v = self.d_model, self.d_ff, self.vocab
        n = v * d + (0 if self.tie_embeddings else v * d)
        for i in range(self.n_layers):
            n += self._block_params(i, active_only=True)
        if self.family == "encdec":
            for _ in range(self.enc_layers):
                n += self._attn_params() + self._mlp_params(ff) + 2 * d
            n += self.n_layers * self._attn_params()
        return n

    # -- helpers ------------------------------------------------------------
    def _attn_params(self) -> int:
        d, hd = self.d_model, self.hd
        if self.mla is not None:
            m = self.mla
            return (d * m.q_lora + m.q_lora * self.n_heads * (m.qk_nope + m.qk_rope)
                    + d * (m.kv_lora + m.qk_rope)
                    + m.kv_lora * self.n_heads * (m.qk_nope + m.v_dim)
                    + self.n_heads * m.v_dim * d)
        nq, nkv = self.n_heads, self.n_kv_heads
        return d * nq * hd + 2 * d * nkv * hd + nq * hd * d

    def _mlp_params(self, ff: int) -> int:
        return 3 * self.d_model * ff  # SwiGLU

    def _ssm_params(self) -> int:
        s = self.ssm
        d = self.d_model
        di = s.expand * d
        ng, ns = s.n_groups, s.d_state
        nh = di // s.head_dim
        return (d * (2 * di + 2 * ng * ns + nh)   # in_proj (z, x, B, C, dt)
                + s.d_conv * (di + 2 * ng * ns)   # conv
                + 2 * nh                           # A_log, D
                + di * d)                          # out_proj

    def _is_attn_layer(self, i: int) -> bool:
        if self.family == "ssm":
            return False
        if self.family == "hybrid":
            return i % self.attn_period == self.attn_offset
        return True

    def _is_moe_layer(self, i: int) -> bool:
        if self.moe is None:
            return False
        if i < self.moe.first_dense:
            return False
        if self.moe_period:
            return i % self.moe_period == self.moe_period - 1
        return True

    def _block_params(self, i: int, active_only: bool = False) -> int:
        d = self.d_model
        n = 2 * d  # norms
        if self._is_attn_layer(i):
            n += self._attn_params()
        else:
            n += self._ssm_params()
        if self._is_moe_layer(i):
            m = self.moe
            n_routed = m.top_k if active_only else m.n_experts
            n += n_routed * 3 * d * m.d_expert
            n += m.n_shared * 3 * d * m.d_expert
            n += d * m.n_experts  # router
            if m.dense_residual:
                n += self._mlp_params(self.d_ff)
        else:
            n += self._mlp_params(self.d_ff)
        return n


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4096, 256, "train"),
    ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    ShapeConfig("decode_32k", 32768, 128, "decode"),
    ShapeConfig("long_500k", 524288, 1, "decode"),
)


def get_shape(name: str) -> ShapeConfig:
    for s in SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether (arch, shape) is a valid dry-run cell (DESIGN.md §7)."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "long_500k skipped: pure full-attention arch (quadratic)"
    return True, ""
