"""Architecture registry: ``--arch <id>`` resolves here (10 assigned archs +
the paper system's own store config)."""
from __future__ import annotations

import dataclasses
from typing import Dict, List

from .base import (MLAConfig, ModelConfig, MoEConfig, SHAPES, ShapeConfig,
                   SSMConfig, get_shape, shape_applicable)

_ARCH_MODULES = {
    "internvl2-26b": "internvl2_26b",
    "stablelm-1.6b": "stablelm_1_6b",
    "h2o-danube-3-4b": "h2o_danube3_4b",
    "qwen2-7b": "qwen2_7b",
    "qwen2-1.5b": "qwen2_1_5b",
    "whisper-small": "whisper_small",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "mamba2-2.7b": "mamba2_2_7b",
    "arctic-480b": "arctic_480b",
    "deepseek-v2-236b": "deepseek_v2_236b",
}

ARCH_IDS: List[str] = list(_ARCH_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    import importlib
    mod = importlib.import_module(f".{_ARCH_MODULES[arch]}", __package__)
    return mod.CONFIG


def reduced_config(arch: str) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests (layers/width shrunk,
    expert count reduced, tiny vocab — per the assignment brief)."""
    cfg = get_config(arch)
    changes: Dict = dict(
        n_layers=max(2, (cfg.attn_period or 2)),
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads
        else 4,
        d_ff=256 if cfg.d_ff else 0,
        vocab=512,
        head_dim=32,
        remat=False,
    )
    if cfg.family == "hybrid":
        changes["n_layers"] = cfg.attn_period  # one full period
    if cfg.family == "encdec":
        changes["enc_layers"] = 2
    if cfg.moe is not None:
        changes["moe"] = dataclasses.replace(
            cfg.moe, n_experts=4, top_k=min(cfg.moe.top_k, 2), d_expert=64)
    if cfg.mla is not None:
        changes["mla"] = MLAConfig(q_lora=64, kv_lora=32, qk_nope=32,
                                   qk_rope=16, v_dim=32)
        changes["n_kv_heads"] = changes["n_heads"]
    if cfg.ssm is not None:
        changes["ssm"] = dataclasses.replace(
            cfg.ssm, d_state=16, head_dim=32, chunk=8)
    return dataclasses.replace(cfg, **changes)


__all__ = ["ARCH_IDS", "get_config", "reduced_config", "ModelConfig",
           "MoEConfig", "MLAConfig", "SSMConfig", "SHAPES", "ShapeConfig",
           "get_shape", "shape_applicable"]
