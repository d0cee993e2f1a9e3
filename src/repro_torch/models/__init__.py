"""The LM zoo of the assigned architectures, on PyTorch: the port of
``repro.models`` (layers, MoE, SSD, model assembly; serving and the
training loss)."""
from . import layers, moe, ssm
from .model import (Block, LayerDef, Model, decode_step, init_cache,
                    layer_defs, loss, plan_layers, prefill)

__all__ = ["layers", "moe", "ssm", "Block", "LayerDef", "Model",
           "decode_step", "init_cache", "layer_defs", "loss", "plan_layers",
           "prefill"]
