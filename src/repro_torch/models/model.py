"""Model assembly: every assigned architecture from one layer plan.

The port of ``repro.models.model``'s serving path.  A config compiles to a
layer plan (``plan_layers``, the reference's: a ``prefix`` of leading
layers, e.g. DeepSeek-V2's dense first layer, then a ``period`` of layer
definitions repeated ``n_periods`` times).  The reference stacks each
period's parameters and scans over them; the port holds every layer in
plan order in one ``nn.ModuleList`` (``Model.blocks``) and loops over it in
Python.  The families: dense, MLA + MoE (DeepSeek-V2), dense-residual MoE
(Arctic), hybrid (Jamba), SSM (Mamba2), encoder-decoder (Whisper, a stub
frame frontend) and the vision-frontend prefix (InternVL2, stub patch
embeddings prepended to the tokens).

Public surface:
  Model(cfg, dtype=..., device=..., seed=...)     -> weights, random
  init_cache(cfg, b, s_max)                        -> cache
  prefill(cfg, model, batch, s_max)                -> (last logits, cache)
  decode_step(cfg, model, cache, token, pos)       -> (logits, cache)
``batch`` = {"tokens": (B,S) int [, "frontend": (B,Sf,d)]}.  The cache is
``{"layers": [one dict a layer, in plan order], "cross": [one {k, v} a
decoder layer] (encdec only)}``; ``decode_step`` writes it in place and
returns it.  Both run under ``torch.inference_mode``.  Training's ``loss``
is not ported yet.
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch
from torch import nn

from ..configs.base import ModelConfig
from ..core.types import resolve_device
from . import layers as L
from .moe import MoE
from .ssm import SSM, init_ssm_state, ssd_train, ssm_decode

Cache = Dict[str, Any]


class LayerDef(NamedTuple):
    mixer: str   # attn | mla | ssm
    ffn: str     # mlp | moe | none


def plan_layers(cfg: ModelConfig) -> Tuple[List[LayerDef], List[LayerDef], int]:
    """-> (prefix_defs, period_defs, n_periods)."""
    defs: List[LayerDef] = []
    for i in range(cfg.n_layers):
        if cfg.family == "ssm":
            mixer, ffn = "ssm", "none"
        elif cfg.family == "hybrid":
            mixer = "attn" if i % cfg.attn_period == cfg.attn_offset else "ssm"
            ffn = "moe" if cfg._is_moe_layer(i) else "mlp"
        else:
            mixer = "mla" if cfg.mla is not None else "attn"
            ffn = "moe" if cfg._is_moe_layer(i) else "mlp"
        defs.append(LayerDef(mixer, ffn))
    n_prefix = cfg.moe.first_dense if cfg.moe else 0
    prefix, rest = defs[:n_prefix], defs[n_prefix:]
    # Find the shortest period that tiles `rest`.
    for plen in range(1, len(rest) + 1):
        if len(rest) % plen == 0 and rest == rest[:plen] * (len(rest) // plen):
            return prefix, rest[:plen], len(rest) // plen
    return prefix, rest, 1


def layer_defs(cfg: ModelConfig) -> List[LayerDef]:
    """Every layer's definition in plan order: the prefix, then the period
    ``n_periods`` times (the order of ``Model.blocks``)."""
    prefix, period, n_periods = plan_layers(cfg)
    return prefix + period * n_periods


# --------------------------------------------------------------------------
# Parameters
# --------------------------------------------------------------------------

def _norm_cls(cfg: ModelConfig):
    return L.LayerNorm if cfg.family == "encdec" else L.RMSNorm


class Block(nn.Module):
    """One layer: ``norm1``, a mixer (``attn``: GQA or MLA; or ``ssm``),
    ``norm2`` and a feed-forward (``mlp``, ``moe`` or none)."""

    def __init__(self, cfg: ModelConfig, ldef: LayerDef, init: L.Init):
        super().__init__()
        norm = _norm_cls(cfg)
        self.ldef = ldef
        self.norm1 = norm(cfg.d_model, init)
        self.norm2 = norm(cfg.d_model, init)
        if ldef.mixer == "attn":
            self.attn = L.GQA(cfg, init)
        elif ldef.mixer == "mla":
            self.attn = L.MLA(cfg, init)
        else:
            self.ssm = SSM(cfg, init)
        if ldef.ffn == "mlp":
            self.mlp = L.MLP(cfg.d_model, cfg.d_ff, init)
        elif ldef.ffn == "moe":
            self.moe = MoE(cfg, init)

    def ffn(self, x: torch.Tensor, eps: float) -> torch.Tensor:
        """``x`` plus the feed-forward of its ``norm2``."""
        if self.ldef.ffn == "none":
            return x
        h2 = self.norm2(x, eps)
        return x + (self.mlp(h2) if self.ldef.ffn == "mlp" else self.moe(h2))


class Model(nn.Module):
    """Every weight of one architecture, with the reference's scales:
    ``embed`` [padded vocab, d] (0.02), ``head`` [d, padded vocab] unless
    tied, ``final_norm``, ``blocks`` in plan order and, for encdec, the
    encoder ``enc``, ``enc_norm``, the cross attentions ``cross`` (one a
    decoder layer) and ``cross_norm``.  Random values come from a
    generator on ``device`` seeded by ``seed``; ``device=None`` is the
    current CUDA card (and raises without one).  Parameter names are the
    reference's pytree paths, its stacked layers unstacked."""

    def __init__(self, cfg: ModelConfig, *, dtype=torch.bfloat16,
                 device=None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        init = L.Init(dtype, dev, gen)
        d, vp = cfg.d_model, cfg.padded_vocab()
        norm = _norm_cls(cfg)
        self.cfg = cfg
        self.embed = init.normal((vp, d), 0.02)
        self.final_norm = norm(d, init)
        self.head = None if cfg.tie_embeddings else init.normal((d, vp),
                                                                d ** -0.5)
        self.blocks = nn.ModuleList(Block(cfg, ld, init)
                                    for ld in layer_defs(cfg))
        if cfg.family == "encdec":
            prefix, period, _ = plan_layers(cfg)
            # Every decoder layer takes a cross attention (the reference
            # gives one to the first layer of each period).
            assert not prefix and len(period) == 1
            self.enc = nn.ModuleList(Block(cfg, LayerDef("attn", "mlp"),
                                           init)
                                     for _ in range(cfg.enc_layers))
            self.enc_norm = norm(d, init)
            self.cross = nn.ModuleList(L.GQA(cfg, init)
                                       for _ in range(cfg.n_layers))
            self.cross_norm = norm(d, init)


# --------------------------------------------------------------------------
# Forward passes
# --------------------------------------------------------------------------

def _encode(cfg: ModelConfig, model: Model,
            frames: torch.Tensor) -> torch.Tensor:
    """Encoder trunk over stub frame embeddings (bidirectional)."""
    x = frames
    for blk in model.enc:
        x = x + blk.attn(blk.norm1(x, cfg.norm_eps), causal=False)
        x = blk.ffn(x, cfg.norm_eps)
    return model.enc_norm(x, cfg.norm_eps)


def _embed_tokens(cfg: ModelConfig, model: Model, tokens: torch.Tensor,
                  frontend: Optional[torch.Tensor]) -> torch.Tensor:
    x = model.embed[tokens.long()]
    if frontend is not None and cfg.family != "encdec":
        x = torch.cat([frontend.to(x.dtype), x], dim=1)
    return x


def _logits(cfg: ModelConfig, model: Model, x: torch.Tensor) -> torch.Tensor:
    head = model.embed.t() if cfg.tie_embeddings else model.head
    x, head = L.promote(x, head)
    logits = x @ head
    vp = logits.shape[-1]
    if vp != cfg.vocab:  # mask padded vocab rows
        pad = torch.arange(vp, device=logits.device) >= cfg.vocab
        logits = logits.masked_fill(pad, -1e30)
    return logits


# --------------------------------------------------------------------------
# Serving: prefill + decode
# --------------------------------------------------------------------------

def _attn_cache_width(cfg: ModelConfig, s_max: int) -> int:
    return min(s_max, cfg.swa_window) if cfg.swa_window else s_max


def _init_layer_cache(cfg: ModelConfig, ldef: LayerDef, b: int, s_max: int,
                      dtype, device):
    hd = cfg.hd
    if ldef.mixer == "attn":
        w = _attn_cache_width(cfg, s_max)
        return {"k": torch.zeros((b, w, cfg.n_kv_heads, hd), dtype=dtype,
                                 device=device),
                "v": torch.zeros((b, w, cfg.n_kv_heads, hd), dtype=dtype,
                                 device=device)}
    if ldef.mixer == "mla":
        m = cfg.mla
        return {"ckv": torch.zeros((b, s_max, m.kv_lora), dtype=dtype,
                                   device=device),
                "kr": torch.zeros((b, s_max, m.qk_rope), dtype=dtype,
                                  device=device)}
    return init_ssm_state(cfg, b, dtype, device)


def init_cache(cfg: ModelConfig, b: int, s_max: int, dtype=L.CACHE_DTYPE,
               device=None) -> Cache:
    """Every layer's empty cache.  An encdec model's cross-attention k/v
    come from its encoder: ``prefill`` adds them."""
    dev = resolve_device(device)
    return {"layers": [_init_layer_cache(cfg, ld, b, s_max, dtype, dev)
                       for ld in layer_defs(cfg)]}


def _mixer_prefill(cfg: ModelConfig, blk: Block, h: torch.Tensor, c):
    """The mixer of one layer over the whole prompt, and its cache entry
    filled from ``c`` (that layer's empty cache)."""
    s = h.shape[1]
    if blk.ldef.mixer == "attn":
        y, kv = blk.attn(h, return_kv=True)
        w = c["k"].shape[1]
        if w >= s:
            c["k"][:, :s] = kv["k"].to(c["k"].dtype)
            c["v"][:, :s] = kv["v"].to(c["v"].dtype)
            return y, c
        # SWA ring: keep the tail, aligned to slot = pos % w.
        roll = (s - w) % w
        return y, {name: torch.roll(kv[name][:, -w:], roll, dims=1)
                   .to(c[name].dtype) for name in ("k", "v")}
    if blk.ldef.mixer == "mla":
        y, lat = blk.attn(h, return_cache=True)
        c["ckv"][:, :s] = lat["ckv"].to(c["ckv"].dtype)
        c["kr"][:, :s] = lat["kr"].to(c["kr"].dtype)
        return y, c
    return ssd_train(blk.ssm, h, cfg, return_state=True,
                     state_dtype=c["conv"].dtype)


@torch.inference_mode()
def prefill(cfg: ModelConfig, model: Model, batch: Dict[str, torch.Tensor],
            s_max: Optional[int] = None, cache_dtype=L.CACHE_DTYPE):
    """Run the whole prompt; return (last logits [B, padded vocab], the
    filled cache).  A frontend prefix rides in the cache: it takes the
    first positions, so the first decoded token's position is the prefix's
    length plus the prompt's.  The cache is bfloat16, as the reference's;
    ``cache_dtype=torch.float32`` keeps every value unrounded (a decode
    step rounds each new token's k/v or conv input to the cache's dtype
    and reads it back, so two devices can then differ by a bfloat16 step,
    which holding the card to the CPU at float32's tolerance must avoid)."""
    tokens = batch["tokens"]
    frontend = batch.get("frontend")
    b = tokens.shape[0]
    x = _embed_tokens(cfg, model, tokens, frontend)
    s_max = max(s_max or tokens.shape[1], x.shape[1])
    cache = init_cache(cfg, b, s_max, dtype=cache_dtype, device=x.device)
    eps = cfg.norm_eps
    if cfg.family == "encdec":
        memory = _encode(cfg, model, frontend)
        cache["cross"] = [L.cross_kv(cp, memory, cfg) for cp in model.cross]
    for i, blk in enumerate(model.blocks):
        y, cache["layers"][i] = _mixer_prefill(cfg, blk, blk.norm1(x, eps),
                                               cache["layers"][i])
        x = x + y
        if cfg.family == "encdec":
            x = x + L.cross_attention(model.cross[i], blk.norm2(x, eps),
                                      cache["cross"][i], cfg)
        x = blk.ffn(x, eps)
    x = model.final_norm(x, eps)
    return _logits(cfg, model, x[:, -1:, :])[:, 0, :], cache


@torch.inference_mode()
def decode_step(cfg: ModelConfig, model: Model, cache: Cache,
                token: torch.Tensor, pos) -> Tuple[torch.Tensor, Cache]:
    """token: (B,) int; pos: the token's position (an int).  Returns
    (logits (B, padded vocab), the cache, written in place)."""
    pos = int(pos)
    eps = cfg.norm_eps
    x = model.embed[token.long()][:, None, :]
    layers = cache["layers"]
    for i, blk in enumerate(model.blocks):
        h = blk.norm1(x, eps)
        if blk.ldef.mixer == "attn":
            y, layers[i] = L.gqa_decode(blk.attn, h, layers[i], pos, cfg)
        elif blk.ldef.mixer == "mla":
            y, layers[i] = L.mla_decode(blk.attn, h, layers[i], pos, cfg)
        else:
            y, layers[i] = ssm_decode(blk.ssm, h, layers[i], cfg)
        x = x + y
        if cfg.family == "encdec":
            x = x + L.cross_attention(model.cross[i], blk.norm2(x, eps),
                                      cache["cross"][i], cfg)
        x = blk.ffn(x, eps)
    x = model.final_norm(x, eps)
    return _logits(cfg, model, x)[:, 0, :], cache
