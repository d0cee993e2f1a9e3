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
  loss(cfg, model, batch)                          -> scalar CE (+ MoE aux)
  init_cache(cfg, b, s_max)                        -> cache
  prefill(cfg, model, batch, s_max)                -> (last logits, cache)
  decode_step(cfg, model, cache, token, pos)       -> (logits, cache)
``batch`` = {"tokens": (B,S) int [, "frontend": (B,Sf,d), "targets": (B,S)
int]}.  The cache is
``{"layers": [one dict a layer, in plan order], "cross": [one {k, v} a
decoder layer] (encdec only)}``; ``decode_step`` writes it in place and
returns it.  Both run under ``torch.inference_mode``.  ``loss`` is
differentiated by autograd (``loss(...).backward()`` or
``repro_torch.optim.accumulate_grads``); with ``cfg.remat`` each layer of
the period and of the encoder is recomputed in the backward pass
(``torch.utils.checkpoint``, non-reentrant), as the reference's nested
``jax.checkpoint`` does, and ``remat_policy="dots"`` keeps the outputs of
the unbatched matrix products (the reference's
``dots_with_no_batch_dims_saveable``).  Remat changes no bit of the
gradients.

The reference's ``partition.constrain`` calls stand where it makes them.
Off a mesh they, and every other mesh-only path (the vocab-split
embedding and target gather, the cache writes), are the old code; inside
``partition.shard_context(mesh)`` the weights, batch and cache are
DTensors and the dry run (``launch.dryrun``) traces one device's program.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from ..configs.base import ModelConfig
from ..core.types import resolve_device
from . import layers as L
from . import partition
from .moe import MoE, aux_load_balance_loss
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

def _dots_saveable():
    """Selective checkpointing that keeps the outputs of the unbatched
    matrix products (every ``Linear``) and recomputes the rest."""
    mm = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)

    def policy(ctx, op, *args, **kwargs):
        return (ckpt.CheckpointPolicy.MUST_SAVE if op in mm
                else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)
    return ckpt.create_selective_checkpoint_contexts(policy)


def _remat(cfg: ModelConfig, fn, *args):
    """``fn(*args)``, recomputed in the backward pass when ``cfg.remat``
    and autograd is recording."""
    if not (cfg.remat and torch.is_grad_enabled()):
        return fn(*args)
    context = (_dots_saveable if cfg.remat_policy == "dots"
               else ckpt.noop_context_fn)
    return ckpt.checkpoint(fn, *args, use_reentrant=False,
                           context_fn=context)


def _enc_block(cfg: ModelConfig, blk: Block, x: torch.Tensor) -> torch.Tensor:
    x = x + blk.attn(blk.norm1(x, cfg.norm_eps), causal=False)
    return blk.ffn(x, cfg.norm_eps)


def _encode(cfg: ModelConfig, model: Model,
            frames: torch.Tensor) -> torch.Tensor:
    """Encoder trunk over stub frame embeddings (bidirectional)."""
    x = frames
    for blk in model.enc:
        x = _remat(cfg, _enc_block, cfg, blk, x)
    return model.enc_norm(x, cfg.norm_eps)


class _PickLast(torch.autograd.Function):
    """``torch.gather(x, -1, idx[..., None])[..., 0]``, whose backward adds
    the gradient into a zero tensor in place, as torch's own gather
    backward does in a plain run.  Under any Python dispatch mode (the dry
    run's tracing modes, ``FlopCounterMode``) torch's backward takes its
    out-of-place ``scatter_add`` instead, which holds a second
    [tokens, vocab] float32 tensor at the training step's peak: a trace
    would then predict a peak the plain step never reaches."""

    @staticmethod
    def forward(ctx, x, idx):
        idx = idx.long()[..., None]
        ctx.save_for_backward(idx)
        ctx.x_shape = x.shape
        return torch.gather(x, -1, idx)[..., 0]

    @staticmethod
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        gx = g.new_zeros(ctx.x_shape).scatter_add_(-1, idx, g[..., None])
        return gx, None


def pick_last(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[..., idx]`` along the last dim, one index a row (``_PickLast``)."""
    return _PickLast.apply(x, idx)


def _vocab_gather(table, ids):
    """Rows ``ids`` of a vocab-split ``table`` (this device's rows): the
    rows this device holds, zeros for the rest."""
    n = table.shape[0]
    rel = ids.long() - partition.axis_rank("model") * n
    ok = (rel >= 0) & (rel < n)
    rows = table[rel.clamp(0, n - 1)]
    return rows * ok[..., None].to(rows.dtype)


def _vocab_pick(logits, tgt):
    """``logits[..., tgt]`` of vocab-split ``logits`` (this device's
    columns), zero where the column lies on another device."""
    n = logits.shape[-1]
    rel = tgt.long() - partition.axis_rank("model") * n
    ok = (rel >= 0) & (rel < n)
    got = pick_last(logits, rel.clamp(0, n - 1))
    return got * ok.to(got.dtype)


def _embed_rows(model: Model, ids: torch.Tensor) -> torch.Tensor:
    """The embedding rows of ``ids``.  On a mesh the table's vocab dim
    is split over ``model``: each device gathers the rows it holds and
    zeros the rest, and the partial sums are added over ``model``."""
    if partition.current_mesh() is None:
        return model.embed[ids.long()]
    split = partition.divides(model.embed.shape[0], "model")
    return partition.local(
        "embed", _vocab_gather, [model.embed, ids],
        [("model" if split else None, None),
         ("dp",) + (None,) * (ids.dim() - 1)],
        [("dp",) + (None,) * ids.dim()], partial="model" if split else None)


def _embed_tokens(cfg: ModelConfig, model: Model, tokens: torch.Tensor,
                  frontend: Optional[torch.Tensor]) -> torch.Tensor:
    x = _embed_rows(model, tokens)
    if frontend is not None and cfg.family != "encdec":
        x = torch.cat([frontend.to(x.dtype), x], dim=1)
    return x


def _logits(cfg: ModelConfig, model: Model, x: torch.Tensor) -> torch.Tensor:
    head = model.embed.t() if cfg.tie_embeddings else model.head
    x, head = L.promote(partition.gather_seq(x), partition.fsdp_gather(head))
    logits = x @ head
    vp = logits.shape[-1]
    if vp != cfg.vocab:  # mask padded vocab rows
        pad = torch.arange(vp, device=logits.device) >= cfg.vocab
        logits = logits.masked_fill(pad, -1e30)
    return logits


# --------------------------------------------------------------------------
# Training: the loss
# --------------------------------------------------------------------------

def _block_train(cfg: ModelConfig, blk: Block, x: torch.Tensor,
                 aux: torch.Tensor, cross: Optional[L.GQA] = None,
                 memory: Optional[torch.Tensor] = None):
    """One layer of the training forward pass; MoE layers add their
    load-balance loss to ``aux``."""
    eps = cfg.norm_eps
    # Block-boundary activations sequence-sharded over the model axis
    # (the reference's Megatron-SP layout).
    x = partition.constrain(x, "dp", "model", None)
    h = blk.norm1(x, eps)
    if blk.ldef.mixer == "ssm":
        x = x + ssd_train(blk.ssm, h, cfg)
    else:
        x = x + blk.attn(h)
    if cross is not None:
        kv = L.cross_kv(cross, memory, cfg)
        x = x + L.cross_attention(cross, blk.norm2(x, eps), kv, cfg)
    if blk.ldef.ffn == "mlp":
        x = x + blk.mlp(blk.norm2(x, eps))
    elif blk.ldef.ffn == "moe":
        h2 = blk.norm2(x, eps)
        x = x + blk.moe(h2)
        aux = aux + aux_load_balance_loss(blk.moe, h2, cfg)
    return x, aux


def _backbone_train(cfg: ModelConfig, model: Model, x: torch.Tensor,
                    memory: Optional[torch.Tensor] = None):
    """The decoder trunk: the prefix layers as they are, the period's
    under ``_remat``.  -> (final-normed x, summed MoE aux loss)."""
    n_prefix = len(plan_layers(cfg)[0])
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, blk in enumerate(model.blocks):
        cross = model.cross[i] if cfg.family == "encdec" else None
        if i < n_prefix:
            x, aux = _block_train(cfg, blk, x, aux, cross, memory)
        else:
            x, aux = _remat(cfg, _block_train, cfg, blk, x, aux, cross,
                            memory)
    return model.final_norm(x, cfg.norm_eps), aux


def loss(cfg: ModelConfig, model: Model,
         batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Mean next-token cross-entropy over every position but the last of
    each row (also when ``targets`` are given, as the reference masks),
    plus 0.01 x the summed MoE load-balance loss; float32 scalar.  The
    logits' max is taken from a detached copy (the reference's
    ``stop_gradient``), then ``nll = logsumexp - logit[target]``."""
    tokens = batch["tokens"]
    frontend = batch.get("frontend")
    x = _embed_tokens(cfg, model, tokens, frontend)
    memory = (_encode(cfg, model, frontend) if cfg.family == "encdec"
              else None)
    x, aux = _backbone_train(cfg, model, x, memory)
    n_front = (0 if frontend is None or cfg.family == "encdec"
               else frontend.shape[1])
    # The bf16 logits are not kept: only their float32 copy is read.
    lf = partition.constrain(_logits(cfg, model, x[:, n_front:, :]),
                             "dp", None, "model").float()
    tgt = batch.get("targets")
    if tgt is None:
        tgt = torch.cat([tokens[:, 1:], torch.zeros_like(tokens[:, :1])], 1)
    mx = partition.complete(lf.detach().amax(-1, keepdim=True))
    lse = torch.log(partition.complete(torch.exp(lf - mx).sum(-1))) + \
        mx[..., 0]
    if partition.current_mesh() is None:
        tgt_logit = pick_last(lf, tgt)
    else:  # the vocab dim is split over model: a masked gather
        split = partition.divides(lf.shape[-1], "model")
        tgt_logit = partition.local(
            "target_logit", _vocab_pick, [lf, tgt],
            [("dp", None, "model" if split else None), ("dp", None)],
            [("dp", None)], partial="model" if split else None)
    nll = lse - tgt_logit
    mask = torch.ones(nll.shape, dtype=nll.dtype, device=nll.device)
    mask[:, -1] = 0.0
    mask = partition.constrain(mask, "dp", None)
    ce = (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return ce + 0.01 * aux


# --------------------------------------------------------------------------
# Serving: prefill + decode
# --------------------------------------------------------------------------

def _attn_cache_width(cfg: ModelConfig, s_max: int) -> int:
    return min(s_max, cfg.swa_window) if cfg.swa_window else s_max


def _init_layer_cache(cfg: ModelConfig, ldef: LayerDef, b: int, s_max: int,
                      dtype, device):
    hd = cfg.hd
    zeros = partition.cache_zeros
    if ldef.mixer == "attn":
        w = _attn_cache_width(cfg, s_max)
        return {name: zeros(name, (b, w, cfg.n_kv_heads, hd), dtype, device)
                for name in ("k", "v")}
    if ldef.mixer == "mla":
        m = cfg.mla
        return {"ckv": zeros("ckv", (b, s_max, m.kv_lora), dtype, device),
                "kr": zeros("kr", (b, s_max, m.qk_rope), dtype, device)}
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
            for name in ("k", "v"):
                c[name] = partition.fill_prefix(c[name], kv[name])
            return y, c
        # SWA ring: keep the tail, aligned to slot = pos % w.
        roll = (s - w) % w

        def ring(t):
            return torch.roll(t[:, -w:], roll, dims=1)
        spec = ("dp", None, None, None)
        return y, {name: partition.constrain(
            partition.local("swa_ring", ring, [kv[name]], [spec], [spec])
            .to(c[name].dtype), *partition.cache_spec(name))
            for name in ("k", "v")}
    if blk.ldef.mixer == "mla":
        y, lat = blk.attn(h, return_cache=True)
        for name in ("ckv", "kr"):
            c[name] = partition.fill_prefix(c[name], lat[name])
        return y, c
    return ssd_train(blk.ssm, h, cfg, return_state=True,
                     state_dtype=c["conv"].dtype)


def _serving(fn):
    """Run ``fn`` under ``torch.inference_mode`` (under ``no_grad`` on a
    mesh: DTensor parameters cannot be read in inference mode)."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        mode = (torch.inference_mode() if partition.current_mesh() is None
                else torch.no_grad())
        with mode:
            return fn(*args, **kwargs)
    return run


@_serving
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


@_serving
def decode_step(cfg: ModelConfig, model: Model, cache: Cache,
                token: torch.Tensor, pos) -> Tuple[torch.Tensor, Cache]:
    """token: (B,) int; pos: the token's position (an int).  Returns
    (logits (B, padded vocab), the cache, written in place)."""
    pos = int(pos)
    eps = cfg.norm_eps
    x = _embed_rows(model, token)[:, None, :]
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
