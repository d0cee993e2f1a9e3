"""Core neural layers: norms, RoPE, GQA/SWA/MLA attention, SwiGLU MLP.

The port of ``repro.models.layers``.  Each parameter dict of the reference
is an ``nn.Module`` here whose attribute names are the dict's keys (``wq.w``,
``norm1.scale``, ...), so ``repro_torch.convert.lm_params_to_torch`` loads a
reference pytree by name; the functions on tensors keep the reference's
names and arguments.  ``Linear`` computes ``x @ w`` with ``w`` of shape
``[d_in, d_out]``, as the reference does.

Two rules of JAX's type promotion are kept by hand, since the bfloat16
results depend on them:

* a Python scalar is weakly typed in JAX: ``x * scale`` and ``logits +
  mask`` stay in ``x``'s dtype.  The mask is a ``masked_fill`` here, and a
  scale is rounded to the tensor's dtype first (``_weak``);
* a product of a bfloat16 and a float32 tensor is float32 in JAX, where
  ``torch.einsum`` and ``@`` refuse mixed dtypes: ``einsum`` and
  ``Linear`` promote their operands first.  The decode caches are bfloat16
  whatever the weights (the reference's ``init_cache`` default).

Attention has the reference's two softmax paths: ``full_attention`` (one
(S, S) product) and ``chunked_attention`` (a loop over key chunks of
``_CHUNK`` with a running max, sum and accumulator, in float32);
``attention_any`` takes the chunked one when there are more than 8,192
keys.  Neither calls the port's ``flash_attention`` kernel: the reference's
models never call its Pallas kernel.  The ``partition.constrain`` calls
stand where the reference makes them: they return their input outside a
mesh, and on a dry run's device mesh they redistribute the DTensor
activations; ``split_last`` splits heads off a projection (on a mesh it
gathers a dim that the model axis cannot split evenly first).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ModelConfig
from .partition import (constrain, constrain_scores, divides, fsdp_gather,
                        gather_seq, local, merge_last, settle, softmax,
                        split_keys, split_last, whole_last, write_slot)

Cache = Dict[str, torch.Tensor]
_CHUNK = 2048
_NEG = -1e30
_PAD_POS = 1 << 30  # sentinel key position: always masked
#: The dtype of every decode cache (k/v, MLA latents, SSM conv tail).
CACHE_DTYPE = torch.bfloat16


class Init(NamedTuple):
    """How a module makes its parameters: their dtype, the device they
    live on and the generator their random values come from."""

    dtype: torch.dtype
    device: torch.device
    gen: Optional[torch.Generator]

    def normal(self, shape, scale: float, dtype=None) -> nn.Parameter:
        """``normal(shape, dtype) * scale``, as ``jax.random.normal``
        draws it in the reference (the product in ``dtype``)."""
        dt = dtype or self.dtype
        w = torch.randn(shape, generator=self.gen, device=self.device,
                        dtype=dt) * _weak(scale, dt)
        return nn.Parameter(w)

    def zeros(self, shape, dtype=None) -> nn.Parameter:
        return nn.Parameter(torch.zeros(shape, device=self.device,
                                        dtype=dtype or self.dtype))

    def ones(self, shape, dtype=None) -> nn.Parameter:
        return nn.Parameter(torch.ones(shape, device=self.device,
                                       dtype=dtype or self.dtype))


def _weak(scale: float, dtype: torch.dtype) -> float:
    """A Python scalar as JAX applies it to an array of ``dtype``: rounded
    to that dtype first."""
    return float(torch.tensor(scale, dtype=dtype))


def promote(*ts):
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return [t if t.dtype == dt else t.to(dt) for t in ts]


def einsum(eq: str, *operands) -> torch.Tensor:
    """``torch.einsum`` with JAX's promotion: mixed operands are cast to
    their common dtype first."""
    return torch.einsum(eq, *promote(*operands))


# ----------------------------------------------------------------- basics --
class Linear(nn.Module):
    """``y = x @ w (+ b)``; ``w`` is ``[d_in, d_out]``, drawn with scale
    ``d_in ** -0.5``."""

    def __init__(self, d_in: int, d_out: int, *, bias: bool = False,
                 init: Init, dtype=None):
        super().__init__()
        self.w = init.normal((d_in, d_out), d_in ** -0.5, dtype)
        self.b = init.zeros((d_out,), dtype) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # On a mesh the sequence is gathered before the product and the
        # partial sums reduced after it (sequence parallelism).
        x = gather_seq(x)
        x, w = promote(x, fsdp_gather(self.w))
        y = settle(x @ w)
        if self.b is not None:
            y = y + fsdp_gather(self.b)
        return y


class RMSNorm(nn.Module):
    def __init__(self, d: int, init: Init):
        super().__init__()
        self.scale = init.ones((d,))

    def forward(self, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
        return rmsnorm(self.scale, x, eps)


def rmsnorm(scale: torch.Tensor, x: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """The variance in float32; its rsqrt cast to ``x``'s dtype, multiplied
    in that dtype, then scaled (the reference's order)."""
    x = whole_last(x)
    var = x.float().square().mean(-1, keepdim=True)
    return (x * torch.rsqrt(var + eps).to(x.dtype)) * scale


class LayerNorm(nn.Module):
    def __init__(self, d: int, init: Init):
        super().__init__()
        self.scale = init.ones((d,))
        self.bias = init.zeros((d,))

    def forward(self, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
        x = whole_last(x)
        xf = x.float()
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + eps)
        return y.to(x.dtype) * self.scale + self.bias


# ------------------------------------------------------------------- rope --
def rope_freqs(hd: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=device) / hd))


def apply_rope(x: torch.Tensor, pos: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., S, H, hd]; pos: int [S].  Pairs the interleaved lanes
    ``x[..., 0::2]`` and ``x[..., 1::2]`` (not the rotate-half layout)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)
    ang = pos[..., None].float() * freqs                  # [S, hd/2]
    cos = torch.cos(ang)[..., None, :]                    # [S, 1, hd/2]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x1 * sin + x2 * cos
    return torch.stack([y1, y2], dim=-1).reshape(x.shape).to(x.dtype)


def _arange(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=device)


# -------------------------------------------------------------- attention --
def _mask_ok(qpos, kpos, *, causal: bool, window: int) -> torch.Tensor:
    """Where a query may see a key: the reference's ``_mask_bias`` is 0
    there and -1e30 elsewhere."""
    ok = kpos[None, :] < _PAD_POS
    if causal:
        ok = ok & (kpos[None, :] <= qpos[:, None])
    if window:
        ok = ok & (kpos[None, :] > qpos[:, None] - window)
    return ok


def full_attention(q, k, v, qpos, kpos, *, causal: bool, window: int,
                   scale: float) -> torch.Tensor:
    """q: [B,S,Hq,hd]; k/v: [B,Skv,Hkv,hd]."""
    hq, hkv = q.shape[2], k.shape[2]
    if hq != hkv:
        k = k.repeat_interleave(hq // hkv, dim=2)
        v = v.repeat_interleave(hq // hkv, dim=2)
    k, v = split_keys(k, hq), split_keys(v, hq)
    logits = einsum("bqhd,bkhd->bhqk", q, k)
    logits = logits * _weak(scale, logits.dtype)
    # Scores sharded (batch x heads or keys): the peak-memory hot spot.
    logits = constrain_scores(logits)
    ok = _mask_ok(qpos, kpos, causal=causal, window=window)
    logits = logits.masked_fill(~ok, _NEG)
    p = softmax(logits, q.dtype)
    return settle(einsum("bhqk,bkhd->bqhd", p, v))


def _online_softmax_step(carry, s, vt):
    """One key chunk of the streaming softmax: scores ``s`` [B,H,Q,K]
    (overwritten) and values ``vt`` [B,K,H,D], both float32."""
    m, l, acc = carry
    m_new = torch.maximum(m, s.amax(-1))
    p = s.sub_(m_new[..., None]).exp_()       # in place: s is not read again
    alpha = torch.exp(m - m_new)
    l_new = l * alpha + p.sum(-1)
    acc_new = acc * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vt)
    return m_new, l_new, acc_new


def _online_softmax_init(b, h, sq, dv, device):
    return (torch.full((b, h, sq), _NEG, dtype=torch.float32, device=device),
            torch.zeros((b, h, sq), dtype=torch.float32, device=device),
            torch.zeros((b, h, sq, dv), dtype=torch.float32, device=device))


def chunked_attention(q, k, v, qpos, kpos, *, causal: bool, window: int,
                      scale: float) -> torch.Tensor:
    """Streaming-softmax attention over key chunks of ``_CHUNK``, in
    float32 (O(S·chunk) memory).  Keys are padded to a chunk multiple with
    ``_PAD_POS`` positions, which are always masked."""
    b, sq, hq, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    hdv = v.shape[-1]  # may differ from hd (MLA)
    if hq != hkv:
        k = k.repeat_interleave(hq // hkv, dim=2)
        v = v.repeat_interleave(hq // hkv, dim=2)
    pad = (-skv) % _CHUNK
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        kpos = torch.cat([kpos, torch.full((pad,), _PAD_POS,
                                           dtype=kpos.dtype,
                                           device=kpos.device)])
        skv += pad
    qf = q.float() * scale
    carry = _online_softmax_init(b, hq, sq, hdv, q.device)
    for t in range(skv // _CHUNK):
        sl = slice(t * _CHUNK, (t + 1) * _CHUNK)
        s = torch.einsum("bqhd,bkhd->bhqk", qf, k[:, sl].float())
        s = constrain_scores(s)
        ok = _mask_ok(qpos, kpos[sl], causal=causal, window=window)
        s = s.masked_fill_(~ok, _NEG)
        carry = _online_softmax_step(carry, s, v[:, sl].float())
    m, l, acc = carry
    out = acc / torch.clamp(l, min=1e-20)[..., None]
    return out.transpose(1, 2).to(q.dtype)


def attention_any(q, k, v, qpos, kpos, *, causal: bool, window: int,
                  scale: float) -> torch.Tensor:
    hq = q.shape[2]
    if divides(hq, "model"):
        # On a mesh whose model axis splits the heads, each device attends
        # with its own heads over its own batch rows: no collective.
        if k.shape[2] != hq:
            k = k.repeat_interleave(hq // k.shape[2], dim=2)
            v = v.repeat_interleave(hq // v.shape[2], dim=2)
        spec = ("dp", None, "model", None)
        return local("attention", lambda q_, k_, v_: attention_any(
            q_, k_, v_, qpos, kpos, causal=causal, window=window,
            scale=scale), [q, k, v], [spec] * 3, [spec])
    if k.shape[1] > 8192:
        return chunked_attention(q, k, v, qpos, kpos, causal=causal,
                                 window=window, scale=scale)
    return full_attention(q, k, v, qpos, kpos, causal=causal, window=window,
                          scale=scale)


# ------------------------------------------------------------- GQA block ---
class GQA(nn.Module):
    """Grouped-query attention (sliding-window when ``cfg.swa_window``)."""

    def __init__(self, cfg: ModelConfig, init: Init):
        super().__init__()
        d, hd = cfg.d_model, cfg.hd
        self.cfg = cfg
        self.wq = Linear(d, cfg.n_heads * hd, bias=cfg.qkv_bias, init=init)
        self.wk = Linear(d, cfg.n_kv_heads * hd, bias=cfg.qkv_bias,
                         init=init)
        self.wv = Linear(d, cfg.n_kv_heads * hd, bias=cfg.qkv_bias,
                         init=init)
        self.wo = Linear(cfg.n_heads * hd, d, init=init)

    def qkv(self, x: torch.Tensor, pos: torch.Tensor):
        """Projected q, k, v of ``x`` [B,S,d], q and k rotated to ``pos``:
        q [B,S,Hq,hd], k and v [B,S,Hkv,hd]."""
        cfg = self.cfg
        b, s, _ = x.shape
        hd = cfg.hd
        q = split_last(self.wq(x), cfg.n_heads, hd)
        k = split_last(self.wk(x), cfg.n_kv_heads, hd)
        v = split_last(self.wv(x), cfg.n_kv_heads, hd)
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
        return q, k, v

    def forward(self, x: torch.Tensor, causal: bool = True,
                return_kv: bool = False):
        """The reference's ``gqa_train``: the whole sequence at once."""
        cfg = self.cfg
        b, s, _ = x.shape
        pos = _arange(s, x.device)
        q, k, v = self.qkv(x, pos)
        o = attention_any(q, k, v, pos, pos, causal=causal,
                          window=cfg.swa_window if causal else 0,
                          scale=cfg.hd ** -0.5)
        y = self.wo(merge_last(o))
        if return_kv:
            return y, {"k": k, "v": v}
        return y


def gqa_decode(p: GQA, x: torch.Tensor, cache: Cache, pos: int,
               cfg: ModelConfig) -> Tuple[torch.Tensor, Cache]:
    """One-token decode.  cache: {k: [B,W,Hkv,hd], v: ...}; W is the whole
    context or the SWA window (a ring buffer: the token at position ``pos``
    goes to slot ``pos % W``).  The cache is written in place and
    returned."""
    b, s, _ = x.shape
    assert s == 1
    hd = cfg.hd
    w = cache["k"].shape[1]
    q, k, v = p.qkv(x, torch.full((1,), pos, dtype=torch.int32,
                                  device=x.device))
    slot = pos % w
    ck = cache["k"] = write_slot(cache["k"], slot, k)
    cv = cache["v"] = write_slot(cache["v"], slot, v)
    # Absolute position of each slot given the current write head.
    sidx = _arange(w, x.device)
    abs_pos = pos - torch.remainder(pos - sidx, w)
    valid = (abs_pos >= 0) & (abs_pos <= pos)
    if cfg.swa_window:
        valid = valid & (abs_pos > pos - cfg.swa_window)
    g = cfg.n_heads // cfg.n_kv_heads
    kq = ck.repeat_interleave(g, dim=2)
    vq = cv.repeat_interleave(g, dim=2)
    logits = einsum("bqhd,bkhd->bhqk", q, kq)
    logits = logits * _weak(hd ** -0.5, logits.dtype)
    logits = logits.masked_fill(~valid[None, None, None, :], _NEG)
    pr = softmax(logits, x.dtype)
    o = settle(einsum("bhqk,bkhd->bqhd", pr, vq))
    y = p.wo(o.reshape(b, 1, cfg.n_heads * hd))
    return y, cache


def cross_attention(p: GQA, x: torch.Tensor, kv: Cache,
                    cfg: ModelConfig) -> torch.Tensor:
    """Decoder cross-attention over precomputed encoder k/v (no mask)."""
    b, s, _ = x.shape
    hd = cfg.hd
    q = split_last(p.wq(x), cfg.n_heads, hd)
    qpos = _arange(s, x.device)
    kpos = _arange(kv["k"].shape[1], x.device)
    o = attention_any(q, kv["k"], kv["v"], qpos, kpos, causal=False,
                      window=0, scale=hd ** -0.5)
    return p.wo(merge_last(o))


def cross_kv(p: GQA, memory: torch.Tensor, cfg: ModelConfig) -> Cache:
    b, sm, _ = memory.shape
    hd = cfg.hd
    k = split_last(p.wk(memory), cfg.n_kv_heads, hd)
    v = split_last(p.wv(memory), cfg.n_kv_heads, hd)
    if cfg.n_kv_heads != cfg.n_heads:
        k = k.repeat_interleave(cfg.n_heads // cfg.n_kv_heads, dim=2)
        v = v.repeat_interleave(cfg.n_heads // cfg.n_kv_heads, dim=2)
    return {"k": k, "v": v}


def mla_latent_chunked_attention(qcat, ckv, kr, wuk, wuv, *, scale: float,
                                 h: int, qk_nope: int, v_dim: int):
    """Streaming MLA attention that expands K/V from the latent one chunk
    at a time: the full (B,S,H,qk_nope) keys and (B,S,H,v_dim) values never
    exist.

    qcat: [B,S,H,qk_nope+rope]; ckv: [B,S,kv_lora]; kr: [B,S,rope];
    wuk: [kv_lora, H, qk_nope]; wuv: [kv_lora, H, v_dim].
    """
    b, s, _, _ = qcat.shape
    pad = (-s) % _CHUNK
    if pad:
        ckv = F.pad(ckv, (0, 0, 0, pad))
        kr = F.pad(kr, (0, 0, 0, pad))
    nck = (s + pad) // _CHUNK
    qpos = _arange(s, qcat.device)
    qf = qcat.float() * scale
    wukf, wuvf = wuk.float(), wuv.float()
    carry = _online_softmax_init(b, h, s, v_dim, qcat.device)
    for t in range(nck):
        sl = slice(t * _CHUNK, (t + 1) * _CHUNK)
        ckv_t = ckv[:, sl].float()
        kr_t = kr[:, sl].float()
        kn_t = torch.einsum("bkc,chn->bkhn", ckv_t, wukf)
        kcat_t = torch.cat(
            [kn_t, kr_t[:, :, None, :].expand(b, _CHUNK, h, kr.shape[-1])],
            -1)
        v_t = torch.einsum("bkc,chv->bkhv", ckv_t, wuvf)
        kpos_t = t * _CHUNK + _arange(_CHUNK, qcat.device)
        kpos_t = torch.where(kpos_t < s, kpos_t, _PAD_POS)
        sc = torch.einsum("bqhd,bkhd->bhqk", qf, kcat_t)
        sc = constrain_scores(sc)
        ok = _mask_ok(qpos, kpos_t, causal=True, window=0)
        sc = sc.masked_fill_(~ok, _NEG)
        carry = _online_softmax_step(carry, sc, v_t)
    m, l, acc = carry
    out = acc / torch.clamp(l, min=1e-20)[..., None]
    return out.transpose(1, 2).to(qcat.dtype)


# ------------------------------------------------------------- MLA block ---
class MLA(nn.Module):
    """Multi-head latent attention (DeepSeek-V2): queries through a
    low-rank ``q_lora``, keys and values through the ``kv_lora`` latent plus
    a shared rotary key."""

    def __init__(self, cfg: ModelConfig, init: Init):
        super().__init__()
        m = cfg.mla
        d, h = cfg.d_model, cfg.n_heads
        self.cfg = cfg
        self.wdq = Linear(d, m.q_lora, init=init)
        self.q_norm = RMSNorm(m.q_lora, init)
        self.wuq = Linear(m.q_lora, h * (m.qk_nope + m.qk_rope), init=init)
        self.wdkv = Linear(d, m.kv_lora + m.qk_rope, init=init)
        self.kv_norm = RMSNorm(m.kv_lora, init)
        self.wuk = Linear(m.kv_lora, h * m.qk_nope, init=init)
        self.wuv = Linear(m.kv_lora, h * m.v_dim, init=init)
        self.wo = Linear(h * m.v_dim, d, init=init)

    def query(self, x: torch.Tensor) -> torch.Tensor:
        """The queries of ``x`` [B,S,d]: [B,S,H,qk_nope+qk_rope]."""
        m = self.cfg.mla
        b, s, _ = x.shape
        q = self.wuq(self.q_norm(self.wdq(x)))
        # 128-head MLA queries: heads over the model axis.
        return constrain(split_last(q, self.cfg.n_heads,
                                    m.qk_nope + m.qk_rope),
                         "dp", None, "model", None)

    def latent(self, x: torch.Tensor, pos: torch.Tensor):
        """The cached part of ``x``: the normed latent [B,S,kv_lora] and
        the rotated key [B,S,1,qk_rope]."""
        m = self.cfg.mla
        b, s, _ = x.shape
        ckv_full = self.wdkv(x)
        ckv = self.kv_norm(ckv_full[..., :m.kv_lora])
        kr = apply_rope(ckv_full[..., m.kv_lora:].reshape(b, s, 1, m.qk_rope),
                        pos, self.cfg.rope_theta)
        return ckv, kr

    def forward(self, x: torch.Tensor, return_cache: bool = False):
        """The reference's ``mla_train``; with ``return_cache`` also the
        latent and rotated key that prefill caches."""
        cfg = self.cfg
        m = cfg.mla
        b, s, _ = x.shape
        h = cfg.n_heads
        q = self.query(x)
        qn, qr = q[..., :m.qk_nope], q[..., m.qk_nope:]
        pos = _arange(s, x.device)
        ckv, kr = self.latent(x, pos)
        qr = apply_rope(qr, pos, cfg.rope_theta)
        scale = (m.qk_nope + m.qk_rope) ** -0.5
        qcat = torch.cat([qn, qr], -1)
        if cfg.mla_absorbed_prefill and s > 4096:
            # Expand K/V from the latent chunk by chunk: the full (B,S,H,·)
            # key and value tensors never exist.
            wuk = split_last(fsdp_gather(self.wuk.w), h, m.qk_nope)
            wuv = split_last(fsdp_gather(self.wuv.w), h, m.v_dim)
            # On a mesh each device streams its own heads over its own
            # batch rows (local tensors: no collective).
            hs, rows = ("dp", None, "model", None), ("dp", None, None)
            o = local("attention", lambda q_, c_, r_, k_, v_:
                      mla_latent_chunked_attention(
                          q_, c_, r_, k_, v_, scale=scale, h=q_.shape[2],
                          qk_nope=m.qk_nope, v_dim=m.v_dim),
                      [qcat, ckv, kr[:, :, 0, :], wuk, wuv],
                      [hs, rows, rows, (None, "model", None),
                       (None, "model", None)], [hs])
        else:
            kn = constrain(split_last(self.wuk(ckv), h, m.qk_nope),
                           "dp", None, "model", None)
            v = constrain(split_last(self.wuv(ckv), h, m.v_dim),
                          "dp", None, "model", None)
            kcat = torch.cat([kn, kr.expand(b, s, h, m.qk_rope)], -1)
            o = attention_any(qcat, kcat, v, pos, pos, causal=True, window=0,
                              scale=scale)
        y = self.wo(merge_last(o))
        if return_cache:
            return y, {"ckv": ckv, "kr": kr[:, :, 0]}
        return y


def mla_decode(p: MLA, x: torch.Tensor, cache: Cache, pos: int,
               cfg: ModelConfig) -> Tuple[torch.Tensor, Cache]:
    """Absorbed-matrix MLA decode: the cache holds only the compressed
    latent (kv_lora) and the rotary key (qk_rope) of each token.
    ``q_nope @ W_uk`` lives in latent space, so the scores and the output
    contraction run against the latent cache; W_uv is applied once to the
    attention-weighted latent.  The cache is written in place and
    returned."""
    m = cfg.mla
    b = x.shape[0]
    h = cfg.n_heads
    w = cache["ckv"].shape[1]
    pos_t = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    q = p.query(x)
    qn, qr = q[..., :m.qk_nope], q[..., m.qk_nope:]
    qr = apply_rope(qr, pos_t, cfg.rope_theta)
    ckv_t, kr_t = p.latent(x, pos_t)
    cache_ckv = cache["ckv"] = write_slot(cache["ckv"], pos, ckv_t)
    cache_kr = cache["kr"] = write_slot(cache["kr"], pos, kr_t[:, :, 0, :])
    wuk = split_last(fsdp_gather(p.wuk.w), h, m.qk_nope)
    q_eff = einsum("bhn,khn->bhk", qn[:, 0], wuk)
    s_lat = einsum("bhk,bsk->bhs", q_eff, cache_ckv)
    s_rope = einsum("bhr,bsr->bhs", qr[:, 0], cache_kr)
    logits = s_lat + s_rope
    logits = logits * _weak((m.qk_nope + m.qk_rope) ** -0.5, logits.dtype)
    sidx = _arange(w, x.device)
    logits = logits.masked_fill(~(sidx <= pos)[None, None, :], _NEG)
    pr = softmax(logits, x.dtype)
    o_lat = settle(einsum("bhs,bsk->bhk", pr, cache_ckv))
    wuv = split_last(fsdp_gather(p.wuv.w), h, m.v_dim)
    o = einsum("bhk,khv->bhv", o_lat, wuv)
    y = p.wo(o.reshape(b, 1, h * m.v_dim))
    return y, cache


# ------------------------------------------------------------------- MLP ---
class MLP(nn.Module):
    """SwiGLU: ``wd(silu(wg(x)) * wu(x))``."""

    def __init__(self, d: int, ff: int, init: Init):
        super().__init__()
        self.wg = Linear(d, ff, init=init)
        self.wu = Linear(d, ff, init=init)
        self.wd = Linear(ff, d, init=init)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.wd(F.silu(self.wg(x)) * self.wu(x))
