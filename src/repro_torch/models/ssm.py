"""Mamba2 SSD (state-space duality) block: chunked prefill, recurrent
decode.

The port of ``repro.models.ssm``, the SSD algorithm of arXiv:2405.21060 §6:
within a chunk the recurrence is a masked quadratic contraction; across
chunks only the (H, N, P) states propagate, here through a Python loop over
the chunks.  Used by mamba2-2.7b and, in place of Mamba-1, by Jamba's SSM
layers (as in the reference).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ModelConfig
from .layers import CACHE_DTYPE, Init, Linear, einsum, rmsnorm
from .partition import cache_zeros, constrain, local, merge_last

State = Dict[str, torch.Tensor]


class SSM(nn.Module):
    """Fused ``in_proj`` -> [z, x, B, C, dt], a depthwise causal conv over
    [x, B, C], the SSD recurrence and a gated RMSNorm before
    ``out_proj``.  ``A_log``, ``D`` and ``dt_bias`` are float32."""

    def __init__(self, cfg: ModelConfig, init: Init):
        super().__init__()
        s, di, nh, g, n, _hp = _dims(cfg)
        gn = g * n
        self.cfg = cfg
        self.in_proj = Linear(cfg.d_model, 2 * di + 2 * gn + nh, init=init)
        self.conv_w = init.normal((s.d_conv, di + 2 * gn), 0.1)
        self.conv_b = init.zeros((di + 2 * gn,))
        self.A_log = init.zeros((nh,), torch.float32)
        self.D = init.ones((nh,), torch.float32)
        self.dt_bias = init.zeros((nh,), torch.float32)
        self.norm_scale = init.ones((di,))
        self.out_proj = Linear(di, cfg.d_model, init=init)


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    di = s.expand * cfg.d_model
    nh = di // s.head_dim
    return s, di, nh, s.n_groups, s.d_state, s.head_dim


def _split_proj(cfg: ModelConfig, zxbcdt: torch.Tensor):
    _s, di, _nh, g, n, _hp = _dims(cfg)
    return torch.split(zxbcdt, [di, di + 2 * g * n,
                                zxbcdt.shape[-1] - 2 * di - 2 * g * n], -1)


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over time. xbc: [B,S,C]; w: [K,C]."""
    k = w.shape[0]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = torch.zeros_like(xbc)
    for i in range(k):
        out = out + pad[:, i:i + xbc.shape[1], :] * w[i]
    return F.silu(out + b)


def _gated_norm(p: SSM, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Mamba2's gated RMSNorm (eps 1e-5)."""
    return rmsnorm(p.norm_scale, y * F.silu(z), 1e-5)


def _ssd_core(xh, Bm, Cm, dt, A_log, D, dt_bias, q: int):
    """The SSD recurrence of ``ssd_train``: heads ``xh`` [B,S,H,P], the
    shared ``Bm``/``Cm`` [B,S,N], raw ``dt`` [B,S,H] and the per-head
    ``A_log``, ``D``, ``dt_bias`` [H], in chunks of ``q``.  -> (y
    [B,S,H,P] float32 with the ``D`` skip, the final state [B,H,N,P])."""
    b, s, nh, hp = xh.shape
    n = Bm.shape[-1]
    nc = s // q
    a = -torch.exp(A_log)                                    # (H,)
    dt = F.softplus(dt.float() + dt_bias)                    # (B,S,H)
    da = dt * a                                              # (B,S,H) <= 0

    # Chunk views with the heads over the model axis: the (B,NC,Q,H,P)
    # float32 intermediates are the SSD's peak-memory hot spot.
    xc = constrain(xh.reshape(b, nc, q, nh, hp).float(),
                   "dp", None, None, "model", None)
    Bc = Bm.reshape(b, nc, q, n).float()
    Cc = Cm.reshape(b, nc, q, n).float()
    dac = constrain(da.reshape(b, nc, q, nh), "dp", None, None, "model")
    dtc = constrain(dt.reshape(b, nc, q, nh), "dp", None, None, "model")
    cum = torch.cumsum(dac, dim=2)                           # (B,NC,Q,H)

    # Intra-chunk (diagonal) term, factored as
    # y_i = exp(cum_i) * sum_{j<=i} sc[i,j] * (exp(-cum_j)·dt_j·x_j), which
    # contracts over (Q,Q) without the head dim.  cum is clipped to
    # [-30, 0] so exp(-cum) stays finite.
    cum_c = torch.clamp(cum, -30.0, 0.0)
    mask = torch.ones((q, q), dtype=torch.bool, device=xh.device).tril()
    sc = torch.einsum("bcin,bcjn->bcij", Cc, Bc)             # (B,NC,Q,Q)
    scm = sc.masked_fill(~mask, 0.0)
    u = torch.exp(-cum_c)[..., None] * dtc[..., None] * xc   # (B,NC,Q,H,P)
    u = constrain(u, "dp", None, None, "model", None)
    y_pre = constrain(torch.einsum("bcij,bcjhp->bcihp", scm, u),
                      "dp", None, None, "model", None)
    y_diag = torch.exp(cum_c)[..., None] * y_pre

    # Chunk summary states: S_c = sum_j exp(cum_end - cum_j) dt_j B_j x_j^T.
    decay_end = torch.exp(cum[:, :, -1:, :] - cum)           # (B,NC,Q,H)
    states = constrain(torch.einsum("bcjh,bcjh,bcjn,bcjhp->bchnp",
                                    decay_end, dtc, Bc, xc),
                       "dp", None, "model", None, None)      # (B,NC,H,N,P)

    # Inter-chunk recurrence over the chunk index.
    chunk_decay = torch.exp(cum[:, :, -1, :])                # (B,NC,H)
    h = torch.zeros((b, nh, n, hp), dtype=torch.float32, device=xh.device)
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    h_prevs = torch.stack(h_prevs, 1)                        # (B,NC,H,N,P)

    # Off-diagonal (inter-chunk) output: C_i · h_prev, decayed from the
    # chunk's start.
    decay_in = torch.exp(cum)                                # (B,NC,Q,H)
    y_off = torch.einsum("bcin,bcih,bchnp->bcihp", Cc, decay_in, h_prevs)

    y = (y_diag + y_off).reshape(b, s, nh, hp)
    y = y + xh.float() * D[None, None, :, None]
    return y, h


def ssd_train(p: SSM, x: torch.Tensor, cfg: ModelConfig,
              return_state: bool = False, state_dtype=CACHE_DTYPE):
    """Chunked SSD forward. x: [B, S, d] -> [B, S, d] (and the final state
    with ``return_state``, which needs S to be a chunk multiple: ``h`` in
    float32, the conv tail in ``state_dtype``, the cache's dtype)."""
    s_cfg, di, nh, g, n, hp = _dims(cfg)
    b, s, _ = x.shape
    q = min(s_cfg.chunk, s)
    if s % q != 0:
        # Right-pad to a chunk multiple (causal: outputs for real positions
        # are unaffected; the padded state is only wrong AFTER position s,
        # so state harvesting needs chunk-aligned prefill lengths).
        if return_state:
            raise ValueError("prefill length must be a chunk multiple")
        pad = q - s % q
        return ssd_train(p, F.pad(x, (0, 0, 0, pad)), cfg)[:, :s]
    z, xbc_raw, dt = _split_proj(cfg, p.in_proj(x))
    xbc = _causal_conv(xbc_raw, p.conv_w, p.conv_b)
    xin, Bm, Cm = torch.split(xbc, [di, g * n, g * n], -1)
    xh = xin.reshape(b, s, nh, hp)
    Bm = Bm.reshape(b, s, g, n)
    Cm = Cm.reshape(b, s, g, n)
    Bm, Cm = (Bm[:, :, 0], Cm[:, :, 0]) if g == 1 else (Bm.mean(2),
                                                         Cm.mean(2))
    # On a mesh each device runs the recurrence for its own heads over its
    # own batch rows (the layouts the reference's constrain calls pin):
    # local tensors, no collective.
    heads, rows = ("dp", None, "model", None), ("dp", None, None)
    y, h = local("ssd", lambda *t: _ssd_core(*t, q),
                 [xh, Bm, Cm, dt, p.A_log, p.D, p.dt_bias],
                 [heads, rows, rows, ("dp", None, "model"), ("model",),
                  ("model",), ("model",)],
                 [heads, ("dp", "model", None, None)])
    y = merge_last(y)
    y = _gated_norm(p, y.to(x.dtype), z)
    out = p.out_proj(y)
    if return_state:
        conv_tail = xbc_raw[:, -(s_cfg.d_conv - 1):, :].to(state_dtype)
        return out, {"h": h, "conv": conv_tail}
    return out


def init_ssm_state(cfg: ModelConfig, b: int, dtype=CACHE_DTYPE,
                   device=None) -> State:
    s_cfg, di, nh, g, n, hp = _dims(cfg)
    return {"h": cache_zeros("h", (b, nh, n, hp), torch.float32, device),
            "conv": cache_zeros("conv", (b, s_cfg.d_conv - 1, di + 2 * g * n),
                                dtype, device)}


def ssm_decode(p: SSM, x: torch.Tensor, state: State,
               cfg: ModelConfig) -> Tuple[torch.Tensor, State]:
    """Single-token recurrent step.  state: {h: [B,H,N,P], conv: [B,K-1,C]};
    returns a new state (the old one is not written)."""
    _s, di, nh, g, n, hp = _dims(cfg)
    b = x.shape[0]
    z, xbc, dt = _split_proj(cfg, p.in_proj(x))              # x: [B,1,d]
    # Conv ring: append, convolve, trim.
    conv_in = torch.cat([state["conv"], xbc.to(state["conv"].dtype)], 1)
    acc = einsum("bkc,kc->bc", conv_in, p.conv_w)
    xbc1 = F.silu(acc + p.conv_b)[:, None, :]
    new_conv = conv_in[:, 1:, :]
    xin, Bm, Cm = torch.split(xbc1, [di, g * n, g * n], -1)
    xh = xin.reshape(b, nh, hp).float()
    Bm = Bm.reshape(b, g, n).mean(1).float()
    Cm = Cm.reshape(b, g, n).mean(1).float()
    a = -torch.exp(p.A_log)
    dtv = F.softplus(dt[:, 0].float() + p.dt_bias)
    dec = torch.exp(dtv * a)                                 # (B,H)
    h_new = state["h"] * dec[..., None, None] + torch.einsum(
        "bh,bn,bhp->bhnp", dtv, Bm, xh)
    y = torch.einsum("bn,bhnp->bhp", Cm, h_new)
    y = y + xh * p.D[None, :, None]
    y = _gated_norm(p, y.reshape(b, 1, di).to(x.dtype), z)
    return p.out_proj(y), {"h": h_new, "conv": new_conv}
