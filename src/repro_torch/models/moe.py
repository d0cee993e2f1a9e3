"""Mixture-of-Experts with sort-based capacity dispatch.

The port of ``repro.models.moe``.  Routed copies are sorted by expert
(a stable sort), ranked within their expert, and scattered into an
(E · capacity) slot layout; copies ranked past the capacity are dropped.
The reference scatters them to the sentinel slot ``E · capacity`` with
``mode="drop"``; torch raises on that index, so the slot tables here have
one spare row that takes the dropped copies and is cut off.  The weighted
expert outputs are added back to their tokens by ``index_add_`` (on the
card its additions land in another order than the reference's, so that sum
is held within a tolerance, not byte-equal).

Supports top-k routing with capacity dropping, shared experts
(DeepSeek-V2), a parallel dense residual (Arctic) and leading dense layers
(DeepSeek-V2, through the layer plan).  The reference groups tokens by the
mesh's data-parallel shards; with no mesh that is one group, as here.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ModelConfig, MoEConfig
from .layers import MLP, Init, Linear, einsum


def expert_capacity(n_tokens: int, m: MoEConfig,
                    override: float = 0.0) -> int:
    factor = override if override else m.capacity_factor
    c = int(math.ceil(n_tokens * m.top_k * factor / m.n_experts))
    return max(8, -(-c // 8) * 8)  # round up to 8


class MoE(nn.Module):
    """Router (float32), stacked expert weights ``wg``/``wu`` [E, d, ff]
    and ``wd`` [E, ff, d], and the optional shared and dense MLPs."""

    def __init__(self, cfg: ModelConfig, init: Init):
        super().__init__()
        m = cfg.moe
        d, ff = cfg.d_model, m.d_expert
        self.cfg = cfg
        self.router = Linear(d, m.n_experts, init=init, dtype=torch.float32)
        self.wg = init.normal((m.n_experts, d, ff), d ** -0.5)
        self.wu = init.normal((m.n_experts, d, ff), d ** -0.5)
        self.wd = init.normal((m.n_experts, ff, d), ff ** -0.5)
        self.shared = MLP(d, m.n_shared * ff, init) if m.n_shared else None
        self.dense = MLP(d, cfg.d_ff, init) if m.dense_residual else None

    def route(self, xt: torch.Tensor):
        """Top-k routing of tokens ``xt`` [T, d]: (gates [T, k] normalised
        to sum 1, expert ids [T, k] int64, router probabilities [T, E])."""
        m = self.cfg.moe
        pr = torch.softmax(self.router(xt.float()), -1)
        gates, ids = torch.topk(pr, m.top_k, dim=-1)
        gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
        return gates, ids, pr

    def dispatch(self, ids: torch.Tensor, gates: torch.Tensor, capg: int):
        """The slot tables of the sort-based dispatch: for each of the
        E · capg slots the token that fills it (``T`` when empty) and its
        gate in bfloat16 (0 when empty)."""
        m = self.cfg.moe
        t = ids.shape[0]
        n_slots = m.n_experts * capg
        dev = ids.device
        e_flat = ids.reshape(-1)
        tok_flat = torch.arange(t, device=dev).repeat_interleave(m.top_k)
        e_sorted, order = torch.sort(e_flat, stable=True)
        first = torch.searchsorted(e_sorted, e_sorted, side="left")
        rank = torch.arange(t * m.top_k, device=dev) - first
        keep = rank < capg
        slot = torch.where(keep, e_sorted * capg + rank, n_slots)
        idx = torch.full((n_slots + 1,), t, dtype=torch.int64, device=dev)
        idx[slot] = tok_flat[order]
        gts = torch.zeros((n_slots + 1,), dtype=torch.bfloat16, device=dev)
        gts[slot] = gates.reshape(-1)[order].to(torch.bfloat16)
        return idx[:n_slots], gts[:n_slots]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [B, S, d] -> [B, S, d]."""
        m = self.cfg.moe
        b, s, d = x.shape
        t = b * s
        capg = expert_capacity(t, m, override=self.cfg.moe_capacity_override)
        xt = x.reshape(t, d)
        gates, ids, _ = self.route(xt)
        idx, gate_disp = self.dispatch(ids, gates, capg)
        xt_pad = torch.cat([xt, xt.new_zeros((1, d))])   # row t = zeros
        x_disp = xt_pad[idx].reshape(m.n_experts, capg, d)
        h = F.silu(einsum("ecd,edf->ecf", x_disp, self.wg)) * \
            einsum("ecd,edf->ecf", x_disp, self.wu)
        y_exp = einsum("ecf,efd->ecd", h, self.wd)
        y_flat = y_exp.reshape(m.n_experts * capg, d)
        y_flat = y_flat * gate_disp[:, None].to(y_flat.dtype)
        # Combine: add the weighted expert outputs back to their tokens
        # (the empty slots' row t is cut off).
        y = x.new_zeros((t + 1, d)).index_add_(0, idx, y_flat.to(x.dtype))
        y = y[:t]
        if self.shared is not None:
            y = y + self.shared(xt)
        if self.dense is not None:
            y = y + self.dense(xt)
        return y.reshape(b, s, d)


def moe_apply(p: MoE, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The reference's entry point: ``p`` holds the weights."""
    return p(x)


def aux_load_balance_loss(p: MoE, x: torch.Tensor,
                          cfg: ModelConfig) -> torch.Tensor:
    """Switch-style load-balance auxiliary (training's; kept so the module
    is whole)."""
    m = cfg.moe
    d = x.shape[-1]
    _, ids, pr = p.route(x.reshape(-1, d))
    frac = F.one_hot(ids, m.n_experts).float().mean(dim=(0, 1))
    imp = pr.mean(0)
    return m.n_experts * torch.sum(frac * imp)


__all__ = ["MoE", "expert_capacity", "moe_apply", "aux_load_balance_loss"]
