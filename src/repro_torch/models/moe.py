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
mesh's data-parallel shards: one group off a mesh, and on a dry run's
device mesh one group a data-parallel shard.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ModelConfig, MoEConfig
from . import partition
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

    def route(self, xt: torch.Tensor, w=None):
        """Top-k routing of tokens ``xt`` [T, d]: (gates [T, k] normalised
        to sum 1, expert ids [T, k] int64, router probabilities [T, E]).
        ``w`` is the float32 router weight [d, E] (default: the module's,
        its data-parallel shards gathered on a mesh)."""
        m = self.cfg.moe
        if w is None:
            w = partition.fsdp_gather(self.router.w)
        pr = torch.softmax(xt.float() @ w, -1)
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
        """x: [B, S, d] -> [B, S, d].  Tokens are grouped by their
        data-parallel shard (the reference's ``_n_dispatch_groups``: one
        group off a mesh), so the sort, rank and scatter run on each
        device's own tokens, and the experts are split over ``model``
        (expert parallelism).  No DTensor sharding strategy covers the
        sort-based dispatch, so on a mesh it runs on the local tensors
        (``partition.local``, the identity off a mesh): each device routes
        its group over every expert, runs the experts it holds and adds
        their outputs to its tokens; the sum over ``model`` completes
        them."""
        m = self.cfg.moe
        b, s, d = x.shape
        split = partition.divides(m.n_experts, "model")
        ex = "model" if split else None

        def group(xl, router_w, wg, wu, wd):
            bl = xl.shape[0]
            t = bl * s
            capg = expert_capacity(t, m,
                                   override=self.cfg.moe_capacity_override)
            xt = xl.reshape(t, d)
            gates, ids, _ = self.route(xt, router_w)
            idx, gate_disp = self.dispatch(ids, gates, capg)
            # This device's experts: rows [lo, lo + n) of the slot table.
            n = wg.shape[0]
            if split:
                lo = partition.axis_rank("model") * n
                idx = idx.reshape(m.n_experts, capg)[lo:lo + n].reshape(-1)
                gate_disp = gate_disp.reshape(m.n_experts, capg)[lo:lo + n]
            xt_pad = torch.cat([xt, xt.new_zeros((1, d))])  # row t = zeros
            x_disp = xt_pad[idx].reshape(n, capg, d)
            h = F.silu(einsum("ecd,edf->ecf", x_disp, wg)) * \
                einsum("ecd,edf->ecf", x_disp, wu)
            y_flat = einsum("ecf,efd->ecd", h, wd).reshape(n * capg, d)
            y_flat = y_flat * gate_disp.reshape(-1)[:, None].to(y_flat.dtype)
            # Combine: add the weighted expert outputs back to their tokens
            # (the empty slots' row t is cut off).
            y = xl.new_zeros((t + 1, d)).index_add_(0, idx,
                                                    y_flat.to(xl.dtype))
            return y[:t].reshape(bl, s, d)

        y = partition.local(
            "moe_dispatch", group,
            [x, self.router.w, self.wg, self.wu, self.wd],
            [("dp", None, None), (None, None), (ex, None, None),
             (ex, None, None), (ex, None, None)],
            [("dp", None, None)], partial=ex)
        if self.shared is not None:
            y = y + self.shared(x)
        if self.dense is not None:
            y = y + self.dense(x)
        return y


def moe_apply(p: MoE, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The reference's entry point: ``p`` holds the weights."""
    return p(x)


def aux_load_balance_loss(p: MoE, x: torch.Tensor,
                          cfg: ModelConfig) -> torch.Tensor:
    """Switch-style load-balance auxiliary, which ``model.loss`` adds for
    every MoE layer."""
    m = cfg.moe
    d = x.shape[-1]
    _, ids, pr = p.route(x.reshape(-1, d))
    frac = F.one_hot(ids, m.n_experts).float().mean(dim=(0, 1))
    imp = pr.mean(0)
    return m.n_experts * torch.sum(frac * imp)


__all__ = ["MoE", "expert_capacity", "moe_apply", "aux_load_balance_loss"]
