"""Merge-free analytics directly over the multi-level CSR (port of
``repro.analytics.multilevel``).

Linear aggregations (PageRank messages, degree, weighted scans) distribute
over the level structure: every visible record contributes ±f(edge), with
tombstones entering negatively, so

    sum over runs of sum over records of ±f  ==  sum over live edges of f

with no per-vertex merge and no global sort.  Each run is already sorted by
source, so each term is one gather-segsum sweep.  Exactness needs
alternating insert/delete histories per key.

Min-style algorithms (BFS/SSSP/CC) are not linear; they use the exact
materialized view (``view.materialize_csr``).
"""
from __future__ import annotations

from typing import List

import torch

from ..core.types import resolve_device
from ..kernels import ops
from .view import RunView


def multilevel_spmv(views: List[RunView], x: torch.Tensor, *,
                    n_out: int, use_pallas: bool = True) -> torch.Tensor:
    """y[u] = sum over live (u, v) of x[v], computed run by run with ±
    weights."""
    y = torch.zeros((n_out,), dtype=torch.float32, device=x.device)
    for rv in views:
        y = y + ops.gather_segsum(rv.dst, rv.src, rv.wt, x, n_out=n_out,
                                  use_pallas=use_pallas)
    return y


def multilevel_degree(views: List[RunView], *, n_out: int,
                      use_pallas: bool = True) -> torch.Tensor:
    """Live out-degree per vertex (float32), on the views' device (with no
    views: the current CUDA card)."""
    device = views[0].dst.device if views else resolve_device(None)
    ones = torch.ones((n_out,), dtype=torch.float32, device=device)
    return multilevel_spmv(views, ones, n_out=n_out, use_pallas=use_pallas)


def multilevel_pagerank(views: List[RunView], *, n_out: int, iters: int = 20,
                        d: float = 0.85,
                        use_pallas: bool = True) -> torch.Tensor:
    """PageRank without ever materializing a merged CSR."""
    deg = multilevel_degree(views, n_out=n_out, use_pallas=use_pallas)
    x = torch.full((n_out,), 1.0 / n_out, dtype=torch.float32,
                   device=deg.device)
    for _ in range(iters):
        contrib = x / deg.clamp(min=1.0)
        y = multilevel_spmv(views, contrib, n_out=n_out,
                            use_pallas=use_pallas)
        dangling = torch.where(deg == 0, x, 0.0).sum()
        x = (1.0 - d) / n_out + d * (y + dangling / n_out)
    return x
