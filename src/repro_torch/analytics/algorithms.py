"""Graph algorithms over a CSRView: SSSP, BFS, CC, SCAN and PageRank (port
of ``repro.analytics.algorithms``).

Every algorithm is a whole-graph vectorized sweep with the gather-segsum /
gather-segmin kernels as its inner loop.  The reference's ``fori_loop`` is
a Python loop; its ``while_loop`` is a host loop with the same condition
(``changed and it < n``), which reads ``changed`` with one ``.item()`` per
iteration, the loop's only host synchronisation.  ``use_pallas`` keeps the
reference's keyword: True is the kernel wrapper (the hand-written kernel on
CUDA tensors, the plain version on CPU tensors), False the plain version.

Direction convention: the stored edge u->v is traversed from u (pull over
the stored direction), so ``bfs(view, s)[u]`` counts the hops from u to s.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch

from ..kernels import ops
from .view import CSRView

_F32 = torch.float32
_INF = 3.0e38   # stored in float32 tensors, as the reference's jnp.float32


def pagerank(view: CSRView, iters: int = 20, d: float = 0.85,
             use_pallas: bool = True) -> torch.Tensor:
    n, dst = view.n_vertices, view.dst
    seg = view.seg_ids()
    deg = view.degrees.to(_F32)
    wt = torch.ones(dst.shape, dtype=_F32, device=dst.device)
    x = torch.full((n,), 1.0 / n, dtype=_F32, device=dst.device)
    for _ in range(iters):
        contrib = x / deg.clamp(min=1.0)
        y = ops.gather_segsum(dst, seg, wt, contrib, n_out=n,
                              use_pallas=use_pallas)
        # Dangling mass is redistributed uniformly.
        dangling = torch.where(deg == 0, x, 0.0).sum()
        x = (1.0 - d) / n + d * (y + dangling / n)
    return x


def _relax_to_fixpoint(x: torch.Tensor,
                       relax: Callable[[torch.Tensor], torch.Tensor]
                       ) -> torch.Tensor:
    """x <- min(x, relax(x)) while some entry drops, at most len(x) times."""
    n = x.shape[0]
    changed, it = True, 0
    while changed and it < n:
        new = torch.minimum(x, relax(x))
        changed = bool((new < x).any().item())
        x, it = new, it + 1
    return x


def _source_dist(view: CSRView, source: int) -> torch.Tensor:
    dist = torch.full((view.n_vertices,), _INF, dtype=_F32,
                      device=view.dst.device)
    dist[source] = 0.0
    return dist


def bfs(view: CSRView, source: int, use_pallas: bool = True) -> torch.Tensor:
    """Hop distances to ``source`` (3.0e38 = unreachable)."""
    n, dst, seg = view.n_vertices, view.dst, view.seg_ids()
    ones = torch.ones(dst.shape, dtype=_F32, device=dst.device)
    return _relax_to_fixpoint(_source_dist(view, source), lambda dist: (
        ops.gather_segmin(dst, seg, ones, dist, n_out=n,
                          use_pallas=use_pallas)))


def sssp(view: CSRView, source: int, use_pallas: bool = True) -> torch.Tensor:
    """Bellman-Ford shortest paths with edge properties as weights
    (negative properties count as 0).

    The relaxation is dist[u] <- min over u's stored edges (u, v) of
    w + dist[v]: paths follow stored edges from u."""
    n, dst, seg = view.n_vertices, view.dst, view.seg_ids()
    wts = view.prop.clamp(min=0.0)
    return _relax_to_fixpoint(_source_dist(view, source), lambda dist: (
        ops.gather_segmin(dst, seg, wts, dist, n_out=n,
                          use_pallas=use_pallas)))


def cc(view: CSRView, use_pallas: bool = True) -> torch.Tensor:
    """Connected components by min-label propagation (undirected
    ingestion): int32 labels."""
    n, dst, seg = view.n_vertices, view.dst, view.seg_ids()
    zero = torch.zeros(dst.shape, dtype=_F32, device=dst.device)
    label0 = torch.arange(n, dtype=_F32, device=dst.device)
    lab = _relax_to_fixpoint(label0, lambda lab: ops.gather_segmin(
        dst, seg, zero, lab, n_out=n, use_pallas=use_pallas))
    return lab.to(torch.int32)


def scan_stats(view: CSRView, use_pallas: bool = True
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SCAN: traverse every vertex's one-hop neighbours; returns (degree,
    sum of edge properties) per vertex, both float32."""
    n, dst, seg, prop = view.n_vertices, view.dst, view.seg_ids(), view.prop
    ones = torch.ones((n,), dtype=_F32, device=dst.device)
    deg = ops.gather_segsum(dst, seg, torch.ones_like(prop), ones, n_out=n,
                            use_pallas=use_pallas)
    wsum = ops.gather_segsum(dst, seg, prop, ones, n_out=n,
                             use_pallas=use_pallas)
    return deg, wsum
