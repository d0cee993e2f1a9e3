"""PageRank, BFS and SSSP over a CSR, in plain torch, with the semantics of
the analytics the benchmark drives.

Edges are followed from their source: ``bfs_hops(...)[u]`` is the number
of hops of the shortest path from u to the source along stored edges,
``sssp(...)[u]`` the least sum of weights (negative weights count as 0)
of such a path; a vertex with no path reads ``UNREACHABLE`` in BFS and
infinity in SSSP.  PageRank
pulls along stored edges: y[u] is the sum over u's edges (u, v) of
x[v] / max(deg(v), 1), and the mass of vertices with no edge is spread
evenly: x <- (1 - d) / n + d * (y + dangling / n), from x = 1 / n.
``dtype`` is the arithmetic's precision.
"""
from __future__ import annotations

import torch

UNREACHABLE = 3.0e38


def _sources(voff: torch.Tensor) -> torch.Tensor:
    n = voff.shape[0] - 1
    return torch.repeat_interleave(torch.arange(n, device=voff.device),
                                   voff[1:] - voff[:-1])


def pagerank(voff, dst, iters: int, d: float = 0.85,
             dtype=torch.float64) -> torch.Tensor:
    n = voff.shape[0] - 1
    src, dst = _sources(voff), dst.long()
    deg = (voff[1:] - voff[:-1]).to(dtype)
    x = torch.full((n,), 1.0 / n, dtype=dtype, device=voff.device)
    for _ in range(iters):
        contrib = x / deg.clamp(min=1.0)
        y = torch.zeros(n, dtype=dtype, device=voff.device)
        y.index_add_(0, src, contrib[dst])
        dangling = x[deg == 0].sum()
        x = (1.0 - d) / n + d * (y + dangling / n)
    return x


def bfs_hops(voff, dst, source: int) -> torch.Tensor:
    """float32 hop counts to ``source``, level by level."""
    n = voff.shape[0] - 1
    src, dst = _sources(voff), dst.long()
    hops = torch.full((n,), UNREACHABLE, dtype=torch.float32,
                      device=voff.device)
    frontier = torch.zeros(n, dtype=torch.bool, device=voff.device)
    frontier[source] = True
    hops[source] = 0.0
    level = 0
    while True:
        level += 1
        reach = frontier[dst] & (hops[src] == UNREACHABLE)
        nxt = torch.zeros_like(frontier)
        nxt[src[reach]] = True
        if not bool(nxt.any()):
            return hops
        hops[nxt] = float(level)
        frontier = nxt


def sssp(voff, dst, prop, source: int, dtype=torch.float64) -> torch.Tensor:
    """Bellman-Ford distances to ``source`` in ``dtype`` (inf: no path)."""
    n = voff.shape[0] - 1
    src, dst = _sources(voff), dst.long()
    w = prop.to(dtype).clamp(min=0.0)
    dist = torch.full((n,), float("inf"), dtype=dtype, device=voff.device)
    dist[source] = 0.0
    while True:
        cand = torch.full_like(dist, float("inf"))
        cand.scatter_reduce_(0, src, w + dist[dst], "amin")
        new = torch.minimum(dist, cand)
        if not bool((new < dist).any()):
            return dist
        dist = new
