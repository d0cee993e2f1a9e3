"""Merge-free analytics directly over the multi-level CSR (port of
``repro.analytics.multilevel``).

Linear aggregations (PageRank messages, degree, weighted scans) distribute
over the level structure: every visible record contributes ±f(edge), with
tombstones entering negatively, so

    sum over runs of sum over records of ±f  ==  sum over live edges of f

with no per-vertex merge and no global sort.  Each run is already sorted by
source.  The reference makes one gather-segsum sweep a run and adds the
partials; here every run's records are laid end to end once (``RunBatch``)
and one multi-run segment sum (``ops.gather_segsum_runs``) makes the whole
sweep.  Exactness needs alternating insert/delete histories per key.

Min-style algorithms (BFS/SSSP/CC) are not linear; they use the exact
materialized view (``view.materialize_csr``).
"""
from __future__ import annotations

from typing import List, NamedTuple

import torch

from ..core.types import resolve_device
from ..kernels import ops
from .view import RunView


class RunBatch(NamedTuple):
    """Every run view's records laid end to end, in run order: the input of
    one multi-run segment sum.  Run r holds records
    ``offsets[r]:offsets[r + 1]``, sorted by ``src``."""

    src: torch.Tensor       # int32[N]
    dst: torch.Tensor       # int32[N]
    wt: torch.Tensor        # float32[N]
    offsets: torch.Tensor   # int64[R + 1], on the host


def run_batch(views: List[RunView], device=None) -> RunBatch:
    """Lay the views' records end to end (one copy of 12 bytes a record on
    the views' device; ``device`` is used only when there is no view)."""
    lens = [rv.src.shape[0] for rv in views]
    offsets = torch.zeros(len(views) + 1, dtype=torch.int64)
    offsets[1:] = torch.tensor(lens, dtype=torch.int64).cumsum(0)
    if not views:
        dev = resolve_device(device)
        z = torch.zeros(0, dtype=torch.int32, device=dev)
        return RunBatch(z, z, torch.zeros(0, dtype=torch.float32, device=dev),
                        offsets)
    return RunBatch(*(torch.cat([getattr(rv, f) for rv in views])
                      for f in ("src", "dst", "wt")), offsets)


def _spmv(batch: RunBatch, x: torch.Tensor, n_out: int,
          use_pallas: bool) -> torch.Tensor:
    return ops.gather_segsum_runs(batch.dst, batch.src, batch.wt, x,
                                  n_out=n_out, use_pallas=use_pallas)


def multilevel_spmv(views: List[RunView], x: torch.Tensor, *,
                    n_out: int, use_pallas: bool = True) -> torch.Tensor:
    """y[u] = sum over live (u, v) of x[v], summed over every run with ±
    weights in one sweep."""
    return _spmv(run_batch(views, x.device), x, n_out, use_pallas)


def _degree(batch: RunBatch, n_out: int, device,
            use_pallas: bool) -> torch.Tensor:
    ones = torch.ones((n_out,), dtype=torch.float32, device=device)
    return _spmv(batch, ones, n_out, use_pallas)


def _views_device(views: List[RunView]) -> torch.device:
    """The views' device: the first view's; with no view, the device an
    empty ``RunViews`` holds, else the current CUDA card."""
    if views:
        return views[0].dst.device
    return resolve_device(getattr(views, "device", None))


def multilevel_degree(views: List[RunView], *, n_out: int,
                      use_pallas: bool = True) -> torch.Tensor:
    """Live out-degree per vertex (float32), on the views' device."""
    device = _views_device(views)
    return _degree(run_batch(views, device), n_out, device, use_pallas)


def multilevel_pagerank(views: List[RunView], *, n_out: int, iters: int = 20,
                        d: float = 0.85,
                        use_pallas: bool = True) -> torch.Tensor:
    """PageRank without ever materializing a merged CSR: the runs are laid
    end to end once, then each sweep is one multi-run segment sum."""
    device = _views_device(views)
    batch = run_batch(views, device)
    deg = _degree(batch, n_out, device, use_pallas)
    x = torch.full((n_out,), 1.0 / n_out, dtype=torch.float32,
                   device=device)
    for _ in range(iters):
        contrib = x / deg.clamp(min=1.0)
        y = _spmv(batch, contrib, n_out, use_pallas)
        dangling = torch.where(deg == 0, x, 0.0).sum()
        x = (1.0 - d) / n_out + d * (y + dangling / n_out)
    return x
