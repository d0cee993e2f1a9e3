"""Analytics views over a pinned LSMGraph snapshot (port of
``repro.analytics.view``).

Two read strategies:

  * ``materialize_csr`` — the exact merged live CSR at τ.  One merge of
    the snapshot's sources, laid end to end by the read spine's own run
    layout (``store.lay_out_runs``); every iteration of every algorithm
    then runs at CSR speed.
  * ``multilevel_views`` — merge-free per-run views with ± tombstone
    weights, consumed by ``multilevel.py``.

Everything stays on the store's device: the runs' records are read there,
merged or sorted there and returned as tensors.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import obs
from ..core import memgraph as mg_mod
from ..core.store import Snapshot, lay_out_runs
from ..core.types import BYTES_PER_EDGE, BYTES_PER_PROP, INVALID_VID
from ..kernels import ops as kops

_I32 = torch.int32


class CSRView(NamedTuple):
    """Dense live CSR over vertex-id space [0, n_vertices)."""

    voff: torch.Tensor   # int32[V+1]
    dst: torch.Tensor    # int32[E]
    prop: torch.Tensor   # float32[E]
    n_vertices: int
    n_edges: int

    @property
    def degrees(self) -> torch.Tensor:
        return self.voff[1:] - self.voff[:-1]

    def seg_ids(self) -> torch.Tensor:
        """Per-edge source id (inverse CSR), sorted by construction."""
        e = torch.arange(self.dst.shape[0], dtype=_I32,
                         device=self.dst.device)
        j = torch.searchsorted(self.voff[1:], e, right=True, out_int32=True)
        return j.clamp(max=self.n_vertices - 1)


def _laid_out_sources(snapshot: Snapshot):
    """Every source of the snapshot laid end to end as the read spine lays
    its runs (``store.lay_out_runs``), in one buffer a column (src, dst,
    ts, marker, prop), and each source's capacity: the MemGraph tiers,
    each sorted once at its full capacity (``memgraph.backbone_stream``),
    lead every sealed run with a vertex (degraded runs are already left
    out of the snapshot's runs).  Every source is (src, dst, ts)-ordered
    and its pads carry src == INVALID_VID.  The run-id column is dropped:
    the view needs no record's run, and the merge moves 17 bytes a record
    without it, not 21."""
    cols, caps = lay_out_runs(
        [rf for rf in snapshot.l0_runs + [
            r for lvl in snapshot.level_runs for r in lvl] if rf.nv > 0],
        leads=[mg_mod.backbone_stream(mg) for mg in snapshot.mem_states])
    return cols[:3] + cols[4:], caps


def _collect_sorted(snapshot: Snapshot):
    """Every record of the snapshot's sources, visible at τ or not, in one
    (src, dst, ts)-ordered stream on the store's device, pads (src ==
    INVALID_VID) at its tail.  The sources are laid end to end
    (``analytics_view_collect``) and merged by one tournament, one
    ``merge_pairs`` launch a round on a card (``analytics_view_merge``);
    the host waits for nothing.  Every (src, dst, ts) key is distinct, so
    the order is that of the reference's one sort of the concatenation."""
    label = snapshot._store.obs_label
    with obs.REGISTRY.span("analytics_view_collect", store=label):
        cols, caps = _laid_out_sources(snapshot)
    obs.REGISTRY.counter("analytics_view_sources_total",
                         store=label).inc(len(caps))
    with obs.REGISTRY.span("analytics_view_merge", store=label):
        return kops.merge_laid_out(cols, caps)


def materialize_csr(snapshot: Snapshot, n_vertices: int) -> CSRView:
    """Exact live adjacency at snapshot.tau as one dense CSR."""
    src, dst, ts, marker, prop = _collect_sorted(snapshot)
    # Order-preserving filters on the sorted records; each compaction is
    # one read of its size to the host.
    vis = (ts <= snapshot.tau) & (src != INVALID_VID)
    idx = torch.nonzero(vis).squeeze(1)
    src, dst, marker, prop = (a[idx] for a in (src, dst, marker, prop))
    last = torch.ones(src.shape[0], dtype=torch.bool, device=src.device)
    if src.shape[0]:
        last[:-1] = (src[:-1] != src[1:]) | (dst[:-1] != dst[1:])
    idx = torch.nonzero(last & ~marker).squeeze(1)
    src, dst, prop = src[idx], dst[idx], prop[idx]
    voff = torch.searchsorted(
        src, torch.arange(n_vertices + 1, dtype=_I32, device=src.device),
        out_int32=True)
    n_edges = int(src.shape[0])
    snapshot._store.io.analytics_read += n_edges * (
        BYTES_PER_EDGE + BYTES_PER_PROP)
    return CSRView(voff=voff, dst=dst, prop=prop, n_vertices=n_vertices,
                   n_edges=n_edges)


class RunView(NamedTuple):
    """One visible run as (src-sorted) raw edges with ± annihilation
    weights."""

    src: torch.Tensor   # int32[n]
    dst: torch.Tensor   # int32[n]
    wt: torch.Tensor    # float32[n]: +prop/+1 insert, -prop/-1 tombstone,
    #                     0 invisible


class RunViews(list):
    """``multilevel_views``' result: a list of ``RunView`` that also holds
    the snapshot's device, so that a snapshot with no visible run still
    says where its aggregates live."""

    def __init__(self, views=(), *, device: torch.device) -> None:
        super().__init__(views)
        self.device = device


def multilevel_views(snapshot: Snapshot, *, weighted: bool = False
                     ) -> RunViews:
    """Per-run views for merge-free linear aggregation.

    Precondition: per (src, dst) key the record history alternates
    insert/delete, so the sum of ± weights telescopes to live membership.
    """
    out = RunViews(device=snapshot.device)
    for (src, dst, ts, marker, prop, fid) in snapshot.run_record_tensors():
        vis = ts <= snapshot.tau
        n_vis = int(vis.sum())
        if n_vis == 0:
            # A run with nothing visible at τ adds only zero weights.
            continue
        base = (prop.float() if weighted
                else torch.ones(src.shape[0], dtype=torch.float32,
                                device=src.device))
        wt = torch.where(marker, -base, base) * vis
        # CSR runs (fid set) arrive src-sorted; MemGraph tiers are sorted
        # by src for the kernel's sorted-segment reduction.
        if fid is None:
            order = torch.argsort(src, stable=True)
            src, dst, wt = src[order], dst[order], wt[order]
        out.append(RunView(src=src.to(_I32), dst=dst.to(_I32),
                           wt=wt.float()))
        snapshot._store.io.analytics_read += n_vis * BYTES_PER_EDGE
    return out
