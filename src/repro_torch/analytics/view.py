"""Analytics views over a pinned LSMGraph snapshot (port of
``repro.analytics.view``).

Two read strategies:

  * ``materialize_csr`` — the exact merged live CSR at τ.  One merge of
    the snapshot's sources; every iteration of every algorithm then runs
    at CSR speed.
  * ``multilevel_views`` — merge-free per-run views with ± tombstone
    weights, consumed by ``multilevel.py``.

Everything stays on the store's device: the runs' records are read there,
merged or sorted there and returned as tensors.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import obs
from ..core import memgraph as mg_mod
from ..core.store import Snapshot, prefetch_pool
from ..core.types import BYTES_PER_EDGE, BYTES_PER_PROP, INVALID_VID
from ..kernels import ops as kops
from ..kernels.merge import to_device

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


def _lay_out(tiers, runs):
    """The MemGraph tiers' streams, then every run of ``runs`` at full
    capacity, pads included, end to end in one buffer a column (src, dst,
    ts, marker, prop), and each source's capacity.

    The runs go as the read spine lays them (``store._spine_run_streams``)
    without its run ids, and with no tensor op a run, since a host loop
    over a deep store's ~2,000 runs costs more than their merge.  Each
    run's edge count is the host's (``RunFile.ne``), and the runs' whole
    ``voff`` arrays are laid end to end, each one's leading 0 included:
    shifted to the run's first slot they stay sorted, so one
    ``searchsorted`` of the global slot finds each slot's vertex, one
    entry further on for each run up to and including its own.  Cold runs
    are all put on the prefetch pool first, and the host never waits on
    the card."""
    # Column 3 of a tier's stream is the read spine's run id.
    parts = [[t[i] for t in tiers] for i in (0, 1, 2, 4, 5)]
    caps = [int(t[0].shape[0]) for t in tiers]
    if runs:
        pool = None
        for rf in runs:
            if rf.arrays is None:
                pool = pool or prefetch_pool()
                rf.prefetch(pool)
        arrays = [rf.ensure_loaded() for rf in runs]
        dev = parts[0][0].device
        # numel() is the cheapest of a tensor's size reads on the host.
        ecap = np.array([a.dst.numel() for a in arrays], np.int64)
        vcap = np.array([a.vkeys.numel() for a in arrays], np.int64)
        eoff = sum(caps) + np.cumsum(ecap) - ecap
        n_e, n_v, r = int(ecap.sum()), int(vcap.sum()), len(runs)
        tab = to_device(np.concatenate([
            ecap, vcap + 1, eoff, eoff + [rf.ne for rf in runs]]), dev)
        ecap_t, vlen_t, eoff_t, end_t = tab.split(r)
        run = torch.repeat_interleave(torch.arange(r, device=dev), ecap_t,
                                      output_size=n_e)
        slot = torch.arange(int(eoff[0]), int(eoff[0]) + n_e, device=dev)
        ends = torch.cat([a.voff for a in arrays]).long() + \
            torch.repeat_interleave(eoff_t, vlen_t, output_size=n_v + r)
        # A pad slot may land on the next run's first vertex, or past the
        # last run's: its vertex is masked below.
        j = (torch.searchsorted(ends, slot, right=True) - run - 1).clamp(
            max=n_v - 1)
        parts[0].append(torch.where(
            slot < end_t[run], torch.cat([a.vkeys for a in arrays])[j],
            INVALID_VID).to(_I32))
        for part, f in zip(parts[1:], ("dst", "ts", "marker", "prop")):
            part.extend(getattr(a, f) for a in arrays)
        caps += ecap.tolist()
    return tuple(torch.cat(p) for p in parts), caps


def _laid_out_sources(snapshot: Snapshot):
    """Every source of the snapshot laid end to end (``_lay_out``): the
    MemGraph tiers, each sorted once at its full capacity
    (``memgraph.backbone_stream``), then every sealed run with a vertex
    (degraded runs are already left out of the snapshot's runs).  Every
    source is (src, dst, ts)-ordered and its pads carry src ==
    INVALID_VID."""
    return _lay_out(
        [mg_mod.backbone_stream(mg) for mg in snapshot.mem_states],
        [rf for rf in snapshot.l0_runs + [
            r for lvl in snapshot.level_runs for r in lvl] if rf.nv > 0])


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
