"""Analytics views over a pinned LSMGraph snapshot (port of
``repro.analytics.view``).

Two read strategies:

  * ``materialize_csr`` — the exact merged live CSR at τ.  One sort of the
    snapshot's visible records; every iteration of every algorithm then runs
    at CSR speed.
  * ``multilevel_views`` — merge-free per-run views with ± tombstone
    weights, consumed by ``multilevel.py``.

Everything stays on the store's device: the runs' records are read there
(``Snapshot.run_record_tensors``), sorted there and returned as tensors.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.csr import lexsort_edges, quantize_cap
from ..core.store import Snapshot
from ..core.types import BYTES_PER_EDGE, BYTES_PER_PROP
from ..kernels import ops as kops
from ..kernels.merge import MERGE_STATS

_I32 = torch.int32
_I32MAX = (1 << 31) - 1


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


# Most sources merged on the device by _collect_sorted's tournament; deeper
# snapshots sort the concatenation instead.  MERGE_STATS counts which branch
# ran, under the reference's keys.
TOURNAMENT_MAX_SOURCES = 8


def _merge_sources_tournament(sources):
    """Merge k (src, dst, ts)-sorted record tuples with the log-k pairwise
    merge tournament (``kernels.merge``).  Sources pad to quantized
    capacities with all-MAX keys, which sort to the merged tail and are
    sliced off."""
    streams = []
    for rec in sources:
        n = rec[0].shape[0]
        cap = quantize_cap(n)
        cols = []
        for j, col in enumerate(rec):
            pad = torch.full((cap - n,), _I32MAX if j < 3 else 0,
                             dtype=col.dtype, device=col.device)
            cols.append(torch.cat([col, pad]))
        streams.append(tuple(cols))
    merged = kops.tournament_merge(streams)
    total = sum(rec[0].shape[0] for rec in sources)
    return tuple(c[:total] for c in merged)


def _collect_sorted(snapshot: Snapshot):
    """All visible records, (src, dst, ts)-lexsorted, on the store's device.

    CSR runs arrive sorted (fid is not None); MemGraph tiers arrive in
    arrival order and are sorted one by one.  2..TOURNAMENT_MAX_SOURCES
    sources merge through the tournament; more are concatenated and sorted
    with ``lexsort_edges`` (the reference does that one sort with a host
    ``np.lexsort``; every (src, dst, ts) key is distinct, so both orders are
    the same).  Sources with no record visible at τ are skipped."""
    tau = snapshot.tau
    sources = []
    for (src, dst, ts, marker, prop, fid) in snapshot.run_record_tensors():
        if src.shape[0] == 0 or not bool((ts <= tau).any()):
            continue
        rec = (src.to(_I32), dst.to(_I32), ts.to(_I32), marker.bool(),
               prop.float())
        if fid is None:  # MemGraph tier: arrival order
            order = lexsort_edges(*rec[:3])
            rec = tuple(c[order] for c in rec)
        sources.append(rec)
    if not sources:
        z = torch.zeros(0, dtype=_I32, device=snapshot.device)
        return (z, z, z, torch.zeros(0, dtype=torch.bool, device=z.device),
                torch.zeros(0, dtype=torch.float32, device=z.device))
    if len(sources) == 1:
        return sources[0]
    if len(sources) <= TOURNAMENT_MAX_SOURCES:
        MERGE_STATS.bump("kernel_merge")
        return _merge_sources_tournament(sources)
    MERGE_STATS.bump("host_lexsort")
    cat = tuple(torch.cat([s[i] for s in sources]) for i in range(5))
    order = lexsort_edges(*cat[:3])
    return tuple(c[order] for c in cat)


def materialize_csr(snapshot: Snapshot, n_vertices: int) -> CSRView:
    """Exact live adjacency at snapshot.tau as one dense CSR."""
    src, dst, ts, marker, prop = _collect_sorted(snapshot)
    vis = ts <= snapshot.tau  # order-preserving filter on sorted records
    src, dst, marker, prop = (a[vis] for a in (src, dst, marker, prop))
    last = torch.ones(src.shape[0], dtype=torch.bool, device=src.device)
    if src.shape[0]:
        last[:-1] = (src[:-1] != src[1:]) | (dst[:-1] != dst[1:])
    live = last & ~marker
    src, dst, prop = src[live], dst[live], prop[live]
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
