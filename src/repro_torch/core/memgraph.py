"""MemGraph — the graph-aware write cache (paper §4.1).

The port of ``repro.core.memgraph``: an open-addressing hashmap (vertex id
-> row) over a pool of fixed-size segments (one per low-degree vertex) plus
an overflow tier for edges beyond the segment size, sorted on flush/scan.

Every update is functional — it returns new tensors and never writes into
the ones it was given — because published store states and snapshots keep
pointing at the old tier.  Out-of-range indices are masked before every
scatter and clamped before every gather, where the JAX package relies on
XLA's drop/clamp semantics.  Row allocation matches the reference slot for
slot: the hashmap claim rounds are the same rounds
(``kernels/hash_claim.py``: one kernel launch on the card, a host loop on
the CPU).
"""
from __future__ import annotations

from contextlib import nullcontext
from typing import Tuple

import torch

from .. import obs
from ..kernels import hash_claim as _claim
from .csr import lexsort_edges, stable_partition
from .types import INVALID_VID, EdgeBatch, MemGraphState, StoreConfig, scalar

_I32 = torch.int32


def empty_memgraph(cfg: StoreConfig, device) -> MemGraphState:
    ns, g, h, oc = cfg.n_segments, cfg.seg_size, cfg.hash_slots, cfg.ovf_cap

    def z(*shape, dtype=_I32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return MemGraphState(
        htab_key=torch.full((h,), INVALID_VID, dtype=_I32, device=device),
        htab_row=z(h),
        seg_owner=torch.full((ns,), INVALID_VID, dtype=_I32, device=device),
        seg_len=z(ns),
        seg_dst=z(ns, g), seg_ts=z(ns, g),
        seg_marker=z(ns, g, dtype=torch.bool),
        seg_prop=z(ns, g, dtype=torch.float32),
        ovf_src=z(oc), ovf_dst=z(oc), ovf_ts=z(oc),
        ovf_marker=z(oc, dtype=torch.bool),
        ovf_prop=z(oc, dtype=torch.float32),
        n_rows=scalar(0, device), ovf_n=scalar(0, device),
        ne=scalar(0, device))


def step_span(mode: str, name: str, **labels):
    """``obs.REGISTRY.span(name, **labels)`` for a step of an insert on the
    paper's MemGraph path; nothing on the ablation paths (``mode`` other
    than "memgraph"), whose steps are not timed."""
    if mode != "memgraph":
        return nullcontext()
    return obs.REGISTRY.span(name, **labels)


def lookup_rows(mg: MemGraphState, keys: torch.Tensor) -> torch.Tensor:
    """Pure lookup: row per key, -1 if absent."""
    hcap = mg.hcap
    base = _claim.hash_slots(keys, hcap)
    row = torch.full(keys.shape, -1, dtype=_I32, device=keys.device)
    resolved = keys == INVALID_VID
    for r in range(_claim.MAX_PROBE_ROUNDS):
        if bool(resolved.all()):
            break
        pos = (base + r) % hcap
        k = mg.htab_key[pos]
        hit = ~resolved & (k == keys)
        row = torch.where(hit, mg.htab_row[pos], row)
        resolved = resolved | hit | (k == INVALID_VID)
    return row


def _scatter(dst: torch.Tensor, idx: torch.Tensor, src: torch.Tensor,
             mask: torch.Tensor) -> torch.Tensor:
    """``dst.at[where(mask, idx, OOB)].set(src, mode="drop")`` on a copy."""
    out = dst.clone()
    out[idx[mask]] = src[mask]
    return out


def insert_batch(mg: MemGraphState, batch: EdgeBatch, *,
                 mode: str = "memgraph") -> Tuple[MemGraphState, torch.Tensor]:
    """Insert a batch of edge updates.  Returns (new_state, ok_flag).

    mode: "memgraph" (paper design), "array_only" / "skiplist_only"
    (Fig. 15 ablation variants)."""
    new, ok, _rounds = insert_batch_counted(mg, batch, mode=mode)
    return new, ok


def insert_batch_counted(mg: MemGraphState, batch: EdgeBatch, *,
                         mode: str = "memgraph"):
    """``insert_batch`` that also returns the hashmap's claim rounds:
    ``(new_state, ok_flag, rounds)``, ``rounds`` a 0-d int32 tensor on the
    batch's device (0 on the "skiplist_only" path, which claims no row).
    On the card the claim step reads nothing to the host."""
    bc = batch.src.shape[0]
    g = mg.segsize
    dev = batch.src.device
    pos = torch.arange(bc, dtype=_I32, device=dev)
    valid = pos < batch.n
    srcv = torch.where(valid, batch.src, INVALID_VID).to(_I32)

    if mode == "skiplist_only":
        # Everything goes to the overflow ("skip list") tier.
        opos = (mg.ovf_n + torch.cumsum(valid.to(_I32), 0) - 1).long()
        ok_w = valid & (opos < mg.ovf_cap)
        new = mg._replace(
            ovf_src=_scatter(mg.ovf_src, opos, batch.src, ok_w),
            ovf_dst=_scatter(mg.ovf_dst, opos, batch.dst, ok_w),
            ovf_ts=_scatter(mg.ovf_ts, opos, batch.ts, ok_w),
            ovf_marker=_scatter(mg.ovf_marker, opos, batch.marker, ok_w),
            ovf_prop=_scatter(mg.ovf_prop, opos, batch.prop, ok_w),
            ovf_n=(mg.ovf_n + batch.n).to(_I32),
            ne=(mg.ne + batch.n).to(_I32))
        return (new, (mg.ovf_n + batch.n) <= mg.ovf_cap,
                torch.zeros((), dtype=_I32, device=dev))

    with step_span(mode, "store_apply_claim"):
        (ukeys, inv, htab_key, htab_row, n_rows, urow, is_new, hash_ok,
         rounds) = _claim.claim_rows(mg.htab_key, mg.htab_row, mg.n_rows,
                                     srcv)
    with step_span(mode, "store_apply_place"):
        seg_owner = _scatter(mg.seg_owner, urow.long(), ukeys,
                             is_new & (urow < mg.nseg))

        row_e = torch.where(valid, urow[inv], -1)

        # Arrival-order rank of each edge within its row (stable by
        # position).
        row_key = torch.where(valid, row_e, INVALID_VID)
        order = torch.argsort(row_key, stable=True)
        row_sorted = row_key[order]
        first_idx = torch.searchsorted(row_sorted, row_sorted)
        rank_sorted = (torch.arange(bc, device=dev) - first_idx).to(_I32)
        rank = torch.empty(bc, dtype=_I32, device=dev)
        rank[order] = rank_sorted

        row_c = row_e.clamp(0, mg.nseg - 1).long()
        base_len = torch.where(valid, mg.seg_len[row_c], 0)
        slot = base_len + rank
        in_seg = valid & (slot < g)
        # "array_only" (paper ablation: adjacency arrays only) shares this
        # layout; the store charges the compact-array growth movement.  A
        # row past the pool (an overflowing batch, reported by ``ok``) is
        # dropped.
        seg_w = in_seg & (row_e >= 0) & (row_e < mg.nseg)
        flat = (row_c * g + slot.clamp(max=g - 1)).long()
        seg_dst = _scatter(mg.seg_dst.reshape(-1), flat, batch.dst, seg_w)
        seg_ts = _scatter(mg.seg_ts.reshape(-1), flat, batch.ts, seg_w)
        seg_marker = _scatter(mg.seg_marker.reshape(-1), flat, batch.marker,
                              seg_w)
        seg_prop = _scatter(mg.seg_prop.reshape(-1), flat, batch.prop,
                            seg_w)

        is_ovf = valid & ~in_seg
        opos = (mg.ovf_n + torch.cumsum(is_ovf.to(_I32), 0) - 1).long()
        ok_o = is_ovf & (opos < mg.ovf_cap)
        n_ovf = is_ovf.sum().to(_I32)

        seg_len = mg.seg_len.clone()
        inc = valid & (row_e < mg.nseg) & (row_e >= 0)
        seg_len.index_add_(0, row_c[inc],
                           torch.ones_like(row_c[inc], dtype=_I32))

        new = MemGraphState(
            htab_key=htab_key, htab_row=htab_row,
            seg_owner=seg_owner, seg_len=seg_len,
            seg_dst=seg_dst.reshape(mg.seg_dst.shape),
            seg_ts=seg_ts.reshape(mg.seg_ts.shape),
            seg_marker=seg_marker.reshape(mg.seg_marker.shape),
            seg_prop=seg_prop.reshape(mg.seg_prop.shape),
            ovf_src=_scatter(mg.ovf_src, opos, batch.src, ok_o),
            ovf_dst=_scatter(mg.ovf_dst, opos, batch.dst, ok_o),
            ovf_ts=_scatter(mg.ovf_ts, opos, batch.ts, ok_o),
            ovf_marker=_scatter(mg.ovf_marker, opos, batch.marker, ok_o),
            ovf_prop=_scatter(mg.ovf_prop, opos, batch.prop, ok_o),
            n_rows=n_rows, ovf_n=(mg.ovf_n + n_ovf).to(_I32),
            ne=(mg.ne + batch.n).to(_I32))
        ok = (hash_ok & (n_rows <= mg.nseg)
              & ((mg.ovf_n + n_ovf) <= mg.ovf_cap))
    return new, ok, rounds


def flush_arrays(mg: MemGraphState):
    """Flatten MemGraph into raw (src, dst, ts, marker, prop, n) edge arrays
    of static length NS*G + Oc, ready for csr.build_run_arrays."""
    ns, g = mg.nseg, mg.segsize
    dev = mg.seg_owner.device
    owner = mg.seg_owner.repeat_interleave(g)
    slot = torch.arange(g, dtype=_I32, device=dev).repeat(ns)
    stored = mg.seg_len.clamp(max=g).repeat_interleave(g)
    seg_valid = (owner != INVALID_VID) & (slot < stored)
    ovf_valid = torch.arange(mg.ovf_cap, dtype=_I32, device=dev) < mg.ovf_n
    src = torch.cat([torch.where(seg_valid, owner, INVALID_VID),
                     torch.where(ovf_valid, mg.ovf_src, INVALID_VID)])
    dst = torch.cat([mg.seg_dst.reshape(-1), mg.ovf_dst])
    ts = torch.cat([mg.seg_ts.reshape(-1), mg.ovf_ts])
    marker = torch.cat([mg.seg_marker.reshape(-1), mg.ovf_marker])
    prop = torch.cat([mg.seg_prop.reshape(-1), mg.ovf_prop])
    nvalid = (seg_valid.sum() + mg.ovf_n).to(_I32)
    # Compact valid entries to a dense prefix (stable keeps arrival order).
    order = stable_partition(src != INVALID_VID)
    return (src[order].to(_I32), dst[order], ts[order], marker[order],
            prop[order], nvalid)


def scan_vertex(mg: MemGraphState, v: int, *, cap: int):
    """All cached edge records of vertex v (fixed-size output):
    (dst, ts, marker, prop, mask), segment records first."""
    dev = mg.seg_owner.device
    vt = torch.tensor([v], dtype=_I32, device=dev)
    row = lookup_rows(mg, vt)[0]
    g = mg.segsize
    row_c = row.clamp(0, mg.nseg - 1)
    stored = torch.where(row >= 0, mg.seg_len[row_c].clamp(max=g), 0)
    sidx = torch.arange(cap, dtype=_I32, device=dev)
    seg_m = sidx < stored
    sslot = sidx.clamp(max=g - 1)
    dst = torch.where(seg_m, mg.seg_dst[row_c, sslot], INVALID_VID).to(_I32)
    ts = torch.where(seg_m, mg.seg_ts[row_c, sslot], 0).to(_I32)
    marker = seg_m & mg.seg_marker[row_c, sslot]
    prop = torch.where(seg_m, mg.seg_prop[row_c, sslot], 0.0)

    ovf_m = (mg.ovf_src == v) & (
        torch.arange(mg.ovf_cap, device=dev) < mg.ovf_n)
    oidx = torch.nonzero(ovf_m).reshape(-1)[:cap]
    n_seg = seg_m.sum()
    # Append overflow records after the segment records.
    tgt = n_seg + torch.arange(oidx.shape[0], device=dev)
    ok = tgt < cap
    tgt, oidx = tgt[ok], oidx[ok]
    dst[tgt] = mg.ovf_dst[oidx]
    ts[tgt] = mg.ovf_ts[oidx]
    marker[tgt] = mg.ovf_marker[oidx]
    prop[tgt] = mg.ovf_prop[oidx]
    mask = sidx < n_seg + oidx.shape[0]
    return dst, ts, marker, prop, mask


def scan_vertices_batch(mg: MemGraphState, vs: torch.Tensor):
    """Batched `scan_vertex`: cached records of a whole query vector at once.

    vs: int32[B], SORTED ascending, padded with INVALID_VID.  Returns flat
    (qid, dst, ts, marker, prop) tensors of static length B*G + Oc, where
    qid[i] is the position of record i's vertex in vs, or B for slots that
    carry no queried record."""
    b = vs.shape[0]
    g = mg.segsize
    dev = vs.device
    rows = lookup_rows(mg, vs)
    row_c = rows.clamp(0, mg.nseg - 1).long()
    stored = torch.where(rows >= 0, mg.seg_len[row_c].clamp(max=g), 0)
    seg_valid = torch.arange(g, dtype=_I32, device=dev)[None, :] < \
        stored[:, None]
    qid_seg = torch.where(
        seg_valid, torch.arange(b, dtype=_I32, device=dev)[:, None], b)
    # Overflow tier: map every overflow record to its query slot (if any) by
    # binary search into the sorted query vector.
    oi = torch.searchsorted(vs, mg.ovf_src).clamp(max=b - 1)
    ohit = ((vs[oi] == mg.ovf_src) & (mg.ovf_src != INVALID_VID)
            & (torch.arange(mg.ovf_cap, device=dev) < mg.ovf_n))
    qid = torch.cat([qid_seg.reshape(-1), torch.where(ohit, oi, b)]).to(_I32)
    dst = torch.cat([mg.seg_dst[row_c].reshape(-1), mg.ovf_dst])
    ts = torch.cat([mg.seg_ts[row_c].reshape(-1), mg.ovf_ts])
    marker = torch.cat([mg.seg_marker[row_c].reshape(-1), mg.ovf_marker])
    prop = torch.cat([mg.seg_prop[row_c].reshape(-1), mg.ovf_prop])
    return qid, dst, ts, marker, prop


def backbone_stream(mg: MemGraphState):
    """One MemGraph tier as a read-spine stream (rid = -1: always visible),
    flattened and sorted into (src, dst, ts) order once."""
    src, dst, ts, marker, prop, _n = flush_arrays(mg)
    order = lexsort_edges(src, dst, ts)
    rid = torch.full(src.shape, -1, dtype=_I32, device=src.device)
    return (src[order], dst[order], ts[order], rid, marker[order],
            prop[order])


def memgraph_should_flush(mg: MemGraphState, cfg: StoreConfig) -> bool:
    """Host-side flush trigger (paper: MemGraph reaches capacity)."""
    ne, n_rows, ovf_n = torch.stack([mg.ne, mg.n_rows, mg.ovf_n]).tolist()
    return bool(
        ne >= cfg.mem_edges
        or n_rows >= cfg.n_segments - cfg.batch_cap
        or ovf_n >= cfg.ovf_cap - cfg.batch_cap
        or n_rows >= int(0.7 * cfg.hash_slots))
