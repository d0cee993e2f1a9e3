"""Multi-level index (paper §4.2.2) + vertex-grained min-readable-fid (§4.3).

The port of ``repro.core.index``'s dense variant: int32[V, L] file-id and
offset tensors — one gather per vertex per level.  Readers pin an index
reference at snapshot time, so every update returns fresh tensors and
never edits the ones a snapshot may hold.

``note_compaction_many`` folds all of one compaction commit's index calls
(one per output segment, plus the annihilated gaps) into one pass over the
index.  For the target level and L0 the result is byte-equal to the JAX
package's sequential ``note_compaction`` calls, because the commit's
vertex ranges are disjoint, later calls only clear where earlier ones did
not write, and the L0 update is a max.  The source level's column is
cleared over the compacted source range only (``src_ranges``): the
reference clears it over every output segment's range, which a partial
compaction's overlap can widen past the source segment, dropping the
entries of source-level segments that were not compacted (ROADMAP,
faults of the reference).

``CompactIndex`` is the paper's 2-slot + page-set variant (Fig. 8), a copy of
the reference's host-side numpy class: the space benchmark (Fig 14) and the
fidelity tests use it, the store does not.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from .types import BYTES_PER_INDEX_ENTRY, INVALID_VID

_I32 = torch.int32


class IndexState(NamedTuple):
    """Dense multi-level index.

    Column c of lvl_fid/lvl_off corresponds to level c+1 (L0 has no per-vertex
    offsets — its runs are probed via min/first fid, exactly the paper).
    """

    l0_first_fid: torch.Tensor   # int32[V] — first L0 file containing v
    l0_min_fid: torch.Tensor     # int32[V] — minimum *readable* L0 fid
    lvl_fid: torch.Tensor        # int32[V, L] — INVALID_VID = absent
    lvl_off: torch.Tensor        # int32[V, L]


def empty_index(vmax: int, n_levels: int, device) -> IndexState:
    return IndexState(
        l0_first_fid=torch.full((vmax,), INVALID_VID, dtype=_I32,
                                device=device),
        l0_min_fid=torch.zeros((vmax,), dtype=_I32, device=device),
        lvl_fid=torch.full((vmax, n_levels), INVALID_VID, dtype=_I32,
                           device=device),
        lvl_off=torch.zeros((vmax, n_levels), dtype=_I32, device=device))


def index_nbytes_dense(vmax: int, n_levels: int) -> int:
    """Bytes the dense index accounts for (the in-memory space proxy)."""
    return vmax * (2 + 2 * n_levels) * BYTES_PER_INDEX_ENTRY


def note_l0_flush(idx: IndexState, vkeys: torch.Tensor, nv,
                  fid: int) -> IndexState:
    """After a MemGraph flush lands at L0 with file `fid`: record the first
    L0 file per contained vertex."""
    keys = vkeys[:int(nv)].long()
    first = idx.l0_first_fid.clone()
    first[keys] = torch.minimum(first[keys],
                                torch.full_like(first[keys], int(fid)))
    return idx._replace(l0_first_fid=first)


def _in_ranges(ranges: Sequence[Tuple[int, int]], vmax: int,
               device) -> torch.Tensor:
    """bool[vmax]: v lies in one of the disjoint ranges [lo, hi)."""
    edges = torch.zeros(vmax + 1, dtype=_I32, device=device)
    if ranges:
        lo = torch.tensor([r[0] for r in ranges], device=device)
        hi = torch.tensor([r[1] for r in ranges], device=device)
        ones = torch.ones(lo.shape[0], dtype=_I32, device=device)
        edges.index_add_(0, lo.clamp(0, vmax), ones)
        edges.index_add_(0, hi.clamp(0, vmax), -ones)
    return torch.cumsum(edges, 0)[:vmax] > 0


def note_compaction_many(idx: IndexState, *, level: int,
                         writes: Sequence[Tuple[torch.Tensor, torch.Tensor,
                                                int, int]],
                         ranges: Sequence[Tuple[int, int]],
                         src_ranges: Sequence[Tuple[int, int]],
                         l0_min_fid_update: int) -> IndexState:
    """Index maintenance after compaction into `level` (paper §4.2.2/§4.3).

    ``ranges``: disjoint vertex ranges [lo, hi) the commit rewrote at
    `level`.  Vertices in them lose their target-level entry and, for an L0
    source, their L0 entries (min-readable-fid := max(old,
    ``l0_min_fid_update``), first-fid cleared).  ``src_ranges``: the
    compacted source range(s) of an L_{level-1} source, whose column is
    cleared there.  ``writes``: (vkeys, voff, nv, fid) of each output
    segment, whose vertices then gain (fid, offset) at `level`.
    ``l0_min_fid_update`` < 0 means the source is not L0."""
    vmax = idx.l0_first_fid.shape[0]
    dev = idx.l0_first_fid.device
    in_range = _in_ranges(ranges, vmax, dev)

    l0_min, l0_first = idx.l0_min_fid, idx.l0_first_fid
    if l0_min_fid_update >= 0:
        l0_min = torch.where(
            in_range, l0_min.clamp(min=int(l0_min_fid_update)), l0_min)
        l0_first = torch.where(in_range, INVALID_VID, l0_first).to(_I32)

    lvl_fid, lvl_off = idx.lvl_fid.clone(), idx.lvl_off.clone()
    if level >= 2:
        in_src = _in_ranges(src_ranges, vmax, dev)
        lvl_fid[:, level - 2] = torch.where(in_src, INVALID_VID,
                                            lvl_fid[:, level - 2])
    lvl_fid[:, level - 1] = torch.where(in_range, INVALID_VID,
                                        lvl_fid[:, level - 1])
    keys = [vk[:int(nv)].long() for vk, _vo, nv, _f in writes]
    if keys:
        k = torch.cat(keys)
        lvl_fid[k, level - 1] = torch.cat(
            [torch.full((kk.shape[0],), int(f), dtype=_I32, device=dev)
             for kk, (_vk, _vo, _nv, f) in zip(keys, writes)])
        lvl_off[k, level - 1] = torch.cat(
            [vo[:int(nv)] for _vk, vo, nv, _f in writes]).to(_I32)
    return IndexState(l0_first_fid=l0_first, l0_min_fid=l0_min,
                      lvl_fid=lvl_fid, lvl_off=lvl_off)


def note_compaction(idx: IndexState, *, level: int, new_vkeys, new_voff,
                    new_nv, new_fid: int, range_lo: int, range_hi: int,
                    l0_min_fid_update: int) -> IndexState:
    """One segment's index update — the JAX package's call (and result):
    the source column, the target column and L0 are all cleared over
    [range_lo, range_hi)."""
    rng = [(range_lo, range_hi)]
    return note_compaction_many(
        idx, level=level, writes=[(new_vkeys, new_voff, new_nv, new_fid)],
        ranges=rng, src_ranges=rng, l0_min_fid_update=l0_min_fid_update)


def lookup(idx: IndexState, v: int):
    """Positions of vertex v's edges on every level: O(1) each."""
    return (idx.l0_first_fid[v], idx.l0_min_fid[v],
            idx.lvl_fid[v], idx.lvl_off[v])


def lookup_batch(idx: IndexState, vs: torch.Tensor):
    """Multi-level index positions for a whole query vector in 4 gathers:
    (l0_first[B], l0_min[B], lvl_fid[B, L], lvl_off[B, L]).  Pad queries
    (INVALID_VID) clamp to the LAST row; callers mask pad slots by qid."""
    v_c = vs.clamp(max=idx.l0_first_fid.shape[0] - 1).long()
    return (idx.l0_first_fid[v_c], idx.l0_min_fid[v_c],
            idx.lvl_fid[v_c], idx.lvl_off[v_c])



# ---------------------------------------------------------------------------
# Compact 2-slot + page-set variant (paper Fig. 8) — host-side, numpy.
# ---------------------------------------------------------------------------

_PAGE_BYTES = 4096
_ENTRY_BYTES = 12  # (level:2, fid:4, off:4) padded


class CompactIndex:
    """The paper's compressed index: per-vertex array rows hold the L0 first
    fid + up to two inline (level, fid, off) positions; extra positions spill
    into 4 KB pages allocated per contiguous vertex interval (split-in-half on
    overflow, merge-on-shrink)."""

    def __init__(self, vmax: int, interval: int = 1024):
        self.vmax = vmax
        self.interval = interval
        self.l0_first = np.full(vmax, INVALID_VID, np.int64)
        self.l0_min = np.zeros(vmax, np.int64)
        self.slots: List[Dict[int, Tuple[int, int]]] = [
            dict() for _ in range(vmax)]
        # page directory: vertex interval -> page id;
        # pages: id -> {v: {lvl: (fid, off)}}
        self._pages: Dict[int, Dict[int, Dict[int, Tuple[int, int]]]] = {}
        self._page_of: Dict[int, int] = {}
        self._next_page = 0

    # -- write path ---------------------------------------------------------
    def set_position(self, v: int, level: int, fid: int, off: int) -> None:
        row = self.slots[v]
        if level in row or len(row) < 2:
            row[level] = (fid, off)
            return
        # Spill the largest-level inline entry to the page set (bottom levels
        # hold 99 % of edges — keep hot low levels inline, paper intuition).
        pid = self._page_for(v)
        spill_lvl = max(row)
        if level < spill_lvl:
            self._pages[pid].setdefault(v, {})[spill_lvl] = row.pop(spill_lvl)
            row[level] = (fid, off)
        else:
            self._pages[pid].setdefault(v, {})[level] = (fid, off)
        self._maybe_split(pid)

    def clear_position(self, v: int, level: int) -> None:
        self.slots[v].pop(level, None)
        pid = self._page_of.get(v // self.interval)
        if pid is not None:
            entry = self._pages[pid].get(v)
            if entry:
                entry.pop(level, None)

    # -- read path ----------------------------------------------------------
    def get_positions(self, v: int) -> Dict[int, Tuple[int, int]]:
        out = dict(self.slots[v])
        pid = self._page_of.get(v // self.interval)
        if pid is not None:
            out.update(self._pages[pid].get(v, {}))
        return out

    # -- pages ---------------------------------------------------------------
    def _page_for(self, v: int) -> int:
        key = v // self.interval
        if key not in self._page_of:
            self._page_of[key] = self._next_page
            self._pages[self._next_page] = {}
            self._next_page += 1
        return self._page_of[key]

    def _maybe_split(self, pid: int) -> None:
        # 4 KB page capacity in entries; split vertex intervals on overflow
        # (the paper splits the one interval in half; this halves the global
        # interval and rehashes — an upper bound on page count, same
        # asymptotics).
        n_entries = sum(len(m) for m in self._pages[pid].values())
        if n_entries * _ENTRY_BYTES <= _PAGE_BYTES or self.interval <= 1:
            return
        self.interval //= 2
        old_pages = self._pages
        self._pages, self._page_of, self._next_page = {}, {}, 0
        for page in old_pages.values():
            for v, entry in page.items():
                npid = self._page_for(v)
                self._pages[npid][v] = entry

    def nbytes(self) -> int:
        inline = self.vmax * (8 + 2 * _ENTRY_BYTES + 8)
        return inline + len(self._pages) * _PAGE_BYTES
