"""LLAMA-style baseline: a time series of immutable CSR delta snapshots.

Batched ingestion is cheap (build a delta CSR per epoch), but reads must
visit EVERY snapshot that may hold edges of the queried vertex — read
performance degrades as snapshots accumulate (the paper's §1 critique and
Fig 12 behaviour).  No compaction, no tombstone GC.
"""
from __future__ import annotations

from typing import List

import numpy as np

from .common import BLOCK_BYTES, IO, REC_BYTES, dedup_last, to_csr


class _Snap:
    def __init__(self, src, dst, ts, marker, prop):
        order = np.lexsort((ts, dst, src))
        self.src, self.dst = src[order], dst[order]
        self.ts, self.marker = ts[order], marker[order]
        self.prop = prop[order]

    @property
    def ne(self):
        return len(self.src)


class LlamaSnapshots:
    def __init__(self, n_vertices: int, epoch_edges: int = 1 << 14):
        self.n_vertices = n_vertices
        self.epoch_edges = epoch_edges
        self.buf: List[np.ndarray] = []
        self.buf_n = 0
        self.snaps: List[_Snap] = []
        self.io = IO()
        self._ts = 0

    def _edit(self, src, dst, prop, delete: bool):
        src = np.asarray(src, np.int64).ravel()
        dst = np.asarray(dst, np.int64).ravel()
        prop = (np.zeros(len(src), np.float32) if prop is None
                else np.asarray(prop, np.float32).ravel())
        ts = np.arange(self._ts, self._ts + len(src), dtype=np.int64)
        self._ts += len(src)
        marker = np.full(len(src), delete)
        self.buf.append(np.stack([src, dst, ts, marker.astype(np.int64),
                                  prop.astype(np.float64)], 1))
        self.buf_n += len(src)
        if self.buf_n >= self.epoch_edges:
            self._emit()

    def insert_edges(self, src, dst, prop=None):
        self._edit(src, dst, prop, delete=False)

    def delete_edges(self, src, dst):
        self._edit(src, dst, None, delete=True)

    def _emit(self):
        if not self.buf:
            return
        a = np.concatenate(self.buf, 0)
        self.buf, self.buf_n = [], 0
        snap = _Snap(a[:, 0].astype(np.int64), a[:, 1].astype(np.int64),
                     a[:, 2].astype(np.int64), a[:, 3].astype(bool),
                     a[:, 4].astype(np.float32))
        self.snaps.append(snap)
        self.io.write += snap.ne * REC_BYTES

    def neighbors(self, v: int) -> np.ndarray:
        self._emit()
        recs = []
        for snap in self.snaps:
            lo = np.searchsorted(snap.src, v, "left")
            hi = np.searchsorted(snap.src, v, "right")
            # Random I/O per snapshot touched — LLAMA's read amplification.
            self.io.read += BLOCK_BYTES * max(
                1, int(np.ceil(max(hi - lo, 1) * REC_BYTES / BLOCK_BYTES)))
            for i in range(lo, hi):
                recs.append((int(snap.dst[i]), int(snap.ts[i]),
                             bool(snap.marker[i])))
        if not recs:
            return np.zeros(0, np.int64)
        arr = np.array(recs, np.int64)
        order = np.lexsort((arr[:, 1], arr[:, 0]))
        arr = arr[order]
        last = np.ones(len(arr), bool)
        last[:-1] = arr[:-1, 0] != arr[1:, 0]
        return arr[last & (arr[:, 2] == 0), 0]

    def snapshot_csr(self, charge_read: bool = True):
        self._emit()
        if not self.snaps:
            z = np.zeros(0, np.int64)
            return to_csr(z, z, np.zeros(0, np.float32), self.n_vertices)
        src = np.concatenate([s.src for s in self.snaps])
        if charge_read:
            self.io.read += len(src) * REC_BYTES  # reads every delta
        s, d, p = dedup_last(
            src,
            np.concatenate([s.dst for s in self.snaps]),
            np.concatenate([s.ts for s in self.snaps]),
            np.concatenate([s.marker for s in self.snaps]),
            np.concatenate([s.prop for s in self.snaps]))
        return to_csr(s, d, p, self.n_vertices)

    def disk_bytes(self) -> int:
        return sum(s.ne for s in self.snaps) * REC_BYTES
