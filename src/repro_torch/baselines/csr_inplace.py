"""Pure-CSR baseline (Table 1 'CSR' row; LiveGraph-like in-place updates).

Reads are optimal (one compact CSR).  Every update batch must restore
compactness, moving O(|E|) bytes — the write amplification the paper's LSM
levels exist to avoid.
"""
from __future__ import annotations

import numpy as np

from .common import IO, REC_BYTES, dedup_last, to_csr


class CSRInplace:
    def __init__(self, n_vertices: int):
        self.n_vertices = n_vertices
        self.src = np.zeros(0, np.int64)
        self.dst = np.zeros(0, np.int64)
        self.prop = np.zeros(0, np.float32)
        self.io = IO()
        self._ts = 0

    def _edit(self, src, dst, prop, delete: bool):
        src = np.asarray(src, np.int64)
        dst = np.asarray(dst, np.int64)
        prop = (np.zeros(len(src), np.float32) if prop is None
                else np.asarray(prop, np.float32))
        n_old = len(self.src)
        all_src = np.concatenate([self.src, src])
        all_dst = np.concatenate([self.dst, dst])
        all_prop = np.concatenate([self.prop, prop])
        ts = np.arange(n_old + len(src))
        marker = np.zeros(n_old + len(src), bool)
        marker[n_old:] = delete
        self.src, self.dst, self.prop = dedup_last(
            all_src, all_dst, ts, marker, all_prop)
        # In-place compact maintenance: the whole edge+offset region moves.
        self.io.write += (n_old + len(src)) * REC_BYTES
        self.io.read += n_old * REC_BYTES
        self._ts += len(src)

    def insert_edges(self, src, dst, prop=None):
        self._edit(src, dst, prop, delete=False)

    def delete_edges(self, src, dst):
        self._edit(src, dst, None, delete=True)

    def neighbors(self, v: int) -> np.ndarray:
        lo = np.searchsorted(self.src, v, side="left")
        hi = np.searchsorted(self.src, v, side="right")
        self.io.read += max(1, hi - lo) * REC_BYTES
        return self.dst[lo:hi]

    def snapshot_csr(self, charge_read: bool = True):
        if charge_read:
            self.io.read += len(self.src) * REC_BYTES
        return to_csr(self.src, self.dst, self.prop, self.n_vertices)

    def disk_bytes(self) -> int:
        return len(self.src) * REC_BYTES
